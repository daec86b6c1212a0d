"""Plane 1 of the performance-observability layer: deterministic, sim-time
critical-path latency attribution ("where do the 23 ms per commit go").

The flight recorder already captures, per transaction, the client
submit/resolve envelope, the per-(node, store) ``SaveStatus`` transition
timeline, and (optionally) the full message event stream.  This module
reconstructs each committed txn's causal chain from those records —

    submit → PreAccept fan-out → quorum gather → decision → stable
    propagation → deps/execute wait → apply → ack —

and attributes every segment of the chain to one of a SMALL CLOSED class
set, then aggregates the per-txn budgets into a latency-budget report
(per-class totals/shares and exact p50/p95/p99, top-k classes by total
contribution).  The report is what ROADMAP item 2's columnar protocol-batch
refactor batches against: it names WHICH segment of a commit's life
dominates, instead of inferring it from end-to-end deltas.

Everything here is POST-HOC analysis over the recorder's already-captured
sim-time data: extraction runs after the burn, touches no RNG, no wall
clock, no scheduling — the zero-observer-effect contract is untouched by
construction (there are no runtime hooks at all).

Time plane: ALL durations in this module are simulated microseconds.  The
wall-clock plane (handler CPU, scheduler occupancy, device launch RTT) is
``observe/profiler.py`` — explicitly outside the determinism contract.

Class semantics (``SEGMENT_CLASSES``):

- ``message_wait``      network legs on the critical chain: fan-out,
                        quorum gather, decision/stable propagation, the
                        final apply-ack back to the client.
- ``replica_queue_wait``delivery → handler-run delay at a replica (store
                        executor queueing, request-coalescing windows,
                        pause parks).  Measured from the PreAccept RECV
                        event when the message timeline is recorded;
                        folded into the fan-out leg otherwise.
- ``handler_compute``   replica-side state-machine work (APPLYING→APPLIED
                        and zero-width handler segments).  Sim handlers
                        execute in zero sim time except for injected
                        executor delay, so this class is structurally tiny
                        in plane 1 — the WALL plane measures it honestly.
- ``device_consult_wait`` sim-time waits attributable to the device consult
                        tier (delivery-window batching).  Plane 1 cannot
                        separate this from replica queueing without a
                        per-message consult ledger, so it stays 0 here and
                        the wall plane reports dispatch RTT / kernel ms;
                        the class is declared so budgets from both planes
                        share one vocabulary.
- ``fence_bootstrap_wait`` stable→execute gaps on a store whose timeline
                        shows the txn landed via bootstrap/fetch paths
                        (first observation already decided: the store
                        never pre-accepted it).
- ``deps_wait``         stable→execute-ready on the critical (slowest
                        normally-participating) store: waiting for
                        dependency transactions to apply.
- ``recovery``          decision-phase and probe-resolution segments of
                        txns with recovery attempts attributed (or
                        resolved through client CheckStatus probes).
- ``unattributed``      residue the chain could not name (e.g. spans with
                        no replica transitions at all).  The acceptance bar
                        is ≥95% of mean commit latency attributed to the
                        NAMED classes above.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import schema

SEGMENT_CLASSES = ("message_wait", "replica_queue_wait", "handler_compute",
                   "device_consult_wait", "fence_bootstrap_wait", "deps_wait",
                   "recovery", "unattributed")

# span outcomes that count as a COMMIT for the latency budget (invalidated /
# lost / failed ops have no commit latency to attribute)
_COMMIT_OUTCOMES = schema.COMMIT_OUTCOMES

# SaveStatus names marking "the decision is known at this store"
_DECIDED = ("PRE_COMMITTED", "COMMITTED", "STABLE", "READY_TO_EXECUTE",
            "PRE_APPLIED", "APPLYING", "APPLIED")
_STABLE_PLUS = ("STABLE", "READY_TO_EXECUTE", "PRE_APPLIED", "APPLYING",
                "APPLIED")
_EXEC_READY = ("READY_TO_EXECUTE", "PRE_APPLIED", "APPLYING", "APPLIED")


class Segment:
    """One labeled span of a txn's critical chain."""
    __slots__ = ("phase", "cls", "start_us", "dur_us")

    def __init__(self, phase: str, cls: str, start_us: int, dur_us: int):
        assert cls in SEGMENT_CLASSES, cls
        self.phase = phase
        self.cls = cls
        self.start_us = start_us
        self.dur_us = dur_us

    def to_dict(self) -> dict:
        return {"phase": self.phase, "class": self.cls,
                "start_us": self.start_us, "dur_us": self.dur_us}


class TxnCriticalPath:
    """The reconstructed chain of one committed client txn; segment
    durations partition [submitted_us, resolved_us] exactly."""
    __slots__ = ("txn_id", "outcome", "total_us", "segments")

    def __init__(self, txn_id, outcome: str, total_us: int,
                 segments: List[Segment]):
        self.txn_id = txn_id
        self.outcome = outcome
        self.total_us = total_us
        self.segments = segments

    def by_class(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for seg in self.segments:
            out[seg.cls] = out.get(seg.cls, 0) + seg.dur_us
        return out

    def to_dict(self) -> dict:
        return {"txn_id": str(self.txn_id), "outcome": self.outcome,
                "total_us": self.total_us,
                "segments": [s.to_dict() for s in self.segments]}


def _preaccept_recv_index(recorder) -> Dict[str, int]:
    """txn-id string -> earliest sim-us a PreAccept REQUEST was delivered
    (RECV) anywhere.  Needs the recorder's message timeline; {} when
    messages were not recorded (or the ring dropped them) — extraction then
    folds replica queueing into the fan-out leg."""
    out: Dict[str, int] = {}
    for _seq, ts, event, _frm, _to, _msg_id, brief in recorder.messages:
        if event == "RECV" and brief.startswith("PreAccept("):
            tid = brief[len("PreAccept("):-1]
            if tid not in out:
                out[tid] = ts
    return out


def _first(transitions: List[Tuple[str, int]], names) -> Optional[int]:
    for status, ts in transitions:
        if status in names:
            return ts
    return None


def extract_txn_path(span, preaccept_recv_us: Optional[int] = None) \
        -> Optional[TxnCriticalPath]:
    """Reconstruct one client span's critical chain.  Returns None for spans
    that are not resolved commits (nothing to attribute)."""
    if not span.is_client_op or span.resolved_us is None \
            or span.outcome not in _COMMIT_OUTCOMES:
        return None
    t_submit, t_resolve = span.submitted_us, span.resolved_us
    total = t_resolve - t_submit

    # -- milestone extraction over the per-(node,store) timelines ------------
    preaccept_ts = []          # first PRE_ACCEPTED per participating store
    decided_ts = []            # first decided status per store
    stable_ts = []             # first STABLE+ per store
    apply_chains = []          # (first_applied, exec_ready, stable, bootstrap)
    for (_node, _store), transitions in span.transitions.items():
        pa = _first(transitions, ("PRE_ACCEPTED",))
        if pa is not None:
            preaccept_ts.append(pa)
        dec = _first(transitions, _DECIDED)
        if dec is not None:
            decided_ts.append(dec)
        st = _first(transitions, _STABLE_PLUS)
        if st is not None:
            stable_ts.append(st)
        applied = _first(transitions, ("APPLIED",))
        if applied is not None:
            # a store that never pre-accepted learned the txn already
            # decided (bootstrap / fetch / propagate): its execute wait is
            # fence/bootstrap-class, not deps-class
            apply_chains.append((applied, _first(transitions, _EXEC_READY),
                                 st, pa is None,
                                 _first(transitions, ("PRE_APPLIED",)),
                                 _first(transitions, ("READY_TO_EXECUTE",
                                                      "APPLYING"))))
    if not preaccept_ts and not apply_chains:
        # no replica evidence at all (e.g. probe-resolved after total loss):
        # recovery if probed, else unattributed
        cls = "recovery" if span.outcome == "recovered" else "unattributed"
        return TxnCriticalPath(span.txn_id, span.outcome, total,
                               [Segment("opaque", cls, t_submit, total)])

    recovering = span.recoveries > 0 or span.outcome == "recovered"
    segments: List[Segment] = []
    cursor = t_submit

    def emit(phase: str, cls: str, until: Optional[int]) -> None:
        nonlocal cursor
        if until is None:
            return
        until = min(max(until, cursor), t_resolve)
        if until > cursor:
            segments.append(Segment(phase, cls, cursor, until - cursor))
            cursor = until

    # 1) PreAccept fan-out: submit → first delivery (message) → first
    #    PRE_ACCEPTED (replica queue).  Without the message timeline the
    #    whole leg is the fan-out message wait.
    first_pa = min(preaccept_ts) if preaccept_ts else None
    if preaccept_recv_us is not None and first_pa is not None \
            and t_submit <= preaccept_recv_us <= first_pa:
        emit("preaccept_fanout", "message_wait", preaccept_recv_us)
        emit("preaccept_queue", "replica_queue_wait", first_pa)
    else:
        emit("preaccept_fanout", "message_wait", first_pa)
    # 2) quorum gather: replies trickle back until the fan-out's last
    #    pre-accept (the fast path waits on the full electorate)
    last_pa = max(preaccept_ts) if preaccept_ts else None
    emit("preaccept_quorum_gather", "message_wait", last_pa)
    # 3) decision: the coordinator's commit (+ Accept round on the slow
    #    path) landing at the first replica; recovery-class when a recovery
    #    round drove it
    emit("decision_wait", "recovery" if recovering else "message_wait",
         min(decided_ts) if decided_ts else None)
    # 4) stable propagation across the replica set
    emit("stable_propagation", "message_wait",
         min(stable_ts) if stable_ts else None)
    # 5) deps/execute wait + apply on the CRITICAL store: the one whose
    #    APPLIED lands last (the client ack waits for it).  The wait splits
    #    by WHICH plane was pending (round 12, so frontier-driven and
    #    event-driven runs compare class-for-class in one report):
    #    - deps_commit_wait   — the txn's own OUTCOME had not arrived (no
    #                           PRE_APPLIED yet): nothing local can apply it
    #                           regardless of deps;
    #    - deps_execute_wait  — outcome known, waiting for the local
    #                           dependency frontier to drain (and, in
    #                           frontier mode, for the device release tick).
    #    Both phases keep the deps_wait / fence_bootstrap_wait CLASS; the
    #    split is the phase axis.
    if apply_chains:
        # key on the APPLIED time only: the tuples carry Optionals that do
        # not order; ties break on list order (deterministic insertion order)
        applied, exec_ready, _stable, bootstrapped, outcome_at, drained_at = \
            max(apply_chains, key=lambda c: c[0])
        wait_cls = "fence_bootstrap_wait" if bootstrapped else "deps_wait"
        if exec_ready is not None:
            if outcome_at is not None and (drained_at is None
                                           or outcome_at < drained_at):
                # outcome arrived first: until then the commit/outcome plane
                # was the (or a) binding constraint
                emit("deps_commit_wait", wait_cls, outcome_at)
            emit("deps_execute_wait", wait_cls,
                 drained_at if drained_at is not None else applied)
            if outcome_at is not None and drained_at is not None \
                    and outcome_at > drained_at:
                # frontier drained before the outcome landed: that tail is
                # outcome wait, not apply compute
                emit("deps_commit_wait", wait_cls, outcome_at)
            emit("apply", "handler_compute", applied)
        else:
            emit("deps_execute_wait", wait_cls, applied)
    # 6) the ack back to the client (a probe round-trip when recovered)
    emit("ack", "recovery" if span.outcome == "recovered" else "message_wait",
         t_resolve)
    if cursor < t_resolve:
        segments.append(Segment("residue", "unattributed", cursor,
                                t_resolve - cursor))
    return TxnCriticalPath(span.txn_id, span.outcome, total, segments)


def extract_critical_paths(recorder) -> List[TxnCriticalPath]:
    """Every resolved committed client txn's critical chain, in submit
    order."""
    recv = _preaccept_recv_index(recorder)
    out: List[TxnCriticalPath] = []
    spans = sorted((s for s in recorder.spans.spans.values()
                    if s.is_client_op and s.submitted_us is not None),
                   key=lambda s: (s.submitted_us, str(s.txn_id)))
    for span in spans:
        path = extract_txn_path(span, recv.get(str(span.txn_id)))
        if path is not None:
            out.append(path)
    return out


def _percentile(sorted_vals: List[int], q: float) -> Optional[int]:
    """Exact nearest-rank percentile over a sorted list (deterministic;
    post-run analysis needs no bucketing)."""
    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1,
                     int(q * len(sorted_vals) + 0.999999) - 1))
    return sorted_vals[idx]


def latency_budget(recorder, top_k: int = 6) -> dict:
    """The latency-budget report: per-class totals/shares over every
    committed txn's critical chain, exact p50/p95/p99 of per-txn class
    time, top-k classes by total contribution, and the attribution share
    (the ≥95% acceptance bar)."""
    paths = extract_critical_paths(recorder)
    per_class_vals: Dict[str, List[int]] = {c: [] for c in SEGMENT_CLASSES}
    per_phase: Dict[str, Dict[str, int]] = {}
    total_us = 0
    for path in paths:
        total_us += path.total_us
        budget = path.by_class()
        for cls in SEGMENT_CLASSES:
            per_class_vals[cls].append(budget.get(cls, 0))
        for seg in path.segments:
            row = per_phase.setdefault(
                seg.phase, {"total_us": 0, "count": 0, "class": seg.cls})
            row["total_us"] += seg.dur_us
            row["count"] += 1
    classes = {}
    for cls, vals in per_class_vals.items():
        cls_total = sum(vals)
        if not vals or (cls_total == 0 and cls != "unattributed"):
            continue
        ordered = sorted(vals)
        classes[cls] = {
            "total_us": cls_total,
            "share": round(cls_total / total_us, 4) if total_us else 0.0,
            "mean_us": round(cls_total / len(vals), 1),
            "p50_us": _percentile(ordered, 0.50),
            "p95_us": _percentile(ordered, 0.95),
            "p99_us": _percentile(ordered, 0.99),
        }
    totals = sorted(p.total_us for p in paths)
    unattributed = classes.get("unattributed", {}).get("total_us", 0)
    top = sorted(((c, v["total_us"]) for c, v in classes.items()
                  if c != "unattributed"),
                 key=lambda kv: (-kv[1], kv[0]))[:top_k]
    dominating = top[0][0] if top else None
    return {
        "time_plane": "sim_us",
        "txns": len(paths),
        "mean_commit_latency_us": round(total_us / len(paths), 1)
        if paths else None,
        "p50_us": _percentile(totals, 0.50),
        "p95_us": _percentile(totals, 0.95),
        "p99_us": _percentile(totals, 0.99),
        "total_us": total_us,
        "attributed_share": round(1.0 - (unattributed / total_us), 4)
        if total_us else None,
        "dominating_class": dominating,
        "dominating_share": classes[dominating]["share"] if dominating
        else None,
        "top": [{"class": c, "total_us": t,
                 "share": round(t / total_us, 4) if total_us else 0.0}
                for c, t in top],
        "classes": classes,
        "phases": {p: dict(v, share=round(v["total_us"] / total_us, 4)
                           if total_us else 0.0)
                   for p, v in sorted(per_phase.items())},
    }


def format_budget(report: dict, label: str = "") -> str:
    """Human-readable latency-budget table (the burn CLI's --profile
    output)."""
    if not report["txns"]:
        return f"latency budget{': ' + label if label else ''}: " \
               f"no committed txns recorded"
    lines = []
    head = f"latency budget{': ' + label if label else ''} — " \
           f"{report['txns']} commits, mean " \
           f"{report['mean_commit_latency_us'] / 1000.0:.2f} ms, " \
           f"{100.0 * report['attributed_share']:.1f}% attributed " \
           f"(sim time)"
    lines.append(head)
    lines.append(f"  {'class':<22}{'share':>7}{'mean_ms':>9}{'p50_ms':>8}"
                 f"{'p95_ms':>8}{'p99_ms':>8}")
    ranked = sorted(report["classes"].items(),
                    key=lambda kv: (-kv[1]["total_us"], kv[0]))
    for cls, row in ranked:
        lines.append(
            f"  {cls:<22}{100.0 * row['share']:>6.1f}%"
            f"{row['mean_us'] / 1000.0:>9.2f}"
            f"{(row['p50_us'] or 0) / 1000.0:>8.2f}"
            f"{(row['p95_us'] or 0) / 1000.0:>8.2f}"
            f"{(row['p99_us'] or 0) / 1000.0:>8.2f}")
    lines.append("  phases: " + ", ".join(
        f"{p} {100.0 * v['share']:.1f}%"
        for p, v in sorted(report["phases"].items(),
                           key=lambda kv: -kv[1]["total_us"])))
    return "\n".join(lines)
