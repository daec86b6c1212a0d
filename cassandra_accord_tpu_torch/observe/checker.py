"""Elle-style strict-serializability checker over a client-visible history.

A second, protocol-blind oracle (the reference validates with Jepsen's Elle
and a Maelstrom adapter): given only what clients observed — list-append
writes with unique values and reads returning per-key version lists — decide
whether the history is strictly serializable, and if not, name the anomaly
with the full offending sub-history.

Model (Elle's list-append inference, specialized to our harness):

1. VERSION ORDER per key falls out of the data type: every observed read is
   a version (a list), and because appends are atomic list extensions, all
   observations of one key must be prefixes of one another.  The longest
   observation (or the final replica state when provided) IS the version
   order; a non-prefix pair of observations is itself an anomaly
   (``incompatible-order``).
2. WRITE ATTRIBUTION: write values are unique, so position ``p`` of key
   ``k``'s order names exactly one writer op.
3. DEPENDENCY GRAPH over ok ops (info-outcome writers whose values surface
   join as nodes — their effects provably executed):
   - ``ww``  writer of (k,p) -> writer of (k,p+1)
   - ``wr``  writer of (k,L-1) -> reader that observed length L
   - ``rw``  reader that observed length L -> writer of (k,L)   (anti-dep)
   - ``rt``  A -> B when A completed before B was invoked (real time); the
     quadratic pair set is encoded as a virtual chain over completion ranks
     (O(n) nodes/edges, same trick as harness/verifier.py).
4. Any cycle is a violation, classified by its edge kinds:
   - all ``ww``                    -> G0 (write cycle)
   - ``ww``/``wr`` only            -> G1c (circular information flow)
   - exactly one ``rw``            -> G-single (read skew); the 2-op
     wr+rw form is a fractured read, reported as non-repeatable-read
   - two+ ``rw``                   -> G2 (anti-dependency cycle)
   - any ``rt`` edge in the cycle  -> "-realtime" suffix: the cycle only
     closes through real time — a strict-serializability violation (e.g. a
     stale read of a completed write is G-single-realtime)
5. Direct (non-cycle) anomalies:
   - ``lost-update``        an acked write's value is missing from its key's
     authoritative final order
   - ``G1a-aborted-read``   an invalidated op's write value surfaced in a
     read or in the final state

Anomaly reports carry the offending sub-history (invoke/ok intervals, reads,
writes per implicated op) and, when a span recorder is supplied, the
flight-recorder timelines of the implicated txns — the "what was the
protocol doing" forensic attachment.

The checker knows nothing about Accord: no TxnIds ordering, no deps, no
epochs.  It can therefore disagree with the in-process verifier/auditor —
which is the point (ROADMAP item 4d).
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Tuple


class HistoryAnomaly(AssertionError):
    """A named strict-serializability anomaly with its full report."""

    def __init__(self, report: dict):
        self.report = report
        super().__init__(format_report(report))


def format_report(report: dict, max_ops: int = 12) -> str:
    """Human-readable rendering of a checker report's first anomaly."""
    anomalies = report.get("anomalies") or []
    if not anomalies:
        return f"history clean: {report}"
    a = anomalies[0]
    lines = [f"history anomaly: {a['name']} — {a.get('detail', '')}".rstrip()]
    for e in a.get("edges", []):
        key = f" key={e['key']}" if e.get("key") is not None else ""
        lines.append(f"  op {e['from']} -{e['kind']}{key}-> op {e['to']}")
    subs = a.get("sub_history", [])
    for rec in subs[:max_ops]:
        lines.append(
            f"  op {rec['op_id']} [{rec['invoke_us']}..{rec['complete_us']}] "
            f"{rec['outcome']} reads={rec['reads']} writes={rec['writes']} "
            f"txn={rec['txn_id']}")
    if len(subs) > max_ops:
        lines.append(f"  ... {len(subs) - max_ops} more implicated ops")
    if a.get("timelines"):
        lines.append(f"  flight-recorder timelines attached for "
                     f"{sorted(a['timelines'])}")
    if a.get("causal_slices"):
        lines.append(f"  causal slices attached for "
                     f"{sorted(a['causal_slices'])}")
    more = len(anomalies) - 1
    if more:
        lines.append(f"  (+{more} further anomalies in report)")
    return "\n".join(lines)


def _classify(edges: List[dict]) -> Tuple[str, str]:
    """Name a cycle from its edge kinds; returns (name, detail)."""
    kinds = [e["kind"] for e in edges]
    data_kinds = [k for k in kinds if k != "rt"]
    has_rt = "rt" in kinds
    n_rw = data_kinds.count("rw")
    if not data_kinds:
        # cannot happen (the rt chain alone is acyclic) — defensive
        return "real-time", "cycle of pure real-time edges"
    if n_rw == 0 and set(data_kinds) == {"ww"}:
        base, detail = "G0", "write cycle: ww edges only"
    elif n_rw == 0:
        base, detail = "G1c", "circular information flow (ww/wr)"
    elif n_rw == 1:
        base, detail = "G-single", "single anti-dependency cycle (read skew)"
    else:
        base, detail = "G2", f"{n_rw} anti-dependency edges"
    real_ops = {e["from"] for e in edges} | {e["to"] for e in edges}
    if base == "G-single" and not has_rt and len(real_ops) == 2 \
            and set(data_kinds) == {"wr", "rw"}:
        return ("non-repeatable-read",
                "fractured read: observed part of one txn's atomic writes")
    if has_rt:
        if base == "G-single":
            detail = "stale read: op invoked after a completed write " \
                     "did not observe it (real-time violation)"
        else:
            detail += " closed through real time " \
                      "(strict-serializability violation)"
        return base + "-realtime", detail
    return base, detail


def check_history(ops, final_state: Optional[Dict] = None, spans=None,
                  raise_on_anomaly: bool = True,
                  max_anomalies: int = 8, provenance=None) -> dict:
    """Check a list of ``HistoryOp`` for strict serializability.

    ``final_state``: authoritative key -> version tuple (e.g. the burn's
    replica-agreement snapshot); enables lost-update detection and extends
    per-key orders beyond what reads observed.  ``spans``: a
    ``TxnSpanRecorder`` (or FlightRecorder ``.spans``) for timeline
    attachment.  ``provenance``: a ``ProvenanceRecorder`` — each anomaly
    then carries a bounded backward causal slice per implicated txn
    (``causal_slices``), the "how did the protocol get here" attachment.
    Returns the report; raises :class:`HistoryAnomaly` on the first anomaly
    unless ``raise_on_anomaly=False`` (then the report carries up to
    ``max_anomalies`` of them).
    """
    anomalies: List[dict] = []
    considered = [op for op in ops if op.outcome != "fail"]
    ok_ops = [op for op in considered if op.outcome == "ok"]

    def _attach(names, implicated, edges=None, detail=""):
        a = {"name": names, "detail": detail,
             "edges": edges or [],
             "sub_history": [op.to_record() for op in implicated]}
        if spans is not None:
            # accept a FlightRecorder, a TxnSpanRecorder, or a raw dict
            table = spans
            while not hasattr(table, "get"):
                table = getattr(table, "spans", {})
            tl = {}
            for op in implicated:
                span = table.get(op.txn_id)
                if span is not None and hasattr(span, "to_dict"):
                    tl[str(op.txn_id)] = span.to_dict()
            if tl:
                a["timelines"] = tl
        if provenance is not None:
            slices = {}
            for op in implicated:
                if op.txn_id is None:
                    continue
                sl = provenance.slice_for(txn_id=op.txn_id)
                if sl is not None:
                    slices[str(op.txn_id)] = sl
            if slices:
                a["causal_slices"] = slices
        anomalies.append(a)
        return a

    # -- 1. per-key version order from observations + final state ------------
    orders: Dict[object, tuple] = {}
    observers: Dict[object, object] = {}   # key -> op that gave the longest
    for op in ok_ops:
        for key, observed in op.reads.items():
            prev = orders.get(key, ())
            short, long_ = (observed, prev) if len(prev) >= len(observed) \
                else (prev, observed)
            if tuple(long_[:len(short)]) != tuple(short):
                prev_op = observers.get(key)
                _attach("incompatible-order",
                        [o for o in (prev_op, op) if o is not None],
                        detail=f"non-prefix observations of key {key}: "
                               f"{list(prev)} vs {list(observed)}")
                continue
            if len(observed) > len(prev):
                orders[key] = tuple(observed)
                observers[key] = op
    if final_state:
        for key, order in final_state.items():
            prev = orders.get(key, ())
            order = tuple(order)
            short, long_ = (order, prev) if len(prev) >= len(order) \
                else (prev, order)
            if tuple(long_[:len(short)]) != tuple(short):
                prev_op = observers.get(key)
                _attach("incompatible-order",
                        [o for o in (prev_op,) if o is not None],
                        detail=f"observation of key {key} is not a prefix of "
                               f"the final replica state: {list(prev)} vs "
                               f"final {list(order)}")
                continue
            if len(order) > len(prev):
                orders[key] = order

    # -- 2. unique write values name the writer of every position ------------
    value_pos: Dict[object, Dict[object, int]] = {
        key: {v: i for i, v in enumerate(order)}
        for key, order in orders.items()}
    writers: Dict[Tuple[object, int], object] = {}
    for op in considered:
        if op.outcome not in ("ok", "info", None):
            continue   # invalidated writers handled below (G1a)
        for key, vals in op.writes.items():
            positions = value_pos.get(key, {})
            for v in vals:
                pos = positions.get(v)
                if pos is not None:
                    writers[(key, pos)] = op

    # -- 3. direct anomalies: aborted read, lost update ----------------------
    for op in considered:
        if op.outcome != "invalidated":
            continue
        for key, vals in op.writes.items():
            surfaced = [v for v in vals if v in value_pos.get(key, {})]
            if surfaced:
                readers = [o for o in ok_ops
                           if any(v in o.reads.get(key, ()) for v in surfaced)]
                _attach("G1a-aborted-read", [op] + readers,
                        detail=f"invalidated write {surfaced} to key {key} "
                               f"surfaced in the version order")
    if final_state is not None:
        authoritative = set(final_state)
        for op in ok_ops:
            for key, vals in op.writes.items():
                if key not in authoritative:
                    # an acked write to a key entirely absent from the final
                    # state: every value of it was lost
                    _attach("lost-update", [op],
                            detail=f"acked write {list(vals)} to key {key}: "
                                   f"key absent from final replica state")
                    continue
                missing = [v for v in vals
                           if v not in value_pos.get(key, {})]
                if missing:
                    _attach("lost-update", [op],
                            detail=f"acked write {missing} to key {key} "
                                   f"missing from final order "
                                   f"{list(orders.get(key, ()))}")

    # -- 4. dependency graph -------------------------------------------------
    # nodes: ok ops + info ops that provably executed (their writes surfaced)
    graph_ops = list(ok_ops)
    seen = set(map(id, graph_ops))
    for w in writers.values():
        if id(w) not in seen:
            seen.add(id(w))
            graph_ops.append(w)
    adj: Dict[object, List[Tuple[object, str, object]]] = \
        {op: [] for op in graph_ops}
    edge_counts = {"ww": 0, "wr": 0, "rw": 0, "rt": 0}

    edge_seen = set()

    def _edge(a, b, kind, key):
        if a is b or (id(a), id(b), kind, key) in edge_seen:
            return
        edge_seen.add((id(a), id(b), kind, key))
        adj[a].append((b, kind, key))
        edge_counts[kind] += 1

    for key, order in orders.items():
        for pos in range(len(order) - 1):
            a, b = writers.get((key, pos)), writers.get((key, pos + 1))
            if a is not None and b is not None:
                _edge(a, b, "ww", key)
    # per-key committed writers: a read returns the ENTIRE list, so an ok
    # write NONE of whose values appear in an observed list must serialize
    # after that read — an rw edge the positional table alone cannot supply
    # when the write's value never surfaced in any observation or the final
    # state (its position is unknown, but its ordering vs the read is not).
    key_writers: Dict[object, List[object]] = {}
    for w in ok_ops:
        for key in w.writes:
            key_writers.setdefault(key, []).append(w)
    for op in ok_ops:
        for key, observed in op.reads.items():
            n = len(observed)
            if n:
                w = writers.get((key, n - 1))
                if w is not None:
                    _edge(w, op, "wr", key)
            if n < len(orders.get(key, ())):
                w = writers.get((key, n))
                if w is not None:
                    _edge(op, w, "rw", key)
            observed_set = set(observed)
            for w in key_writers.get(key, ()):
                if w is not op and \
                        not any(v in observed_set for v in w.writes[key]):
                    _edge(op, w, "rw", key)

    # real-time edges between ok ops, via a virtual chain over completion
    # ranks: rt_j means "completions of rank <= j have happened"; an op
    # invoked strictly after completion j is reachable from every op with
    # completion rank <= j in O(n) edges.  Strict (<) comparison: two
    # zero-duration ops sharing a sim-timestamp are concurrent, not ordered.
    by_completion = sorted(ok_ops, key=lambda o: o.complete_us)
    completes = [o.complete_us for o in by_completion]
    chain = [("rt", j) for j in range(len(by_completion))]
    for node in chain:
        adj[node] = []
    for j, op in enumerate(by_completion):
        adj[op].append((chain[j], "rt", None))
        if j + 1 < len(chain):
            adj[chain[j]].append((chain[j + 1], "rt", None))
    for op in ok_ops:
        # largest completion rank strictly before this op's invocation
        j = bisect_left(completes, op.invoke_us) - 1
        while j >= 0 and by_completion[j] is op:
            j -= 1
        if j >= 0:
            adj[chain[j]].append((op, "rt", None))
            edge_counts["rt"] += 1

    # -- 5. cycle detection (iterative 3-color DFS) --------------------------
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {node: WHITE for node in adj}

    def _find_cycle():
        for root in adj:
            if color[root] != WHITE:
                continue
            # stack of (node, edge iterator); path holds (node, via_edge)
            stack = [(root, iter(adj[root]))]
            color[root] = GRAY
            path = [(root, None)]
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt, kind, key in it:
                    if color.get(nxt, BLACK) == GRAY:
                        # back edge: slice the cycle out of the path
                        idx = next(i for i, (n, _e) in enumerate(path)
                                   if n is nxt)
                        cyc = path[idx:] + [(nxt, (node, kind, key))]
                        return cyc
                    if color.get(nxt, BLACK) == WHITE:
                        color[nxt] = GRAY
                        stack.append((nxt, iter(adj[nxt])))
                        path.append((nxt, (node, kind, key)))
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
                    path.pop()
        return None

    cyc = _find_cycle()
    if cyc is not None:
        # the cycle as a closed edge walk: cyc[k][1] = (parent, kind, key) is
        # the edge cyc[k-1].node -> cyc[k].node; cyc[0].node == cyc[-1].node
        walk = []
        for k in range(1, len(cyc)):
            _parent, kind, key = cyc[k][1]
            walk.append((cyc[k - 1][0], cyc[k][0], kind, key))
        # rotate so the walk starts at a real op, then collapse virtual
        # rt-chain segments: a path a -> rt_i .. rt_j -> b is ONE rt edge
        def _real(node):
            return getattr(node, "op_id", None) is not None
        start = next(i for i, (s, _d, _k, _key) in enumerate(walk)
                     if _real(s))
        walk = walk[start:] + walk[:start]
        edges: List[dict] = []
        implicated: List[object] = [walk[0][0]]
        prev_real, pending_rt = walk[0][0], False
        for _src, dst, kind, key in walk:
            if not _real(dst):
                pending_rt = True
                continue
            edges.append({"from": prev_real.op_id, "to": dst.op_id,
                          "kind": "rt" if pending_rt else kind,
                          "key": None if (pending_rt or key is None)
                          else str(key)})
            pending_rt = False
            prev_real = dst
            if dst not in implicated:
                implicated.append(dst)
        name, detail = _classify(edges)
        _attach(name, implicated, edges=edges, detail=detail)

    report = {
        "ops": len(considered),
        "ok": len(ok_ops),
        "keys": len(orders),
        "edges": edge_counts,
        "anomalies": anomalies[:max_anomalies],
    }
    if anomalies and raise_on_anomaly:
        raise HistoryAnomaly(report)
    return report
