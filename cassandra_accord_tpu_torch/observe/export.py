"""Chrome trace-event export: load a burn's flight recording in Perfetto.

Produces the JSON object format of the Trace Event spec
(``{"traceEvents": [...]}``, timestamps in MICROseconds — exactly the
simulator's native unit):

- pid = node id, tid 0 = that node's coordinator track, tid = store id + 1
  for its command-store tracks (``M`` metadata events name them);
- one ``X`` (complete) event per client txn on the coordinator track,
  spanning submit→resolve, args carrying path/outcome/recovery attribution;
- per-(node, store) ``X`` events for each status segment of a txn's
  lifecycle (PRE_ACCEPTED until ACCEPTED, ... until the next transition),
  with an ``i`` (instant) event for the terminal status;
- optional ``i`` events for raw message routing (SEND/DROP/RECV...), on the
  sending node's coordinator track;
- ``C`` (counter) events on the synthetic counters process (pid 0): in-flight
  client txns and cumulative recovery / invalidation attempts, sampled on
  uniform sim-time buckets — Perfetto renders them as counter tracks above
  the spans, so livelock shapes (the seed-6 probe storm) are visible at a
  glance.  Derived at EXPORT time from the recorded spans and attempt
  timestamps: no runtime sampling task, so the zero-observer-effect contract
  is untouched.

``validate_chrome_trace`` is the schema check the tier-1 tests run over
every export.
"""
from __future__ import annotations

import json
from typing import List

_VALID_PHASES = {"X", "i", "M", "B", "E", "C", "s", "t", "f"}
_FLOW_PHASES = {"s", "t", "f"}

# synthetic pid for cluster-wide counter tracks (real nodes are 1-based)
COUNTER_PID = 0
# synthetic pid for the wall-clock profiler tracks (observe/profiler.py):
# timestamps on this process are WALL micros since profiler start — a
# different time base from the sim tracks, linked per-txn by flow events
WALL_PID = 9999
_COUNTER_BUCKETS = 256


def counter_events(recorder, buckets: int = _COUNTER_BUCKETS) -> List[dict]:
    """Cluster-wide counter tracks sampled on uniform sim-time buckets:
    in-flight client txns (from span submit/resolve envelopes) and
    cumulative recovery / invalidation attempts (from the recorder's
    sim-timestamped attribution)."""
    spans = [s for s in recorder.spans.spans.values() if s.is_client_op]
    times = [s.submitted_us for s in spans] \
        + [s.resolved_us for s in spans if s.resolved_us is not None] \
        + list(recorder._recovery_times) + list(recorder._invalidate_times)
    if not times:
        return []
    lo, hi = min(times), max(times)
    width = max((hi - lo) // max(buckets, 1), 1)
    edges = list(range(lo, hi + width, width))

    def cumulative(points):
        pts = sorted(points)
        out, i = [], 0
        for edge in edges:
            while i < len(pts) and pts[i] <= edge:
                i += 1
            out.append(i)
        return out

    submitted = cumulative([s.submitted_us for s in spans])
    resolved = cumulative([s.resolved_us for s in spans
                           if s.resolved_us is not None])
    recoveries = cumulative(recorder._recovery_times)
    invalidates = cumulative(recorder._invalidate_times)
    events: List[dict] = []
    for i, edge in enumerate(edges):
        events.append({"name": "in_flight_txns", "cat": "counter", "ph": "C",
                       "ts": edge, "pid": COUNTER_PID, "tid": 0,
                       "args": {"in_flight": submitted[i] - resolved[i]}})
        if recoveries[-1] or invalidates[-1]:
            events.append({"name": "recovery_attempts", "cat": "counter",
                           "ph": "C", "ts": edge, "pid": COUNTER_PID,
                           "tid": 0,
                           "args": {"recoveries": recoveries[i],
                                    "invalidations": invalidates[i]}})
    return events


def service_counter_events(recorder,
                           buckets: int = _COUNTER_BUCKETS) -> List[dict]:
    """Consult-service counter track (pid 0, tid 1): batching-window queue
    depth and dispatched batch size over sim time, from the samples
    ``collect_cluster`` pulled out of every engaged DeviceConsultService.
    Bucketed to the same resolution as the cluster counter tracks."""
    samples = getattr(recorder, "_service_samples", None)
    if not samples:
        return []
    lo, hi = samples[0][0], samples[-1][0]
    width = max((hi - lo) // max(buckets, 1), 1)
    events: List[dict] = []
    bucket_ts = None
    depth_max = 0
    rows_max = 0
    for ts, depth, rows in samples:
        b = lo + ((ts - lo) // width) * width
        if bucket_ts is None:
            bucket_ts = b
        if b != bucket_ts:
            events.append({"name": "consult_service", "cat": "counter",
                           "ph": "C", "ts": bucket_ts, "pid": COUNTER_PID,
                           "tid": 1, "args": {"queue_depth": depth_max,
                                              "batch_rows": rows_max}})
            bucket_ts, depth_max, rows_max = b, 0, 0
        depth_max = max(depth_max, depth)
        rows_max = max(rows_max, rows)
    events.append({"name": "consult_service", "cat": "counter", "ph": "C",
                   "ts": bucket_ts, "pid": COUNTER_PID, "tid": 1,
                   "args": {"queue_depth": depth_max,
                            "batch_rows": rows_max}})
    return events


def timeline_counter_events(recorder) -> List[dict]:
    """Per-window telemetry counter track (pid 0, tid 2) from an attached
    ``observe/timeline.Timeline``: windowed commits/s, p99 commit latency
    (ms) and in-flight txns — the trajectory curves, natively in Perfetto,
    one ``C`` event per sim-time window.  Empty when no timeline rode the
    recorder."""
    timeline = getattr(recorder, "timeline", None)
    if timeline is None:
        return []
    from . import schema
    from .timeline import COMMIT_OUTCOMES
    commit_names = [schema.OUTCOME_METRICS[o] for o in COMMIT_OUTCOMES]
    events: List[dict] = []
    for rec in timeline.records(include_open=True):
        cluster = rec["scopes"].get("cluster", {})
        args: dict = {}
        rates = cluster.get("rates_per_s", {})
        # ALWAYS emitted, 0.0 included: Perfetto holds a counter at its last
        # sample until the next one, so skipping commit-less windows would
        # render a stall as a flat healthy line — the exact trajectory this
        # track exists to show is commits/s falling to zero
        args["commits_per_sec"] = round(
            sum(rates.get(n, 0.0) for n in commit_names), 3)
        pct = cluster.get("percentiles", {}).get(schema.LATENCY_METRIC)
        if pct and pct.get("p99") is not None:
            args["latency_p99_ms"] = round(pct["p99"] / 1000.0, 3)
        sample = cluster.get("samples", {}).get(schema.TIMELINE_IN_FLIGHT_METRIC)
        if sample is not None:
            args["in_flight"] = sample
        events.append({"name": "timeline", "cat": "counter", "ph": "C",
                       "ts": rec["start_us"], "pid": COUNTER_PID, "tid": 2,
                       "args": args})
    return events


def wall_profile_events(recorder, profiler) -> List[dict]:
    """Plane-2 tracks: one ``X`` slice per recorded handler invocation on
    the synthetic wall-clock process (pid ``WALL_PID``, tid = node id,
    timestamps in WALL micros since profiler start), plus FLOW events
    (``s``/``t``/``f``) linking each client txn's sim-time span (on its
    coordinator track) to the host handler slices that served it — the
    two-time-base bridge: click a txn, follow the flow to the wall plane."""
    if profiler is None or not profiler.slices:
        return []
    events: List[dict] = []
    # handler slices, and per-txn wall slices for flow binding
    by_txn: dict = {}
    for i, (type_name, node, tid_str, wall_us, dur_us, sim_us) in \
            enumerate(profiler.slices):
        events.append({"name": type_name, "cat": "wall_handler", "ph": "X",
                       "ts": wall_us, "dur": dur_us, "pid": WALL_PID,
                       "tid": node,
                       "args": {"txn_id": tid_str, "sim_us": sim_us}})
        if tid_str is not None:
            by_txn.setdefault(tid_str, []).append((wall_us, node))
    for span in recorder.spans.spans.values():
        if not span.is_client_op:
            continue
        slices = by_txn.get(str(span.txn_id))
        if not slices:
            continue
        flow_id = f"txnflow-{span.txn_id}"
        events.append({"name": "serves", "cat": "txnflow", "ph": "s",
                       "id": flow_id, "ts": span.submitted_us,
                       "pid": span.coordinator, "tid": 0,
                       "args": {"txn_id": str(span.txn_id)}})
        for j, (wall_us, node) in enumerate(slices):
            ph = "f" if j + 1 == len(slices) else "t"
            ev = {"name": "serves", "cat": "txnflow", "ph": ph,
                  "id": flow_id, "ts": wall_us, "pid": WALL_PID, "tid": node,
                  "args": {"txn_id": str(span.txn_id)}}
            if ph == "f":
                ev["bp"] = "e"   # bind to the enclosing handler slice
            events.append(ev)
    return events


def causal_flow_events(recorder) -> List[dict]:
    """Causal-edge flow tracks from an attached ``ProvenanceRecorder``:

    - one flow per message id chaining its wire lifecycle (send -> RECV ->
      reply -> RECV_RPLY) across the node tracks, so a delivery is clickable
      back to its send;
    - one flow per audit-violation causal slice (cap 8), threading the
      violation's ancestor cone through the handler/lifecycle tracks it
      touched — the cone IS the clickable path in the timeline UI.

    Derived entirely at export time from the provenance side table: zero
    runtime cost, nothing emitted when no recorder rode the run."""
    prov = getattr(recorder, "provenance", None)
    if prov is None:
        return []
    from .provenance import E_FRM, E_KIND, E_MSG, E_TO, E_US, K_MSG, \
        K_TRANSITION

    def track(ev):
        if ev[E_KIND] == K_MSG:
            return (ev[E_FRM] if ev[E_FRM] is not None else 0), 0
        if ev[E_KIND] == K_TRANSITION:
            # transition tuples carry store in the FRM slot (see provenance)
            return ev[E_TO], (ev[E_FRM] or 0) + 1
        return (ev[E_TO] if ev[E_TO] is not None else 0), 0

    events: List[dict] = []
    chains: dict = {}
    for ev in prov.events:
        if ev[E_KIND] == K_MSG and ev[E_MSG] is not None:
            chains.setdefault(ev[E_MSG], []).append(ev)
    for msg_id, chain in chains.items():
        if len(chain) < 2:
            continue
        flow_id = f"cause-msg-{msg_id}"
        for j, ev in enumerate(chain):
            ph = "s" if j == 0 else ("f" if j + 1 == len(chain) else "t")
            pid, tid = track(ev)
            e = {"name": "causal", "cat": "causal", "ph": ph, "id": flow_id,
                 "ts": ev[E_US], "pid": pid, "tid": tid,
                 "args": {"msg_id": msg_id}}
            if ph == "f":
                e["bp"] = "e"
            events.append(e)
    for k, violation in enumerate(getattr(recorder, "violations", ())[:8]):
        sl = getattr(violation, "causal_slice", None)
        if not sl or len(sl["events"]) < 2:
            continue
        flow_id = f"slice-{violation.rule}-{k}"
        cone = [prov.events[d["pid"]] for d in sl["events"]]
        for j, ev in enumerate(cone):
            ph = "s" if j == 0 else ("f" if j + 1 == len(cone) else "t")
            pid, tid = track(ev)
            e = {"name": "violation-slice", "cat": "causal", "ph": ph,
                 "id": flow_id, "ts": ev[E_US], "pid": pid, "tid": tid,
                 "args": {"rule": violation.rule}}
            if ph == "f":
                e["bp"] = "e"
            events.append(e)
    return events


def _span_events(span) -> List[dict]:
    events: List[dict] = []
    tid_str = str(span.txn_id)
    if span.is_client_op:
        end = span.resolved_us if span.resolved_us is not None \
            else span.submitted_us
        events.append({
            "name": f"txn {tid_str}", "cat": "txn", "ph": "X",
            "ts": span.submitted_us,
            "dur": max(end - span.submitted_us, 1),
            "pid": span.coordinator, "tid": 0,
            "args": {"txn_id": tid_str, "op_id": span.op_id,
                     "path": span.path, "outcome": span.outcome,
                     "recoveries": span.recoveries,
                     "invalidate_attempts": span.invalidate_attempts,
                     "timeouts": span.timeouts, "backoffs": span.backoffs},
        })
    for (node, store), transitions in sorted(span.transitions.items()):
        for i, (status, ts) in enumerate(transitions):
            args = {"txn_id": tid_str, "status": status}
            if i + 1 < len(transitions):
                dur = max(transitions[i + 1][1] - ts, 1)
                events.append({"name": status, "cat": "lifecycle", "ph": "X",
                               "ts": ts, "dur": dur, "pid": node,
                               "tid": store + 1, "args": args})
            else:
                events.append({"name": status, "cat": "lifecycle", "ph": "i",
                               "s": "t", "ts": ts, "pid": node,
                               "tid": store + 1, "args": args})
    return events


def chrome_trace(recorder, include_messages: bool = True,
                 profiler=None) -> dict:
    """Render a FlightRecorder as a Chrome trace-event JSON object.
    ``profiler`` (an ``observe.WallProfiler``) adds the wall-clock handler
    tracks + per-txn flow links (``wall_profile_events``)."""
    events: List[dict] = []
    pids = set()
    tids = set()        # (pid, tid)
    for span in recorder.spans.spans.values():
        for ev in _span_events(span):
            pids.add(ev["pid"])
            tids.add((ev["pid"], ev["tid"]))
            events.append(ev)
    for ev in wall_profile_events(recorder, profiler):
        pids.add(ev["pid"])
        tids.add((ev["pid"], ev["tid"]))
        events.append(ev)
    counters = counter_events(recorder)
    if counters:
        pids.add(COUNTER_PID)
        tids.add((COUNTER_PID, 0))
        events.extend(counters)
    svc_counters = service_counter_events(recorder)
    if svc_counters:
        pids.add(COUNTER_PID)
        tids.add((COUNTER_PID, 1))
        events.extend(svc_counters)
    tl_counters = timeline_counter_events(recorder)
    if tl_counters:
        pids.add(COUNTER_PID)
        tids.add((COUNTER_PID, 2))
        events.extend(tl_counters)
    for ev in causal_flow_events(recorder):
        pids.add(ev["pid"])
        tids.add((ev["pid"], ev["tid"]))
        events.append(ev)
    if include_messages:
        for seq, ts, event, frm, to, msg_id, brief in recorder.messages:
            pids.add(frm)
            tids.add((frm, 0))
            events.append({"name": f"{event} {brief}", "cat": "msg",
                           "ph": "i", "s": "t", "ts": ts, "pid": frm,
                           "tid": 0,
                           "args": {"seq": seq, "to": to, "event": event,
                                    "msg_id": msg_id}})
    meta: List[dict] = []
    for pid in sorted(pids):
        if pid == COUNTER_PID:
            pname = "cluster counters"
        elif pid == WALL_PID:
            pname = "host wall-clock (profiler)"
        else:
            pname = f"node {pid}"
        meta.append({"name": "process_name", "ph": "M", "ts": 0, "pid": pid,
                     "tid": 0, "args": {"name": pname}})
    for pid, tid in sorted(tids):
        if pid == COUNTER_PID:
            name = {0: "counters", 1: "consult service",
                    2: "timeline"}.get(tid, f"counters {tid}")
        elif pid == WALL_PID:
            name = f"node {tid} handlers (wall)"
        else:
            name = "coordinator" if tid == 0 else f"store {tid - 1}"
        meta.append({"name": "thread_name", "ph": "M", "ts": 0, "pid": pid,
                     "tid": tid, "args": {"name": name}})
    events.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], e["name"]))
    return {"traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"source": "cassandra_accord_tpu flight recorder",
                          "time_unit": "simulated_micros",
                          "dropped_messages": recorder.dropped_messages}}


def write_chrome_trace(path: str, recorder,
                       include_messages: bool = True,
                       profiler=None) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(recorder, include_messages=include_messages,
                               profiler=profiler),
                  f, sort_keys=True)
        f.write("\n")


def validate_chrome_trace(doc) -> List[str]:
    """Schema check; returns a list of problems ([] = loadable)."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["not an object with a traceEvents array"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    flow_starts = set()
    flow_ends: List[tuple] = []
    for i, ev in enumerate(events):
        ctx = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{ctx}: not an object")
            continue
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                problems.append(f"{ctx}: missing {field!r}")
        ph = ev.get("ph")
        if ph not in _VALID_PHASES:
            problems.append(f"{ctx}: bad phase {ph!r}")
        ts = ev.get("ts")
        if not isinstance(ts, int) or ts < 0:
            problems.append(f"{ctx}: ts must be a non-negative int, got {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, int) or dur <= 0:
                problems.append(f"{ctx}: X event needs a positive int dur")
        if ph in _FLOW_PHASES:
            if not ev.get("id"):
                problems.append(f"{ctx}: flow event ({ph}) needs an id")
            elif ph == "s":
                flow_starts.add(ev["id"])
            elif ph == "f":
                flow_ends.append((i, ev["id"]))
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                problems.append(f"{ctx}: C event needs a non-empty args dict")
            elif not all(isinstance(v, (int, float)) and not isinstance(v, bool)
                         for v in args.values()):
                problems.append(f"{ctx}: C event args must be numeric series")
        if "args" in ev:
            try:
                json.dumps(ev["args"])
            except TypeError:
                problems.append(f"{ctx}: args not JSON-serializable")
        if len(problems) > 20:
            problems.append("... (truncated)")
            break
    # flow pairing: a finish (f) with no start (s) of the same id renders as
    # a dangling arrow in Perfetto — an id alone is not enough
    for i, flow_id in flow_ends:
        if flow_id not in flow_starts:
            problems.append(f"event[{i}]: flow finish id {flow_id!r} has no "
                            f"matching start")
            if len(problems) > 24:
                problems.append("... (truncated)")
                break
    return problems
