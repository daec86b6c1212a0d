"""The flight recorder: every observability hook the instrumented tree calls.

One ``FlightRecorder`` per run bundles the metrics registry, the txn span
recorder, and a (optionally ring-bounded) message event buffer, and exposes
the ``on_*`` hooks wired through ``harness/cluster.py`` (message routing,
reply timeouts/backoff), ``coordinate/`` (path classification, recovery
attribution), ``local/commands.py`` (status transitions) and
``local/progress_log.py`` (investigation launches).

All hooks obey the zero-observer-effect contract (see ``observe/__init__``):
they consume values the caller already computed and never touch RNG, wall
clock, or the event loop.
"""
from __future__ import annotations

from typing import Optional

from ..harness.trace import Trace
from . import device as device_metrics
from . import schema
from .registry import MetricsRegistry
from .spans import TxnSpanRecorder

# link-action / routing events the cluster reports for an OUTBOUND packet
# (the reply family is prefixed RPLY_); RECV/RECV_RPLY are deliveries
_SEND_EVENTS = ("DELIVER", "DROP", "FAILURE", "DELIVER_WITH_FAILURE", "DOWN")


def _message_metric(message) -> str:
    """Schema metric name for a message instance; total (never raises)."""
    try:
        return schema.metric_for_message(message.type.name)
    except Exception:  # noqa: BLE001 — unregistered/legacy message classes
        return f"msg.unregistered.{type(message).__name__}"


class FlightRecorder:
    """Metrics + spans + message events for one deterministic run."""

    def __init__(self, message_ring: Optional[int] = None,
                 record_messages: bool = True,
                 timeline=None, burnrate=None, provenance=None):
        self.registry = MetricsRegistry()
        self.spans = TxnSpanRecorder()
        self.record_messages = record_messages
        # causal provenance side table (observe/provenance.py): the per-run
        # event DAG divergence forensics and violation slicing walk.  Pure
        # bookkeeping on already-computed values — same zero-observer-effect
        # contract as every other attachment here.
        self.provenance = provenance
        # sim-time windowed telemetry (observe/timeline.py): counters become
        # per-window rates, gauges samples, latencies per-window percentiles.
        # Same zero-observer-effect contract as every other plane here.
        self.timeline = timeline
        # multi-window SLO burn-rate monitors (observe/burnrate.py): mid-run
        # early warning fed from the same hooks
        self.burnrate = burnrate
        if burnrate is not None:
            burnrate.bind(self)
        # in-flight client ops (submit minus resolve), sampled onto the
        # timeline — the commits/s-vs-in-flight curve ROADMAP item 2 reads
        self._in_flight = 0
        # the message timeline IS a Trace (same event tuples, same optional
        # ring bound) — one ring-buffer implementation, not two
        self._message_trace = Trace(keep_last=message_ring)
        # sim-timestamped recovery/invalidation attempts (Chrome-trace
        # counter tracks sample these into per-bucket "C" events)
        self._recovery_times: list = []
        self._invalidate_times: list = []
        # consult-service (ts, queue_depth, batch_rows) samples, pulled from
        # every engaged DeviceConsultService at collect_cluster time — the
        # export renders them as a dedicated counter track (pid 0, tid 1)
        self._service_samples: list = []

    @property
    def messages(self):
        return self._message_trace.events

    @property
    def dropped_messages(self) -> int:
        return self._message_trace.dropped

    # -- message plane (cluster.route / route_reply / _deliver) --------------
    def on_message_event(self, event: str, frm: int, to: int, msg_id,
                         message, now_us: int) -> None:
        reg = self.registry
        tl = self.timeline
        if event in _SEND_EVENTS:
            name = _message_metric(message)
            reg.counter(name).inc()
            reg.counter(name, node=frm).inc()
            reg.counter(f"link.{event.lower()}").inc()
            if tl is not None:
                tl.count(name, now_us)
                tl.count(f"link.{event.lower()}", now_us)
        elif event.startswith("RPLY_"):
            name = _message_metric(message)
            reg.counter(name).inc()
            reg.counter(name, node=frm).inc()
            reg.counter(f"link.reply_{event[5:].lower()}").inc()
            if tl is not None:
                tl.count(name, now_us)
                tl.count(f"link.reply_{event[5:].lower()}", now_us)
        else:   # RECV / RECV_RPLY: the delivery, counted at the receiver
            reg.counter("msg.received", node=to).inc()
            if tl is not None:
                tl.count("msg.received", now_us, node=to)
        if self.record_messages:
            self._message_trace.hook(event, frm, to, msg_id, message, now_us)
        if self.provenance is not None:
            self.provenance.on_message_event(event, frm, to, msg_id, message,
                                             now_us)
        if self.burnrate is not None:
            # clock pulse: a total wedge produces no resolutions, but probes
            # and timeouts keep the message plane (and so the monitors) live
            self.burnrate.on_pulse(now_us)

    def on_reply_timeout(self, node: int, peer: int, txn_id,
                         now_us: int) -> None:
        self.registry.counter("net.reply_timeouts").inc()
        self.registry.counter("net.reply_timeouts", node=node).inc()
        self.spans.on_timeout(txn_id)
        if self.timeline is not None:
            self.timeline.count("net.reply_timeouts", now_us)
        if self.burnrate is not None:
            # timeouts keep firing through a total wedge (held sends emit no
            # message events) — they are the monitor's clock there
            self.burnrate.on_pulse(now_us)

    def on_backoff(self, node: int, txn_id, attempt: int) -> None:
        self.registry.counter("net.backoff_rearms").inc()
        self.registry.counter("net.backoff_rearms", node=node).inc()
        self.spans.on_backoff(txn_id)

    # -- client envelope (harness/burn.py) -----------------------------------
    def on_submit(self, op_id: int, txn_id, coordinator: int,
                  now_us: int) -> None:
        self.spans.on_submit(op_id, txn_id, coordinator, now_us)
        self.registry.counter(schema.SUBMITTED_METRIC).inc()
        self.registry.counter(schema.SUBMITTED_METRIC, node=coordinator).inc()
        self._in_flight += 1
        if self.timeline is not None:
            self.timeline.count(schema.SUBMITTED_METRIC, now_us)
            self.timeline.count(schema.SUBMITTED_METRIC, now_us,
                                node=coordinator)
            self.timeline.sample(schema.TIMELINE_IN_FLIGHT_METRIC,
                                 self._in_flight, now_us)

    def on_resolve(self, txn_id, kind: str, now_us: int) -> None:
        outcome = self.spans.on_resolve(txn_id, kind, now_us)
        self.registry.counter(schema.OUTCOME_METRICS[outcome]).inc()
        span = self.spans.spans[txn_id]
        latency_us = None
        if span.submitted_us is not None:
            latency_us = now_us - span.submitted_us
            self.registry.histogram(schema.LATENCY_METRIC).record(latency_us)
        self._in_flight -= 1
        if self.timeline is not None:
            self.timeline.count(schema.OUTCOME_METRICS[outcome], now_us)
            self.timeline.sample(schema.TIMELINE_IN_FLIGHT_METRIC,
                                 self._in_flight, now_us)
            if latency_us is not None:
                self.timeline.value(schema.LATENCY_METRIC, latency_us, now_us)
        if self.burnrate is not None:
            self.burnrate.on_resolution(outcome, latency_us, now_us)

    # -- coordination classification (coordinate/) ---------------------------
    def on_path(self, txn_id, path: str,
                fast_path_votes=None) -> None:
        self.spans.on_path(txn_id, path)
        self.registry.counter(f"txn.path.{path}").inc()
        if fast_path_votes is not None:
            accepts, rejects = fast_path_votes
            self.registry.counter("txn.fastpath.votes_accept").inc(accepts)
            self.registry.counter("txn.fastpath.votes_reject").inc(rejects)

    def on_recovery(self, node: int, txn_id, ballot=None, now_us=None) -> None:
        self.spans.on_recovery(txn_id)
        self.registry.counter("recovery.attempts").inc()
        self.registry.counter("recovery.attempts", node=node).inc()
        if now_us is not None:
            # sim-timestamped attribution: the Chrome-trace export's
            # recovery counter track samples these
            self._recovery_times.append(now_us)
            if self.timeline is not None:
                self.timeline.count("recovery.attempts", now_us)

    def on_invalidate(self, node: int, txn_id, now_us=None) -> None:
        self.spans.on_invalidate_attempt(txn_id)
        self.registry.counter("recovery.invalidate_attempts").inc()
        self.registry.counter("recovery.invalidate_attempts", node=node).inc()
        if now_us is not None:
            self._invalidate_times.append(now_us)
            if self.timeline is not None:
                self.timeline.count("recovery.invalidate_attempts", now_us)

    # -- replica-side lifecycle (local/commands.py) --------------------------
    def on_transition(self, node: int, store: int, txn_id,
                      status_name: str, now_us: int,
                      command=None, command_store=None) -> None:
        """``command``/``command_store`` are the live objects the transition
        just mutated — passed so the InvariantAuditor subclass can read
        decision state (executeAt, deps, ballots, watermarks) passively;
        the recorder itself only uses the scalar fields."""
        self.spans.on_transition(node, store, txn_id, status_name, now_us)
        if self.provenance is not None:
            self.provenance.on_transition(node, store, txn_id, status_name,
                                          now_us)
        name = schema.metric_for_save_status(status_name)
        self.registry.counter(name).inc()
        self.registry.counter(name, node=node, store=store).inc()
        if self.timeline is not None:
            self.timeline.count(name, now_us)
            self.timeline.count(name, now_us, node=node, store=store)

    # -- node lifecycle (harness/cluster.py crash/restart) -------------------
    def on_crash(self, node_id: int) -> None:
        self.registry.counter("lifecycle.node_crashes").inc()
        self.registry.counter("lifecycle.node_crashes", node=node_id).inc()

    def on_restart(self, node_id: int) -> None:
        self.registry.counter("lifecycle.node_restarts").inc()
        self.registry.counter("lifecycle.node_restarts", node=node_id).inc()

    # -- progress-log liveness machinery (local/progress_log.py) -------------
    def on_progress(self, kind: str, node: int,
                    store: Optional[int] = None) -> None:
        self.registry.counter(f"progress.{kind}").inc()
        self.registry.counter(f"progress.{kind}", node=node, store=store).inc()

    # -- pull collection (end of run / watchdog dump) ------------------------
    def collect_cluster(self, cluster) -> None:
        """Pull-collect cluster/stores state as gauges: simulator stats
        (message counts, fault injections), per-store size/diagnostic
        counters, and the device-resolver counters."""
        reg = self.registry
        for key, value in cluster.stats.items():
            reg.gauge(f"sim.{key}").set(value)
        sg = schema.STORE_GAUGE_METRICS   # names live in the unit-linted schema
        for node in cluster.nodes.values():
            for cs in node.command_stores.all_stores():
                reg.gauge(sg["commands"], node=node.id,
                          store=cs.id).set(len(cs.commands))
                reg.gauge(sg["cold"], node=node.id,
                          store=cs.id).set(len(cs.cold))
                reg.gauge(sg["exec_deferred"], node=node.id,
                          store=cs.id).set(len(cs.exec_deferred))
                reg.gauge(sg["cache_miss_loads"], node=node.id,
                          store=cs.id).set(cs.cache_miss_loads)
                reg.gauge(sg["tfk_inversions"], node=node.id,
                          store=cs.id).set(cs.tfk_inversions)
        device_metrics.collect_into(reg, cluster)
        samples: list = []
        for _node_id, _store_id, svc in device_metrics.cluster_services(cluster):
            samples.extend(svc.samples)
        samples.sort()
        self._service_samples = samples

    # -- rendering -----------------------------------------------------------
    def metrics_snapshot(self, cluster=None) -> dict:
        if cluster is not None:
            self.collect_cluster(cluster)
        return self.registry.snapshot()

    def registry_json(self, cluster=None) -> str:
        if cluster is not None:
            self.collect_cluster(cluster)
        return self.registry.to_json()

    def write_timeline(self, path: str) -> None:
        """Write the windowed-telemetry JSONL artifact (burn CLI
        ``--timeline-out``); requires a timeline attached at construction."""
        from .timeline import write_timeline_jsonl
        write_timeline_jsonl(path, self)

    def chrome_trace(self, profiler=None) -> dict:
        from .export import chrome_trace
        return chrome_trace(self, profiler=profiler)

    def write_trace(self, path: str, profiler=None) -> None:
        from .export import write_chrome_trace
        write_chrome_trace(path, self, profiler=profiler)

    def latency_budget(self, top_k: int = 6) -> dict:
        """Plane-1 critical-path latency budget over the recorded spans
        (observe/critical_path.py) — post-hoc analysis, no runtime cost."""
        from .critical_path import latency_budget
        return latency_budget(self, top_k=top_k)
