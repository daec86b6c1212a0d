"""Stall watchdog: turn silent liveness stalls into actionable artifacts.

When a burn stops resolving ops for ``stalled_after_s`` of sim-time, the
watchdog raises ``StallError`` carrying a full wait-state dump — per-node /
per-store status frontiers, every blocked txn with the dependency ids it is
waiting on, progress-log monitor sets, pending-bootstrap and stale ranges,
and the device execution frontier where a device resolver is attached.  This
is the diagnostic the PRE_APPLIED-backlog investigation (KNOWN_ISSUES) needs:
CI and seed-range sweeps get the wait graph instead of a bare ``timeout``
kill.
"""
from __future__ import annotations

from typing import Callable, List

from .cluster import Cluster

_MAX_BLOCKED_PER_STORE = 24   # dump bound; the stall root is always among the
                              # oldest blocked ids, listed first
_TIMELINE_DUMP_WINDOWS = 12   # last-N telemetry windows embedded in a stall
                              # dump: the trajectory INTO the stall


class StallError(Exception):
    """A burn stopped making progress; ``dump`` holds the wait-state report."""

    def __init__(self, message: str, dump: str):
        super().__init__(f"{message}\n{dump}")
        self.dump = dump


def dump_wait_state(cluster: Cluster) -> str:
    """Render the cluster's host/device wait graphs + per-node status
    frontier.  Names every blocked txn id and what it waits on."""
    from ..local.status import SaveStatus
    lines: List[str] = []
    stall_roots: List[tuple] = []   # (txn_id, node, store) slice anchors —
                                    # the oldest blocked txn per store
    stalled = sorted(n for n in cluster.nodes
                     if cluster.journal is not None
                     and cluster.journal.is_stalled(n))
    lines.append(f"sim_time_s={cluster.now_micros / 1e6:.3f} "
                 f"down_nodes={sorted(cluster.down)} "
                 f"paused_nodes={sorted(cluster.paused)} "
                 f"stalled_journals={stalled} "
                 f"epoch={cluster.topologies[-1].epoch}")
    for node_id in sorted(cluster.nodes):
        node = cluster.nodes[node_id]
        for store in node.command_stores.all_stores():
            counts: dict = {}
            blocked = []
            max_applied = None
            for txn_id, cmd in store.commands.items():
                counts[cmd.save_status.name] = counts.get(cmd.save_status.name, 0) + 1
                if cmd.save_status is SaveStatus.APPLIED and (
                        max_applied is None or txn_id > max_applied):
                    max_applied = txn_id
                if cmd.waiting_on is not None and cmd.waiting_on.is_waiting():
                    blocked.append((txn_id, cmd))
            lines.append(
                f"node {node_id} store {store.id}: frontier={counts} "
                f"max_applied={max_applied} cold={len(store.cold)} "
                f"pending_bootstrap={store.pending_bootstrap!r} "
                f"stale={cluster.stores[node_id].stale_ranges!r}")
            blocked.sort(key=lambda p: p[0])
            if blocked:
                stall_roots.append((blocked[0][0], node_id, store.id))
            for txn_id, cmd in blocked[:_MAX_BLOCKED_PER_STORE]:
                waits = sorted(cmd.waiting_on.waiting)
                lines.append(
                    f"  BLOCKED {txn_id} [{cmd.save_status.name}] "
                    f"waiting_on={waits[:12]}"
                    + (f" (+{len(waits) - 12} more)" if len(waits) > 12 else ""))
            if len(blocked) > _MAX_BLOCKED_PER_STORE:
                lines.append(f"  ... {len(blocked) - _MAX_BLOCKED_PER_STORE} "
                             f"more blocked txns")
            pl = store.progress_log
            if hasattr(pl, "coordinating"):
                lines.append(
                    f"  progress_log: coordinating={sorted(pl.coordinating)[:12]} "
                    f"blocking={sorted(pl.blocking)[:12]} "
                    f"non_home={len(pl.non_home)}")
            resolver = getattr(store.resolver, "tpu", store.resolver)
            frontier_ready = getattr(resolver, "frontier_ready", None)
            if frontier_ready is not None:
                try:
                    ready = sorted(frontier_ready())
                    lines.append(f"  device_frontier_ready={ready[:12]}"
                                 + (f" (+{len(ready) - 12} more)"
                                    if len(ready) > 12 else ""))
                except Exception as e:  # noqa: BLE001 — diagnostics must not mask the stall
                    lines.append(f"  device_frontier_ready=<error {e!r}>")
    observer = getattr(cluster, "observer", None)
    if observer is not None:
        # metrics snapshot section (flight recorder): the full registry —
        # message counts, lifecycle transitions, recovery attribution — in
        # the same artifact CI already captures for stalls
        try:
            lines.append("metrics: " + observer.registry_json(cluster))
        except Exception as e:  # noqa: BLE001 — diagnostics must not mask the stall
            lines.append(f"metrics: <error {e!r}>")
        # audit section (InvariantAuditor): the open liveness-SLO flags name
        # the exact txns a stall is stuck on — read this BEFORE the wait
        # graph; the flagged ids are usually the roots
        report = getattr(observer, "audit_report", None)
        if report is not None:
            try:
                lines.append("audit: " + report())
            except Exception as e:  # noqa: BLE001 — diagnostics must not mask the stall
                lines.append(f"audit: <error {e!r}>")
        # burn-rate section (observe/burnrate.py): a monitor that fired
        # mid-run DATED the degradation — its sim timestamps bound when the
        # wedge began, long before this dump's final state
        monitor = getattr(observer, "burnrate", None)
        if monitor is not None and monitor.events:
            import json as _json
            try:
                lines.append("slo_burn: " + _json.dumps(
                    monitor.events[-8:], sort_keys=True, default=str))
            except Exception as e:  # noqa: BLE001 — diagnostics must not mask the stall
                lines.append(f"slo_burn: <error {e!r}>")
        # timeline section (observe/timeline.py): the last-N telemetry
        # windows — windowed commits/s, latency percentiles, in-flight —
        # i.e. the TRAJECTORY into the stall, not just the end snapshot
        timeline = getattr(observer, "timeline", None)
        if timeline is not None:
            import json as _json
            try:
                recs = timeline.records(include_open=True)
                lines.append("timeline: " + _json.dumps(
                    recs[-_TIMELINE_DUMP_WINDOWS:], sort_keys=True,
                    default=str))
            except Exception as e:  # noqa: BLE001 — diagnostics must not mask the stall
                lines.append(f"timeline: <error {e!r}>")
        # provenance section (observe/provenance.py): the bounded backward
        # causal slice of each store's oldest blocked txn — how the wedge
        # was REACHED (handlers, timers, timeouts), not just what it waits on
        prov = getattr(observer, "provenance", None)
        if prov is not None:
            import json as _json
            try:
                slices = {}
                for txn_id, node_id, store_id in stall_roots[:4]:
                    sl = prov.slice_for(txn_id=txn_id, node=node_id,
                                        store=store_id)
                    if sl is not None:
                        slices[str(txn_id)] = sl
                lines.append("provenance: " + _json.dumps(
                    {"stall_root_slices": slices,
                     "tail": prov.tail_summary()}, sort_keys=True,
                    default=str))
            except Exception as e:  # noqa: BLE001 — diagnostics must not mask the stall
                lines.append(f"provenance: <error {e!r}>")
    return "\n".join(lines)


class StallWatchdog:
    """Recurring (sim-time) progress check over a monotonic counter."""

    def __init__(self, cluster: Cluster, progress_fn: Callable[[], int],
                 stalled_after_s: float = 120.0, interval_s: float = 5.0):
        self.cluster = cluster
        self.progress_fn = progress_fn
        self.stalled_after_s = stalled_after_s
        self.interval_s = interval_s
        self._last_progress = progress_fn()
        self._last_change_us = cluster.now_micros
        self._task = None

    def attach(self) -> None:
        self._task = self.cluster.scheduler.recurring(self.interval_s, self.check)

    def cancel(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def check(self) -> None:
        progress = self.progress_fn()
        now = self.cluster.now_micros
        if progress != self._last_progress:
            self._last_progress = progress
            self._last_change_us = now
            return
        stalled_s = (now - self._last_change_us) / 1e6
        if stalled_s >= self.stalled_after_s:
            raise StallError(
                f"no progress for {stalled_s:.1f}s of sim-time "
                f"(progress counter stuck at {progress})",
                dump_wait_state(self.cluster))
