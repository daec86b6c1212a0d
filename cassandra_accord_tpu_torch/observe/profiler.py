"""Plane 2 of the performance-observability layer: the WALL-CLOCK profiler.

Explicitly OUTSIDE the determinism contract: everything here measures host
time (``time.perf_counter``), which differs run to run and machine to
machine.  What it must never do is perturb the simulation — the profiler
reads wall clocks and appends to its own buffers, but touches no RNG, no
sim scheduling, and no message path, so a same-seed burn with the profiler
on vs off still yields a byte-identical recorder trace
(``tests/test_profiler.py::test_profiler_zero_observer_effect`` proves it
in-tree).  Wall-clock numbers also stay OUT of the deterministic metrics
registry: snapshots are diffed across same-seed runs and must not carry
always-differing floats.

Three measurement planes:

1. **Per-message-type handler CPU** (``local/node.py`` wraps
   ``request.process``): where the single-threaded event loop's compute
   goes, by wire message type — the 43-commits/s wall is a CPU budget and
   this names its line items.
2. **Event-loop occupancy + queue depth** (``harness/cluster.py`` run
   loops): busy fraction of the loop's wall time, per-task cost, and the
   pending-queue depth distribution — distinguishes "the loop is saturated"
   from "the loop is idle waiting on sim time".
3. **Device-service launch breakdown** (``device_service/service.py`` +
   ``impl/tpu_resolver.py``): per-launch dispatch RTT, host↔device
   transfer bytes, new-shape events (observed as new shape signatures),
   and per-launch wall-ms.

Handler slices are kept (bounded) with wall timestamps so the Perfetto
export can render wall-clock tracks and flow-link a txn's sim spans to the
host handler slices that served it (``observe/export.py``).

``span(name)`` names a stretch of the port's own work (``accord.*``: a
``txn_step`` and its phases, each host sync, the index refresh, a window's
dispatch and its parts) on the device trace's clock: while a
``torch.profiler`` session records, it is a ``record_function`` range, a
``user_annotation`` event on the same timeline as the kernels and copies;
otherwise it is one shared no-op context, so the untraced path pays a
guarded check and no profiler call.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from .critical_path import _percentile

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else the
    shared no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN

# handler slices kept for the Perfetto wall tracks (ring-bounded: a hostile
# seed emits hundreds of thousands of handler invocations)
DEFAULT_SLICE_CAP = 20_000
_QUEUE_SAMPLE_EVERY = 64          # queue-depth sample cadence (tasks)
_QUEUE_SAMPLE_CAP = 65_536


class _HandlerStat:
    __slots__ = ("count", "total_s", "max_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)


class WallProfiler:
    """One profiler per run; attach via ``run_burn(profiler=...)`` (or
    ``Cluster(profiler=...)``)."""

    def __init__(self, slice_cap: int = DEFAULT_SLICE_CAP):
        self.t0 = time.perf_counter()
        # -- plane 1: per-message-type handler CPU ---------------------------
        self.handlers: Dict[str, _HandlerStat] = {}
        # (type_name, node, txn_id_str|None, wall_t0_us, dur_us, sim_us)
        self.slices: List[tuple] = []
        self.slices_dropped = 0
        self._slice_cap = slice_cap
        # -- plane 2: event-loop occupancy + queue depth ---------------------
        self.tasks = 0
        self.busy_s = 0.0
        self.max_task_s = 0.0
        self.queue_depths: List[int] = []
        # -- plane 3: device-service launches --------------------------------
        self.launches = 0
        self.launch_wall_s = 0.0
        self.launch_max_s = 0.0
        self.launch_rows = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.compile_events = 0
        self.launch_ms: List[float] = []        # per-launch kernel wall ms
        self._launch_cap = 8192
        self.consult_wall_s = 0.0               # resolver _consult total

    # -- handler timing (Node._process_or_fail) ------------------------------
    def now(self) -> float:
        return time.perf_counter()

    def on_handler(self, node_id: int, type_name: str, txn_id,
                   t_start: float, sim_us: int) -> None:
        dt = time.perf_counter() - t_start
        stat = self.handlers.get(type_name)
        if stat is None:
            stat = self.handlers[type_name] = _HandlerStat()
        stat.add(dt)
        if len(self.slices) < self._slice_cap:
            wall_us = int((t_start - self.t0) * 1e6)
            self.slices.append((type_name, node_id,
                                str(txn_id) if txn_id is not None else None,
                                wall_us, max(int(dt * 1e6), 1), sim_us))
        else:
            self.slices_dropped += 1

    # -- event-loop sampling (Cluster.run_until / run_until_idle) ------------
    def on_task(self, dt_s: float, queue_depth: int) -> None:
        self.tasks += 1
        self.busy_s += dt_s
        if dt_s > self.max_task_s:
            self.max_task_s = dt_s
        if self.tasks % _QUEUE_SAMPLE_EVERY == 0 \
                and len(self.queue_depths) < _QUEUE_SAMPLE_CAP:
            self.queue_depths.append(queue_depth)

    # -- device-service launches (DeviceConsultService._dispatch) ------------
    def on_device_launch(self, rows: int, seconds: float, h2d_bytes: int,
                         d2h_bytes: int, compiled: bool) -> None:
        self.launches += 1
        self.launch_wall_s += seconds
        self.launch_max_s = max(self.launch_max_s, seconds)
        self.launch_rows += rows
        self.h2d_bytes += h2d_bytes
        self.d2h_bytes += d2h_bytes
        if compiled:
            self.compile_events += 1
        if len(self.launch_ms) < self._launch_cap:
            self.launch_ms.append(seconds * 1e3)

    # -- reporting ------------------------------------------------------------
    # exact nearest-rank percentile, shared with the plane-1 budget so both
    # planes of one report agree on quantile semantics
    _pct = staticmethod(_percentile)

    def collect_cluster(self, cluster) -> None:
        """Pull the resolver-side wall counters the run accumulated (the
        resolver's ``consult_wall_s`` — total wall time inside tier
        dispatch, whichever tier answered)."""
        total = 0.0
        for node in cluster.nodes.values():
            for store in node.command_stores.all_stores():
                r = getattr(store.resolver, "tpu", store.resolver)
                total += getattr(r, "consult_wall_s", 0.0)
        self.consult_wall_s = total

    def report(self, top_k: int = 12) -> dict:
        """Plain-data wall-clock report (JSON-serializable)."""
        wall_s = time.perf_counter() - self.t0
        handlers = {}
        ranked = sorted(self.handlers.items(),
                        key=lambda kv: (-kv[1].total_s, kv[0]))
        for name, st in ranked[:top_k]:
            handlers[name] = {
                "count": st.count,
                "total_s": round(st.total_s, 4),
                "mean_us": round(1e6 * st.total_s / st.count, 1),
                "max_us": round(1e6 * st.max_s, 1),
            }
        other = ranked[top_k:]
        if other:
            handlers["(other)"] = {
                "count": sum(st.count for _n, st in other),
                "total_s": round(sum(st.total_s for _n, st in other), 4),
                "mean_us": None, "max_us": None,
            }
        depths = sorted(self.queue_depths)
        kernel_ms = sorted(self.launch_ms)
        device = {
            "launches": self.launches,
            "launch_rows": self.launch_rows,
            "dispatch_wall_s": round(self.launch_wall_s, 4),
            "dispatch_mean_ms": round(1e3 * self.launch_wall_s
                                      / self.launches, 3)
            if self.launches else None,
            "dispatch_max_ms": round(1e3 * self.launch_max_s, 3),
            "kernel_ms_p50": round(self._pct(kernel_ms, 0.50), 3)
            if kernel_ms else None,
            "kernel_ms_p95": round(self._pct(kernel_ms, 0.95), 3)
            if kernel_ms else None,
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "compile_events": self.compile_events,
            "consult_wall_s": round(self.consult_wall_s, 4),
        }
        return {
            "time_plane": "wall_s",
            "wall_s": round(wall_s, 3),
            "handlers": handlers,
            "handler_total_s": round(sum(st.total_s
                                         for st in self.handlers.values()), 4),
            "handler_slices": len(self.slices),
            "handler_slices_dropped": self.slices_dropped,
            "scheduler": {
                "tasks": self.tasks,
                "busy_s": round(self.busy_s, 4),
                "occupancy": round(self.busy_s / wall_s, 4) if wall_s else None,
                "mean_task_us": round(1e6 * self.busy_s / self.tasks, 2)
                if self.tasks else None,
                "max_task_ms": round(1e3 * self.max_task_s, 3),
                "queue_depth": {
                    "samples": len(depths),
                    "p50": self._pct(depths, 0.50),
                    "p95": self._pct(depths, 0.95),
                    "max": depths[-1] if depths else None,
                },
            },
            "device": device,
        }


def format_wall_profile(report: dict, label: str = "") -> str:
    """Compact human rendering of ``WallProfiler.report()`` (burn CLI)."""
    sch = report["scheduler"]
    lines = [f"wall profile{': ' + label if label else ''} — "
             f"{report['wall_s']:.2f}s wall, {sch['tasks']} tasks, "
             f"occupancy {100.0 * (sch['occupancy'] or 0.0):.0f}%, "
             f"handler CPU {report['handler_total_s']:.2f}s"]
    lines.append(f"  {'handler':<34}{'count':>8}{'total_s':>9}{'mean_us':>9}")
    for name, row in report["handlers"].items():
        mean = f"{row['mean_us']:>9.1f}" if row["mean_us"] is not None \
            else f"{'':>9}"
        lines.append(f"  {name:<34}{row['count']:>8}{row['total_s']:>9.3f}"
                     f"{mean}")
    dev = report["device"]
    if dev["launches"]:
        lines.append(
            f"  device: {dev['launches']} launches, "
            f"{dev['dispatch_mean_ms']:.2f}ms mean RTT "
            f"(max {dev['dispatch_max_ms']:.2f}), "
            f"{dev['compile_events']} compiles, "
            f"h2d {dev['h2d_bytes']} B, d2h {dev['d2h_bytes']} B")
    elif dev["consult_wall_s"]:
        lines.append(f"  consult wall (host tiers): "
                     f"{dev['consult_wall_s']:.3f}s, no device launches")
    q = sch["queue_depth"]
    if q["samples"]:
        lines.append(f"  queue depth: p50 {q['p50']}, p95 {q['p95']}, "
                     f"max {q['max']} ({q['samples']} samples)")
    return "\n".join(lines)
