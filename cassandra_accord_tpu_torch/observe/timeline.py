"""Sim-time windowed telemetry: the TRAJECTORY plane of the observability
stack.

Every existing plane (registry snapshots, spans, critical-path budgets, the
auditor verdict) answers questions as WHOLE-RUN aggregates.  Scale questions
are trajectory questions — does ``commits_per_sec`` climb with concurrency or
flatline, does a 15-node elastic soak degrade minutes before the watchdog
fires, does device-service batch occupancy actually fill the windows that
amortize dispatch — so this module derives, from the very same flight-recorder
hook stream, fixed-width SIM-TIME windows in which

- **counters become per-window rates** (count + count/window-seconds),
- **gauges become samples** (last value observed inside the window),
- **value streams become per-window exact percentiles** (nearest-rank
  p50/p95/p99 over the raw values recorded in the window — EXACT, unlike the
  registry histogram's conservative bucket bounds, because a window holds few
  enough values to keep raw).

Windows are scoped exactly like the registry (``cluster`` / ``node/<id>`` /
``store/<node>/<store>``) and ring-bounded (``keep_windows``): a soak keeps
the recent trajectory — the windows INTO a stall — while memory stays flat.

Every metric's treatment is DECLARED in ``observe/schema.py``
(``TIMELINE_POLICIES``: ``rate | sample | percentile | excluded``), two-way
linted like ``METRIC_UNITS``, and enforced at feed time: feeding an
``excluded`` metric, or feeding with the wrong verb, raises.

Zero observer effect, by construction: the ``Timeline`` is plain host-side
bookkeeping fed sim-timestamps the instrumented code already computed — no
RNG, no wall clock, no scheduling.  ``tests/test_timeline.py`` proves it the
same way PR 3 proved the recorder: same-seed hostile burn, timelines on vs
off, byte-identical message traces.

Export surfaces: ``write_timeline_jsonl`` (the burn CLI's ``--timeline-out``
artifact — one JSON line per window plus consult-service trajectory windows
derived from the service's deterministic samples), Perfetto per-window
counter tracks (``observe/export.timeline_counter_events``), and the
watchdog's stall dump, which embeds the last-N windows — the trajectory into
the stall, not just the final snapshot.
"""
from __future__ import annotations

import json
import math
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import schema
from .registry import MetricsRegistry

DEFAULT_WINDOW_US = 1_000_000          # 1 sim-second
DEFAULT_KEEP_WINDOWS = 512             # ring bound (soaks keep the tail)
DEFAULT_VALUES_PER_WINDOW = 4096       # raw-value cap per (scope, metric)

# the outcome classes whose per-window rates sum to "commits per second"
COMMIT_OUTCOMES = schema.COMMIT_OUTCOMES


def exact_percentile(sorted_values: List[int], q: float) -> Optional[int]:
    """Nearest-rank percentile over an ALREADY-SORTED list (exact, unlike
    ``Histogram.snapshot_percentile``'s bucket upper bound): the smallest
    value with at least ``ceil(q * n)`` values at or below it."""
    n = len(sorted_values)
    if not n:
        return None
    rank = max(1, math.ceil(q * n))
    return sorted_values[min(rank, n) - 1]


class Timeline:
    """Fixed-width sim-time windows over the flight-recorder event stream."""

    __slots__ = ("window_us", "keep_windows", "values_per_window",
                 "_finalized", "dropped_windows", "_open_idx", "_counts",
                 "_samples", "_values", "_value_overflow", "_policy_memo")

    def __init__(self, window_us: int = DEFAULT_WINDOW_US,
                 keep_windows: int = DEFAULT_KEEP_WINDOWS,
                 values_per_window: int = DEFAULT_VALUES_PER_WINDOW):
        assert window_us > 0, "window width must be positive sim-micros"
        self.window_us = int(window_us)
        self.keep_windows = keep_windows
        self.values_per_window = values_per_window
        self._finalized: deque = deque()
        self.dropped_windows = 0
        self._open_idx: Optional[int] = None
        # open-window accumulators, keyed (scope, metric)
        self._counts: Dict[Tuple[str, str], int] = {}
        self._samples: Dict[Tuple[str, str], object] = {}
        self._values: Dict[Tuple[str, str], List[int]] = {}
        self._value_overflow: Dict[Tuple[str, str], int] = {}
        # metric -> policy, memoized (the schema lookup walks a prefix table)
        self._policy_memo: Dict[str, str] = {}

    # -- policy enforcement --------------------------------------------------
    def _policy(self, name: str) -> str:
        policy = self._policy_memo.get(name)
        if policy is None:
            policy = schema.timeline_policy_for(name)
            self._policy_memo[name] = policy
        return policy

    def _check(self, name: str, verb: str) -> None:
        policy = self._policy(name)
        if policy != verb:
            raise ValueError(
                f"metric {name!r} declares timeline policy {policy!r} but was "
                f"fed as {verb!r} (observe/schema.py TIMELINE_POLICIES is the "
                f"contract)")

    # -- feeding (called from FlightRecorder hooks) --------------------------
    def count(self, name: str, now_us: int, n: int = 1,
              node: Optional[int] = None, store: Optional[int] = None) -> None:
        self._check(name, "rate")
        self._roll(now_us)
        key = (MetricsRegistry.scope(node, store), name)
        self._counts[key] = self._counts.get(key, 0) + n

    def sample(self, name: str, value, now_us: int,
               node: Optional[int] = None, store: Optional[int] = None) -> None:
        self._check(name, "sample")
        self._roll(now_us)
        self._samples[(MetricsRegistry.scope(node, store), name)] = value

    def value(self, name: str, v: int, now_us: int,
              node: Optional[int] = None, store: Optional[int] = None) -> None:
        self._check(name, "percentile")
        self._roll(now_us)
        key = (MetricsRegistry.scope(node, store), name)
        values = self._values.get(key)
        if values is None:
            values = self._values[key] = []
        if len(values) >= self.values_per_window:
            self._value_overflow[key] = self._value_overflow.get(key, 0) + 1
            return
        values.append(v)

    # -- windowing -----------------------------------------------------------
    def _roll(self, now_us: int) -> None:
        idx = now_us // self.window_us
        if self._open_idx is None:
            self._open_idx = idx
            return
        if idx == self._open_idx:
            return
        # sim time is globally monotone; a lower index would mean a hook fed
        # a stale timestamp — fold it into the open window rather than
        # corrupting the ring with out-of-order records
        if idx < self._open_idx:
            return
        self._finalize_open()
        self._open_idx = idx   # gaps stay gaps: indices are explicit in the
        #                        records, so quiet sim-seconds cost nothing

    def _render_open(self) -> Optional[dict]:
        if self._open_idx is None:
            return None
        idx = self._open_idx
        window_s = self.window_us / 1e6
        scopes: Dict[str, dict] = {}
        for (scope, name), n in sorted(self._counts.items()):
            s = scopes.setdefault(scope, {})
            s.setdefault("counts", {})[name] = n
            s.setdefault("rates_per_s", {})[name] = round(n / window_s, 3)
        for (scope, name), v in sorted(self._samples.items()):
            scopes.setdefault(scope, {}).setdefault("samples", {})[name] = v
        for (scope, name), values in sorted(self._values.items()):
            vals = sorted(values)
            overflow = self._value_overflow.get((scope, name), 0)
            entry = {"count": len(vals) + overflow,
                     "p50": exact_percentile(vals, 0.50),
                     "p95": exact_percentile(vals, 0.95),
                     "p99": exact_percentile(vals, 0.99),
                     "min": vals[0] if vals else None,
                     "max": vals[-1] if vals else None}
            if overflow:
                entry["values_dropped"] = overflow
            scopes.setdefault(scope, {}).setdefault("percentiles", {})[name] \
                = entry
        return {"window": int(idx),
                "start_us": int(idx * self.window_us),
                "end_us": int((idx + 1) * self.window_us),
                "scopes": scopes}

    def _finalize_open(self) -> None:
        rec = self._render_open()
        if rec is None:
            return
        self._finalized.append(rec)
        if len(self._finalized) > self.keep_windows:
            self._finalized.popleft()
            self.dropped_windows += 1
        self._counts.clear()
        self._samples.clear()
        self._values.clear()
        self._value_overflow.clear()

    # -- reading -------------------------------------------------------------
    def records(self, include_open: bool = True) -> List[dict]:
        """Finalized window records, oldest first; ``include_open`` renders
        the currently-open window too (without mutating state — safe from a
        mid-run watchdog dump)."""
        out = list(self._finalized)
        if include_open:
            rec = self._render_open()
            if rec is not None:
                out.append(rec)
        return out

    def series(self, name: str, scope: str = "cluster",
               field: str = "rates_per_s") -> List[Tuple[int, object]]:
        """One metric's windowed series as [(window_index, value)] — the
        plotting/test accessor."""
        out = []
        for rec in self.records():
            value = rec["scopes"].get(scope, {}).get(field, {}).get(name)
            if value is not None:
                out.append((rec["window"], value))
        return out


def commits_per_sec_series(records: List[dict]) -> List[Tuple[int, float]]:
    """The windowed commits/s curve: the sum of per-window resolution rates
    over the commit outcome classes (fast + slow + recovered)."""
    names = [schema.OUTCOME_METRICS[o] for o in COMMIT_OUTCOMES]
    out = []
    for rec in records:
        rates = rec["scopes"].get("cluster", {}).get("rates_per_s", {})
        vals = [rates[n] for n in names if n in rates]
        if vals:
            out.append((rec["window"], round(sum(vals), 3)))
    return out


def service_window_records(recorder, window_us: int) -> List[dict]:
    """Consult-service trajectory windows derived POST-HOC from the
    deterministic (sim_ts, queue_depth, batch_rows) samples the recorder
    pull-collected out of every engaged DeviceConsultService — the
    queue-depth / batch-occupancy over-time series ROADMAP item 1's window
    tuning loop reads.  No runtime ingestion: samples are bucketed at export
    time, so the zero-observer-effect contract is untouched."""
    samples = getattr(recorder, "_service_samples", None)
    if not samples:
        return []
    by_window: Dict[int, List[Tuple[int, int]]] = {}
    for ts, depth, rows in samples:
        by_window.setdefault(ts // window_us, []).append((depth, rows))
    out = []
    for idx in sorted(by_window):
        entries = by_window[idx]
        depths = [d for d, _ in entries]
        rows = [r for _, r in entries]
        out.append({"kind": "service_window", "window": int(idx),
                    "start_us": int(idx * window_us),
                    "end_us": int((idx + 1) * window_us),
                    "dispatches": len(entries),
                    "queue_depth_max": max(depths),
                    "batch_rows_max": max(rows),
                    "batch_rows_mean": round(sum(rows) / len(rows), 2)})
    return out


def write_timeline_jsonl(path: str, recorder) -> None:
    """The ``--timeline-out`` artifact: a header line, one JSON line per
    telemetry window, then the consult-service trajectory windows.  JSONL so
    soak-length series stream through ``jq`` without loading whole."""
    timeline = getattr(recorder, "timeline", None)
    if timeline is None:
        raise ValueError("recorder has no timeline attached "
                         "(FlightRecorder(timeline=Timeline(...)))")
    records = timeline.records(include_open=True)
    with open(path, "w") as f:
        header = {"kind": "header", "schema": "accord-timeline/1",
                  "window_us": timeline.window_us,
                  "windows": len(records),
                  "windows_dropped": timeline.dropped_windows}
        f.write(json.dumps(header, sort_keys=True) + "\n")
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        for rec in service_window_records(recorder, timeline.window_us):
            f.write(json.dumps(rec, sort_keys=True) + "\n")
