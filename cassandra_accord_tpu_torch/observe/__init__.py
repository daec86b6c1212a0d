"""Observability layer: deterministic metrics registry, txn lifecycle spans,
and the flight recorder (Chrome-trace export).

Design invariant — ZERO OBSERVER EFFECT: every hook in this package is a
passive, synchronous function call fed values the instrumented code already
computed (sim-timestamps, txn ids, status names).  No hook may

- allocate ids from any shared RNG (spans key on the txn's own id),
- read the wall clock (all timestamps are simulated micros handed in),
- schedule tasks, send messages, or otherwise alter the event loop.

``tests/test_observe.py::test_zero_observer_effect_hostile`` proves the
invariant in-tree: a same-seed hostile burn with the flight recorder on vs
off yields byte-identical full message traces (``harness.trace.diff_traces``)
and identical final-state outcome counters.
"""
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .spans import TxnSpan, TxnSpanRecorder
from .flight import FlightRecorder
from .audit import AuditViolation, InvariantAuditor
from .export import chrome_trace, validate_chrome_trace, write_chrome_trace
from .critical_path import (SEGMENT_CLASSES, extract_critical_paths,
                            format_budget, latency_budget)
from .profiler import WallProfiler, format_wall_profile
from .timeline import (Timeline, commits_per_sec_series, exact_percentile,
                       write_timeline_jsonl)
from .burnrate import BurnRateMonitor, SloSpec
from .history import HistoryOp, HistoryRecorder
from .checker import HistoryAnomaly, check_history, format_report
from .provenance import (ProvenanceRecorder, explain_divergence,
                         render_slice)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "TxnSpan", "TxnSpanRecorder", "FlightRecorder",
    "AuditViolation", "InvariantAuditor",
    "chrome_trace", "validate_chrome_trace", "write_chrome_trace",
    "SEGMENT_CLASSES", "extract_critical_paths", "format_budget",
    "latency_budget",
    "WallProfiler", "format_wall_profile",
    "Timeline", "commits_per_sec_series", "exact_percentile",
    "write_timeline_jsonl",
    "BurnRateMonitor", "SloSpec",
    "HistoryOp", "HistoryRecorder",
    "HistoryAnomaly", "check_history", "format_report",
    "ProvenanceRecorder", "explain_divergence", "render_slice",
]
