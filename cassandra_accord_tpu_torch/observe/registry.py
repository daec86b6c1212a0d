"""Deterministic cluster metrics registry.

Counters, gauges and sim-time histograms with three scopes — cluster, per
node, per (node, store) — rendered as stable JSON (sorted keys, no floats
that depend on iteration order).  ``snapshot`` / ``delta`` / ``merge`` make
the registry diffable across runs and PRs the way the burn CLI's ``--json``
summaries are.

Everything here is plain host-side bookkeeping: no RNG, no wall clock, no
scheduling — the registry is safe to feed from inside the deterministic
simulation's hot paths (the zero-observer-effect contract, see
``observe/__init__``).
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Tuple


class Counter:
    """Monotonic integer count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-set value (pull-collected store/cluster state)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, value) -> None:
        self.value = value


# sim-time latency buckets (micros): 1ms .. 60s, exponential-ish
DEFAULT_BOUNDS_US = (1_000, 5_000, 10_000, 50_000, 100_000, 500_000,
                     1_000_000, 5_000_000, 10_000_000, 60_000_000)


class Histogram:
    """Fixed-bound histogram over simulated time (or any integer measure).

    The bounds are fixed at creation so snapshots of the same metric are
    always bucket-aligned and delta/merge are exact."""

    __slots__ = ("bounds", "counts", "count", "total")

    def __init__(self, bounds: Tuple[int, ...] = DEFAULT_BOUNDS_US):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)   # +1 = overflow bucket
        self.count = 0
        self.total = 0

    def record(self, value: int) -> None:
        self.record_many(value, 1)

    def record_many(self, value: int, n: int) -> None:
        """Record ``value`` n times in O(1) (bulk collectors: exact totals
        without a per-record loop)."""
        self.count += n
        self.total += value * n
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                self.counts[i] += n
                return
        self.counts[-1] += n

    def to_snapshot(self) -> dict:
        return {"count": self.count, "total": self.total,
                "bounds": list(self.bounds), "buckets": list(self.counts)}

    @staticmethod
    def snapshot_percentile(snapshot: dict, q: float) -> Optional[int]:
        """Conservative percentile estimate from a snapshot dict: the upper
        bound of the bucket containing the q-quantile (None when empty or
        when the quantile lands in the overflow bucket).  One formula for
        bench.py's SLO stages and the perf-gate reports."""
        total = snapshot["count"]
        if not total:
            return None
        need = q * total
        acc = 0
        bounds = snapshot["bounds"]
        for i, n in enumerate(snapshot["buckets"]):
            acc += n
            if acc >= need:
                return bounds[i] if i < len(bounds) else None
        return None

    def percentile(self, q: float) -> Optional[int]:
        return self.snapshot_percentile(self.to_snapshot(), q)


class MetricsRegistry:
    """One flat registry; metrics are addressed by (scope, name).

    Scope strings: ``"cluster"``, ``"node/<id>"``, ``"store/<node>/<store>"``
    — chosen so the rendered snapshot sorts stably and a store's metrics sit
    under its node's prefix."""

    __slots__ = ("_metrics",)

    def __init__(self):
        self._metrics: Dict[Tuple[str, str], object] = {}

    @staticmethod
    def scope(node: Optional[int] = None, store: Optional[int] = None) -> str:
        if node is None:
            return "cluster"
        if store is None:
            return f"node/{node}"
        return f"store/{node}/{store}"

    def _get(self, kind, name: str, node, store, **kw):
        key = (self.scope(node, store), name)
        metric = self._metrics.get(key)
        if metric is None:
            metric = kind(**kw)
            self._metrics[key] = metric
        elif not isinstance(metric, kind):
            raise TypeError(f"metric {key} already registered as "
                            f"{type(metric).__name__}, not {kind.__name__}")
        elif isinstance(metric, Histogram) \
                and metric.bounds != tuple(kw["bounds"]):
            # loud, at the second call site — a silent first-caller-wins
            # would dump every later value in the wrong buckets and only
            # surface as a far-away delta/merge ValueError
            raise ValueError(f"histogram {key} already registered with "
                             f"bounds {metric.bounds}, not {kw['bounds']}")
        return metric

    def counter(self, name: str, node: Optional[int] = None,
                store: Optional[int] = None) -> Counter:
        return self._get(Counter, name, node, store)

    def gauge(self, name: str, node: Optional[int] = None,
              store: Optional[int] = None) -> Gauge:
        return self._get(Gauge, name, node, store)

    def histogram(self, name: str, node: Optional[int] = None,
                  store: Optional[int] = None,
                  bounds: Tuple[int, ...] = DEFAULT_BOUNDS_US) -> Histogram:
        return self._get(Histogram, name, node, store, bounds=bounds)

    # -- rendering -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Nested plain-data snapshot: {scope: {name: value-or-hist-dict}}."""
        out: Dict[str, dict] = {}
        for (scope, name), metric in self._metrics.items():
            value = metric.to_snapshot() if isinstance(metric, Histogram) \
                else metric.value
            out.setdefault(scope, {})[name] = value
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True,
                          separators=(",", ":"))

    # -- snapshot algebra ----------------------------------------------------
    @staticmethod
    def _combine(a, b, sign: int):
        if isinstance(a, dict) or isinstance(b, dict):
            a = a if isinstance(a, dict) else \
                {"count": 0, "total": 0, "bounds": b["bounds"],
                 "buckets": [0] * len(b["buckets"])}
            b = b if isinstance(b, dict) else \
                {"count": 0, "total": 0, "bounds": a["bounds"],
                 "buckets": [0] * len(a["buckets"])}
            if a["bounds"] != b["bounds"]:
                raise ValueError("histogram bucket bounds differ")
            return {"count": a["count"] + sign * b["count"],
                    "total": a["total"] + sign * b["total"],
                    "bounds": list(a["bounds"]),
                    "buckets": [x + sign * y
                                for x, y in zip(a["buckets"], b["buckets"])]}
        return (a or 0) + sign * (b or 0)

    @classmethod
    def _fold(cls, a: dict, b: dict, sign: int) -> dict:
        out: Dict[str, dict] = {}
        for scope in sorted(set(a) | set(b)):
            sa, sb = a.get(scope, {}), b.get(scope, {})
            row = {}
            for name in sorted(set(sa) | set(sb)):
                row[name] = cls._combine(sa.get(name), sb.get(name), sign)
            out[scope] = row
        return out

    @classmethod
    def delta(cls, after: dict, before: dict) -> dict:
        """after - before, scope- and metric-wise (missing entries read 0)."""
        return cls._fold(after, before, -1)

    @classmethod
    def merge(cls, a: dict, b: dict) -> dict:
        """a + b (aggregating snapshots across seeds/runs)."""
        return cls._fold(a, b, +1)
