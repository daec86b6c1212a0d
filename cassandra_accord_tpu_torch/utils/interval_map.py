"""Mergeable piecewise-constant interval maps.

Capability parity with ``accord.utils.ReducingIntervalMap``/``ReducingRangeMap``
(ReducingIntervalMap.java:1-594, ReducingRangeMap.java:1-443): a value per half-open
interval of the routing-key space, with pointwise merge (via a user reduce function),
lookup, and folds over Keys/Ranges.  Base structure of ``RedundantBefore``,
``DurableBefore`` and ``MaxConflicts`` in ``local``.

Representation: ``bounds = [b0, b1, ..., bn-1]`` strictly increasing routing keys and
``values = [v0, v1, ..., vn]`` with ``len(values) == len(bounds)+1``; value ``v_i``
applies to keys in ``[b_{i-1}, b_i)`` (v0 below b0, vn at/above bn-1).  None values mean
"absent" and merge as the identity.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Any, Callable, Generic, List, Optional, Sequence, Tuple, TypeVar

V = TypeVar("V")


class ReducingIntervalMap(Generic[V]):
    __slots__ = ("bounds", "values")

    def __init__(self, bounds: Sequence = (), values: Sequence = (None,)):
        if len(values) != len(bounds) + 1:
            raise ValueError("values must have len(bounds)+1 entries")
        self.bounds: Tuple = tuple(bounds)
        self.values: Tuple = tuple(values)

    # -- construction -------------------------------------------------------
    @staticmethod
    def constant(value: Optional[V]) -> "ReducingIntervalMap[V]":
        return ReducingIntervalMap((), (value,))

    @staticmethod
    def of_range(start, end, value: V, outer: Optional[V] = None) -> "ReducingIntervalMap[V]":
        """value on [start, end), ``outer`` elsewhere."""
        if not start < end:
            raise ValueError(f"empty range [{start}, {end})")
        return ReducingIntervalMap((start, end), (outer, value, outer))

    @staticmethod
    def of_ranges(ranges, value: V, outer: Optional[V] = None) -> "ReducingIntervalMap[V]":
        """value on each half-open (start, end) pair in ``ranges`` (non-overlapping,
        sorted), ``outer`` elsewhere."""
        bounds, values = [], [outer]
        for start, end in ranges:
            if bounds and bounds[-1] == start:
                bounds.append(end)
                values[-1] = value
                values.append(outer)
            else:
                bounds.append(start)
                values.append(value)
                bounds.append(end)
                values.append(outer)
        return ReducingIntervalMap(bounds, values)

    # -- lookup -------------------------------------------------------------
    def get(self, key) -> Optional[V]:
        i = bisect_right(self.bounds, key)
        return self.values[i]

    def map_values(self, fn: Callable[[V], Any]) -> "ReducingIntervalMap":
        """New map with ``fn`` applied to every non-None value."""
        return ReducingIntervalMap(
            self.bounds, tuple(None if v is None else fn(v) for v in self.values))

    def values_over(self, start, end) -> List[Optional[V]]:
        """Every distinct value the map takes over [start, end)."""
        i = bisect_right(self.bounds, start)
        out = [self.values[i]]
        while i < len(self.bounds) and self.bounds[i] < end:
            out.append(self.values[i + 1])
            i += 1
        return out

    def items_over(self, start, end) -> List[Tuple[Any, Any, Optional[V]]]:
        """(lo, hi, value) per map interval intersecting [start, end), clipped
        to the query bounds — callers that attribute a value to "its" interval
        must use THIS, not values_over, or they smear the value across the whole
        query range."""
        out: List[Tuple[Any, Any, Optional[V]]] = []
        i = bisect_right(self.bounds, start)
        lo = start
        while True:
            hi = self.bounds[i] if i < len(self.bounds) else None
            seg_end = end if hi is None or hi > end else hi
            out.append((lo, seg_end, self.values[i]))
            if hi is None or hi >= end:
                break
            lo = hi
            i += 1
        return out

    def is_empty(self) -> bool:
        return all(v is None for v in self.values)

    # -- merge --------------------------------------------------------------
    def merge(self, other: "ReducingIntervalMap[V]",
              reduce: Callable[[V, V], V],
              strict: bool = False) -> "ReducingIntervalMap[V]":
        """Pointwise merge; where both maps have a value, combine with ``reduce``.
        Default: None (absent) merges as the identity — the other side wins.
        ``strict``: None annihilates — an interval absent from EITHER map is
        absent from the result (for min-style agreement merges)."""
        if strict:
            def combine(a, b):
                if a is None or b is None:
                    return None
                return reduce(a, b)
        else:
            def combine(a, b):
                if a is None:
                    return b
                if b is None:
                    return a
                return reduce(a, b)

        bounds: List = sorted(set(self.bounds) | set(other.bounds))
        values: List = []
        # value for interval below bounds[0], between each pair, and above the last
        probes = []
        if not bounds:
            return ReducingIntervalMap((), (combine(self.values[0], other.values[0]),))
        # representative probe per interval: for interval i ending at bounds[i] use the
        # bound itself is exclusive, so probe must be < bounds[i]; use bisect on bound
        for i in range(len(bounds) + 1):
            if i == 0:
                lo_bound = None
            else:
                lo_bound = bounds[i - 1]
            # interval is [lo_bound, bounds[i]) — any key >= lo_bound and < next bound;
            # we can evaluate each source map by index arithmetic instead of probing.
            a = self._value_for_interval(lo_bound)
            b = other._value_for_interval(lo_bound)
            values.append(combine(a, b))
        # compact equal-adjacent intervals
        cb: List = []
        cv: List = [values[0]]
        for i, b in enumerate(bounds):
            if values[i + 1] == cv[-1]:
                continue
            cb.append(b)
            cv.append(values[i + 1])
        return ReducingIntervalMap(cb, cv)

    def _value_for_interval(self, lo_bound) -> Optional[V]:
        """Value applying to keys in the interval starting at ``lo_bound`` (None = -inf)."""
        if lo_bound is None:
            return self.values[0]
        i = bisect_right(self.bounds, lo_bound)
        return self.values[i]

    # -- folds --------------------------------------------------------------
    def foldl_keys(self, keys, fn: Callable[[V, Any, Any], Any], accumulate):
        """fold fn(value, key, acc) over keys that land on non-None values."""
        acc = accumulate
        for k in keys:
            v = self.get(k)
            if v is not None:
                acc = fn(v, k, acc)
        return acc

    def foldl_intervals(self, fn: Callable[[Optional[V], Any, Any, Any], Any], accumulate):
        """fold fn(value, start, end, acc) over every interval (start/end may be None
        at the extremes)."""
        acc = accumulate
        prev = None
        for i, v in enumerate(self.values):
            end = self.bounds[i] if i < len(self.bounds) else None
            acc = fn(v, prev, end, acc)
            prev = end
        return acc

    def __eq__(self, other):
        return (isinstance(other, ReducingIntervalMap)
                and self.bounds == other.bounds and self.values == other.values)

    def __repr__(self):
        parts = []
        prev = "-inf"
        for i, v in enumerate(self.values):
            end = self.bounds[i] if i < len(self.bounds) else "+inf"
            if v is not None:
                parts.append(f"[{prev},{end})={v!r}")
            prev = end
        return "IntervalMap{" + ", ".join(parts) + "}"
