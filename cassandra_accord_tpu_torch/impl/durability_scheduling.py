"""Background durability scheduling.

Capability parity with ``accord.impl.CoordinateDurabilityScheduling``
(CoordinateDurabilityScheduling.java:78-350): each node periodically rotates a
``CoordinateShardDurable`` round over successive sub-ranges of the ranges it
replicates (completing a full cycle every ``shard_cycle_time``), and — staggered by
node index so nodes take turns — runs ``CoordinateGloballyDurable`` every
``global_cycle_time``.  Together these advance every replica's DurableBefore /
RedundantBefore watermarks, enabling truncation GC cluster-wide.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional

from ..coordinate.durability import (coordinate_globally_durable,
                                     coordinate_shard_durable)
from ..primitives.keys import Range, Ranges

if TYPE_CHECKING:
    from ..local.node import Node


class CoordinateDurabilityScheduling:
    """One per node; start() registers recurring tasks on the node scheduler."""

    def __init__(self, node: "Node", shard_cycle_time_s: float = 30.0,
                 global_cycle_time_s: float = 60.0, splits_per_range: int = 1):
        self.node = node
        self.shard_cycle_time_s = shard_cycle_time_s
        self.global_cycle_time_s = global_cycle_time_s
        self.splits_per_range = max(1, splits_per_range)
        self._cursor = 0
        self._in_flight = False
        self._scheduled: List = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        step = self._shard_step_interval_s()
        self._scheduled.append(
            self.node.scheduler.recurring(step, self._shard_round))
        # stagger global rounds by node index so nodes take turns
        # (CoordinateDurabilityScheduling.java:57-78)
        topology = self.node.topology.current()
        nodes = sorted(topology.nodes()) if topology is not None else [self.node.id]
        idx = nodes.index(self.node.id) if self.node.id in nodes else 0
        offset = (idx / max(1, len(nodes))) * self.global_cycle_time_s
        self._scheduled.append(self.node.scheduler.once(
            offset, lambda: self._scheduled.append(self.node.scheduler.recurring(
                self.global_cycle_time_s, self._global_round))))

    def stop(self) -> None:
        for s in self._scheduled:
            try:
                s.cancel()
            except Exception:  # noqa: BLE001
                pass
        self._scheduled.clear()

    # -- rounds --------------------------------------------------------------
    def _sub_ranges(self) -> List[Ranges]:
        """The rotation: each of this node's replicated ranges, split into
        ``splits_per_range`` slices."""
        topology = self.node.topology.current()
        if topology is None:
            return []
        my = topology.ranges_for_node(self.node.id)
        out: List[Ranges] = []
        for rng in my:
            for piece in _split(rng, self.splits_per_range):
                out.append(Ranges.of(piece))
        return out

    def _shard_step_interval_s(self) -> float:
        n = max(1, len(self._sub_ranges()))
        return max(0.05, self.shard_cycle_time_s / n)

    def _shard_round(self) -> None:
        if self._in_flight:
            return  # previous round still running; keep the cadence, skip
        subs = self._sub_ranges()
        if not subs:
            return
        ranges = subs[self._cursor % len(subs)]
        self._cursor += 1
        self._in_flight = True

        def done(_v, _f):
            self._in_flight = False

        coordinate_shard_durable(self.node, ranges).add_listener(done)

    def _global_round(self) -> None:
        coordinate_globally_durable(self.node).add_listener(lambda _v, _f: None)


def _split(rng: Range, pieces: int) -> List[Range]:
    """Split a range into up to ``pieces`` sub-ranges when the key type supports
    interpolation (IntKey-style ``value``); otherwise return it whole
    (ShardDistributor.EvenSplit delegates to a pluggable Splitter the same way)."""
    if pieces <= 1:
        return [rng]
    start, end = rng.start, rng.end
    sv = getattr(start, "value", None)
    ev = getattr(end, "value", None)
    if sv is None or ev is None or not isinstance(sv, int) or not isinstance(ev, int) \
            or ev - sv < pieces \
            or getattr(start, "prefix", 0) != getattr(end, "prefix", 0):
        return [rng]
    out = []
    width = (ev - sv) // pieces
    cls = type(start)
    prefix = getattr(start, "prefix", 0)
    for i in range(pieces):
        s = sv + i * width
        e = ev if i == pieces - 1 else s + width
        out.append(Range(cls(s, prefix), cls(e, prefix)))
    return out
