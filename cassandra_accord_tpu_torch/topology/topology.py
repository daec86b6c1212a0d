"""Epoch-versioned shard maps and quorum math.

Capability parity with ``accord.topology.Shard/Topology/Topologies``
(Shard.java:38-90, Topology.java:61-272, Topologies.java:1-485):

- ``Shard``: a key range + its replica list + the fast-path electorate + joining set,
  with the Accord quorum sizes: f = (n-1)//2 tolerated failures, slow-path quorum
  n - f (simple majority), fast-path quorum (f+e)//2 + 1 over an electorate of size e,
  recovery fast-path size (f+1)//2.
- ``Topology``: one epoch's sorted, non-overlapping shard array with per-node subset
  views and selection/trim operations.
- ``Topologies``: a multi-epoch stack spanning [txnId.epoch, executeAt.epoch] used to
  address coordination messages across concurrent epochs.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, FrozenSet, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

from ..primitives.keys import Range, Ranges, RoutingKey
from ..primitives.route import Route
from ..utils.invariants import check_argument, check_state


def max_tolerated_failures(replicas: int) -> int:
    return (replicas - 1) // 2


def slow_path_quorum_size(replicas: int) -> int:
    return replicas - max_tolerated_failures(replicas)


def fast_path_quorum_size(replicas: int, electorate: int, f: int) -> int:
    check_argument(electorate >= replicas - f, "electorate too small")
    return (f + electorate) // 2 + 1


class Shard:
    __slots__ = ("range", "nodes", "fast_path_electorate", "joining",
                 "max_failures", "recovery_fast_path_size",
                 "fast_path_quorum_size", "slow_path_quorum_size")

    def __init__(self, range_: Range, nodes: Sequence[int],
                 fast_path_electorate: Optional[Iterable[int]] = None,
                 joining: Optional[Iterable[int]] = None):
        self.range = range_
        self.nodes: Tuple[int, ...] = tuple(sorted(nodes))
        electorate = frozenset(fast_path_electorate) if fast_path_electorate is not None \
            else frozenset(self.nodes)
        self.fast_path_electorate: FrozenSet[int] = electorate
        self.joining: FrozenSet[int] = frozenset(joining or ())
        check_argument(self.joining.issubset(self.nodes),
                       "joining nodes must also be present in nodes")
        n = len(self.nodes)
        f = max_tolerated_failures(n)
        self.max_failures = f
        self.recovery_fast_path_size = (f + 1) // 2
        self.slow_path_quorum_size = slow_path_quorum_size(n)
        self.fast_path_quorum_size = fast_path_quorum_size(n, len(electorate), f)

    def rf(self) -> int:
        return len(self.nodes)

    def contains(self, key: RoutingKey) -> bool:
        return self.range.contains(key)

    def contains_node(self, node: int) -> bool:
        return node in self.nodes

    def rejects_fast_path(self, reject_count: int) -> bool:
        """Enough electorate rejections that fast path can no longer be reached."""
        return reject_count > len(self.fast_path_electorate) - self.fast_path_quorum_size

    def __eq__(self, other) -> bool:
        return (isinstance(other, Shard) and self.range == other.range
                and self.nodes == other.nodes
                and self.fast_path_electorate == other.fast_path_electorate
                and self.joining == other.joining)

    def __hash__(self):
        return hash((self.range, self.nodes))

    def __repr__(self) -> str:
        return f"Shard({self.range!r}, n={list(self.nodes)}, fp={sorted(self.fast_path_electorate)})"


class Topology:
    """One epoch's shard map. Shards sorted by range start; ranges non-overlapping."""

    __slots__ = ("epoch", "shards", "_starts", "_node_ids")

    def __init__(self, epoch: int, shards: Sequence[Shard]):
        self.epoch = epoch
        self.shards: Tuple[Shard, ...] = tuple(sorted(shards, key=lambda s: s.range))
        for a, b in zip(self.shards, self.shards[1:]):
            check_argument(not a.range.intersects(b.range),
                           "shard ranges overlap: %s %s", a.range, b.range)
        self._starts = [s.range.start for s in self.shards]
        ids: Set[int] = set()
        for s in self.shards:
            ids.update(s.nodes)
        self._node_ids = frozenset(ids)

    EMPTY: "Topology"

    @property
    def size(self) -> int:
        return len(self.shards)

    def nodes(self) -> FrozenSet[int]:
        return self._node_ids

    def contains_node(self, node: int) -> bool:
        return node in self._node_ids

    def ranges(self) -> Ranges:
        return Ranges.of(*[s.range for s in self.shards])

    # -- lookup -------------------------------------------------------------
    def for_key(self, key: RoutingKey) -> Optional[Shard]:
        i = bisect_right(self._starts, key) - 1
        if i >= 0 and self.shards[i].range.contains(key):
            return self.shards[i]
        return None

    def for_key_required(self, key: RoutingKey) -> Shard:
        s = self.for_key(key)
        check_state(s is not None, "no shard for key %s in epoch %s" % (key, self.epoch))
        return s

    def for_selection(self, unseekables) -> List[Shard]:
        """Shards intersecting a RoutingKeys/Ranges/Route selection."""
        if isinstance(unseekables, Route):
            unseekables = unseekables.participants()
        out: List[Shard] = []
        if isinstance(unseekables, Ranges):
            for s in self.shards:
                if unseekables.intersects(s.range):
                    out.append(s)
        else:
            for s in self.shards:
                if any(s.range.contains(k) for k in unseekables):
                    out.append(s)
        return out

    def for_node(self, node: int) -> "Topology":
        return Topology(self.epoch, [s for s in self.shards if s.contains_node(node)])

    def trim(self, unseekables) -> "Topology":
        """Subset topology containing only shards intersecting the selection
        (Topology.forSelection/trim semantics)."""
        if unseekables is None:
            return self
        return Topology(self.epoch, self.for_selection(unseekables))

    def ranges_for_node(self, node: int) -> Ranges:
        return Ranges.of(*[s.range for s in self.shards if s.contains_node(node)])

    def nodes_for(self, unseekables) -> List[int]:
        ids: Set[int] = set()
        for s in self.for_selection(unseekables):
            ids.update(s.nodes)
        return sorted(ids)

    def __eq__(self, other) -> bool:
        return isinstance(other, Topology) and self.epoch == other.epoch and self.shards == other.shards

    def __hash__(self):
        return hash((self.epoch, self.shards))

    def __repr__(self) -> str:
        return f"Topology(e{self.epoch}, {list(self.shards)!r})"


Topology.EMPTY = Topology(0, [])


class Topologies:
    """Multi-epoch stack, newest first (Topologies.java semantics)."""

    __slots__ = ("topologies",)

    def __init__(self, topologies: Sequence[Topology]):
        check_argument(len(topologies) > 0, "empty Topologies")
        ts = sorted(topologies, key=lambda t: -t.epoch)
        for a, b in zip(ts, ts[1:]):
            check_argument(a.epoch == b.epoch + 1, "non-contiguous epochs")
        self.topologies: Tuple[Topology, ...] = tuple(ts)

    @property
    def current_epoch(self) -> int:
        return self.topologies[0].epoch

    @property
    def oldest_epoch(self) -> int:
        return self.topologies[-1].epoch

    def current(self) -> Topology:
        return self.topologies[0]

    def for_epoch(self, epoch: int) -> Topology:
        i = self.current_epoch - epoch
        check_argument(0 <= i < len(self.topologies), "epoch %s not in %s", epoch, self)
        return self.topologies[i]

    def contains_epoch(self, epoch: int) -> bool:
        return self.oldest_epoch <= epoch <= self.current_epoch

    def for_epochs(self, min_epoch: int, max_epoch: int) -> "Topologies":
        return Topologies([t for t in self.topologies if min_epoch <= t.epoch <= max_epoch])

    def size(self) -> int:
        return len(self.topologies)

    def nodes(self) -> FrozenSet[int]:
        ids: Set[int] = set()
        for t in self.topologies:
            ids.update(t.nodes())
        return frozenset(ids)

    def nodes_for(self, unseekables) -> List[int]:
        ids: Set[int] = set()
        for t in self.topologies:
            ids.update(t.nodes_for(unseekables))
        return sorted(ids)

    def __iter__(self) -> Iterator[Topology]:
        return iter(self.topologies)

    def __repr__(self) -> str:
        return f"Topologies({[t.epoch for t in self.topologies]})"
