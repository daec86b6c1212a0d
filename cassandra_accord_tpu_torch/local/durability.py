"""GC bounds and durability watermarks.

Capability parity with ``accord.local`` RedundantBefore / DurableBefore / MaxConflicts
/ Cleanup (RedundantBefore.java:49-529, DurableBefore.java:39+, MaxConflicts.java:32,
Cleanup.java):

- ``RedundantBefore``: per-range bounds below which transactions are redundant —
  locally applied-or-invalidated (safe to stop tracking as dependencies locally),
  shard applied (a quorum of the shard applied them), plus bootstrap/staleness marks.
- ``DurableBefore``: per-range durability watermarks — majority (applied at a quorum)
  and universal (applied at every replica) — fed by the durability coordination rounds.
- ``MaxConflicts``: per-range max executeAt witnessed, consulted when proposing
  PreAccept timestamps.
- ``Cleanup``: the truncation decision lattice combining both.

All are piecewise-constant maps over the routing-key space
(``utils.interval_map.ReducingIntervalMap``).
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Optional, Tuple

from ..primitives.keys import Range, Ranges, RoutingKey
from ..primitives.timestamp import Timestamp, TxnId
from ..utils.interval_map import ReducingIntervalMap
from .status import Durability, SaveStatus, Status


def _max_ts(a: Optional[Timestamp], b: Optional[Timestamp]) -> Optional[Timestamp]:
    if a is None:
        return b
    if b is None:
        return a
    return a if a >= b else b


def _min_ts(a: Optional[Timestamp], b: Optional[Timestamp]) -> Optional[Timestamp]:
    if a is None or b is None:
        return None
    return a if a <= b else b


class RedundantEntry(NamedTuple):
    """Bounds for one range (RedundantBefore.Entry)."""
    locally_applied_before: Optional[TxnId] = None
    shard_applied_before: Optional[TxnId] = None
    bootstrapped_at: Optional[TxnId] = None
    stale_until_at_least: Optional[Timestamp] = None

    def merge(self, other: "RedundantEntry") -> "RedundantEntry":
        return RedundantEntry(
            _max_ts(self.locally_applied_before, other.locally_applied_before),
            _max_ts(self.shard_applied_before, other.shard_applied_before),
            _max_ts(self.bootstrapped_at, other.bootstrapped_at),
            _max_ts(self.stale_until_at_least, other.stale_until_at_least))

    def fence(self, local_only: bool = False) -> Optional[TxnId]:
        """Strongest fence txn of this entry; ``local_only`` restricts to bounds
        implying LOCAL application (locally-applied / bootstrap)."""
        out = _max_ts(self.locally_applied_before, self.bootstrapped_at)
        if not local_only:
            out = _max_ts(out, self.shard_applied_before)
        return out


class PreBootstrapOrStale(enum.Enum):
    """Classification of a txn vs bootstrap/staleness bounds
    (RedundantBefore.PreBootstrapOrStale)."""
    FULLY = "fully"
    PARTIALLY = "partially"
    POST_BOOTSTRAP = "post_bootstrap"


class RedundantBefore:
    """Range map of RedundantEntry (RedundantBefore.java)."""

    __slots__ = ("map",)

    EMPTY: "RedundantBefore"

    def __init__(self, map: Optional[ReducingIntervalMap] = None):
        self.map = map if map is not None else ReducingIntervalMap()

    @staticmethod
    def of(ranges: Ranges, **bounds) -> "RedundantBefore":
        entry = RedundantEntry(**bounds)
        pairs = [(r.start, r.end) for r in ranges]
        return RedundantBefore(ReducingIntervalMap.of_ranges(pairs, entry))

    def merge(self, other: "RedundantBefore") -> "RedundantBefore":
        return RedundantBefore(self.map.merge(other.map, lambda a, b: a.merge(b)))

    # -- queries -------------------------------------------------------------
    def entry(self, key: RoutingKey) -> Optional[RedundantEntry]:
        return self.map.get(key)

    def locally_redundant_before(self, key: RoutingKey) -> Optional[TxnId]:
        e = self.map.get(key)
        if e is None:
            return None
        # a txn pre-dating a bootstrap is redundant locally: its effects are
        # subsumed by the bootstrap snapshot (RedundantBefore.java bootstrappedAt)
        return _max_ts(e.locally_applied_before, e.bootstrapped_at)

    def shard_redundant_before(self, key: RoutingKey) -> Optional[TxnId]:
        e = self.map.get(key)
        return e.shard_applied_before if e is not None else None

    def is_locally_redundant(self, txn_id: TxnId, participants) -> bool:
        """True iff ``txn_id`` is below the locally-redundant bound at EVERY
        point of its footprint (it can be dropped as a dependency)."""
        entries = list(_entries_over(self.map, participants))
        if not entries:
            return False
        for e in entries:
            bound = None if e is None else \
                _max_ts(e.locally_applied_before, e.bootstrapped_at)
            if bound is None or not txn_id < bound:
                return False
        return True

    def max_locally_redundant_over(self, participants) -> Optional[TxnId]:
        """The HIGHEST locally-redundant bound anywhere on ``participants`` —
        a necessary condition filter: no txn at/above it can be cleanable
        (is_locally_redundant requires being below the bound EVERYWHERE)."""
        out: Optional[TxnId] = None
        for e in _entries_over(self.map, participants):
            if e is None:
                continue
            b = _max_ts(e.locally_applied_before, e.bootstrapped_at)
            out = _max_ts(out, b)
        return out

    def fence_before(self, key: RoutingKey) -> Optional[TxnId]:
        """The strongest fence txn covering ``key``: everything before it is
        implied-applied here (locally applied / bootstrap / shard-durable
        exclusive sync point).  Used to elide older deps from scans — the fence
        itself is contributed as the floor dependency (collectDeps)."""
        e = self.map.get(key)
        return e.fence() if e is not None else None

    def min_fence_over(self, rng: Range, local_only: bool = False) -> Optional[TxnId]:
        """The weakest fence over a whole range (None if any sub-interval has
        no fence): only txns below THIS may be elided from scans of the range.
        ``local_only``: consider only bounds implying LOCAL application
        (locally-applied / bootstrap) — required when DROPPING a dependency
        wait, since a shard-applied fence does not imply local apply."""
        fence: Optional[TxnId] = None
        for e in self.map.values_over(rng.start, rng.end):
            f = e.fence(local_only) if e is not None else None
            if f is None:
                return None
            fence = f if fence is None or f < fence else fence
        return fence

    def collect_deps(self, keys, ranges, add) -> None:
        """Contribute floor dependencies (RedundantBefore.collectDeps,
        RedundantBefore.java:183-192): for every participant with a fence bound,
        add the fence txn as a dependency — it transitively covers every elided
        transaction before it."""
        if keys is not None:
            for key in keys:
                rk = key.to_routing() if hasattr(key, "to_routing") else key
                fence = self.fence_before(rk)
                if fence is not None:
                    add(key, fence)
        if ranges is not None:
            from ..primitives.keys import Range as _Range
            for rng in ranges:
                # attribute each fence to ITS interval (clipped to the query),
                # never the whole query range: a fence recorded against foreign
                # ranges survives slicing at stores it can never apply on,
                # stranding their waiters forever.  Adjacent intervals with the
                # same fence coalesce — per-interval fragments would otherwise
                # balloon every deps set as the interval map refines
                plo = phi = pfence = None
                for lo, hi, e in self.map.items_over(rng.start, rng.end):
                    fence = e.fence() if e is not None else None
                    if fence is not None and fence == pfence and plo is not None \
                            and phi == lo:
                        phi = hi
                        continue
                    if pfence is not None and plo < phi:
                        add(_Range(plo, phi), pfence)
                    plo, phi, pfence = lo, hi, fence
                if pfence is not None and plo < phi:
                    add(_Range(plo, phi), pfence)

    def is_shard_redundant(self, txn_id: TxnId, participants) -> bool:
        """True iff ``txn_id`` is below the shard-applied bound at EVERY point
        of its footprint: a quorum applied it and everything before it, so late
        messages about it are safely dropped (erased-tombstone semantics)."""
        entries = list(_entries_over(self.map, participants))
        if not entries:
            return False
        for e in entries:
            bound = e.shard_applied_before if e is not None else None
            if bound is None or not txn_id < bound:
                return False
        return True

    def min_shard_redundant_before(self, participants) -> Optional[TxnId]:
        out = None
        first = True
        for e in _entries_over(self.map, participants):
            b = e.shard_applied_before if e is not None else None
            if first:
                out, first = b, False
            else:
                out = _min_ts(out, b)
        return out

    def max_shard_redundant_over(self, participants) -> Optional[TxnId]:
        """Highest shard-applied bound anywhere on the footprint (necessary-
        condition filter for is_shard_redundant, like
        max_locally_redundant_over)."""
        out = None
        for e in _entries_over(self.map, participants):
            if e is not None:
                out = _max_ts(out, e.shard_applied_before)
        return out

    def pre_bootstrap_or_stale(self, txn_id: TxnId, participants) -> PreBootstrapOrStale:
        """Is ``txn_id`` before a bootstrap (or staleness) bound on all / some /
        none of its footprint?"""
        pre = post = False
        for e in _entries_over(self.map, participants):
            bound = e.bootstrapped_at if e is not None else None
            stale = e.stale_until_at_least if e is not None else None
            is_pre = (bound is not None and txn_id < bound) or \
                     (stale is not None and txn_id.as_timestamp() < stale)
            pre, post = pre or is_pre, post or not is_pre
        if pre and not post:
            return PreBootstrapOrStale.FULLY
        if pre:
            return PreBootstrapOrStale.PARTIALLY
        return PreBootstrapOrStale.POST_BOOTSTRAP

    def __repr__(self):
        return f"RedundantBefore({self.map!r})"


RedundantBefore.EMPTY = RedundantBefore()


class DurableEntry(NamedTuple):
    """(majorityBefore, universalBefore) for one range (DurableBefore.Entry)."""
    majority_before: Optional[TxnId] = None
    universal_before: Optional[TxnId] = None

    def merge_max(self, other: "DurableEntry") -> "DurableEntry":
        return DurableEntry(_max_ts(self.majority_before, other.majority_before),
                            _max_ts(self.universal_before, other.universal_before))

    def merge_min(self, other: "DurableEntry") -> "DurableEntry":
        return DurableEntry(_min_ts(self.majority_before, other.majority_before),
                            _min_ts(self.universal_before, other.universal_before))


class DurableBefore:
    """Range map of DurableEntry (DurableBefore.java)."""

    __slots__ = ("map",)

    EMPTY: "DurableBefore"

    def __init__(self, map: Optional[ReducingIntervalMap] = None):
        self.map = map if map is not None else ReducingIntervalMap()

    @staticmethod
    def of(ranges: Ranges, majority_before: Optional[TxnId] = None,
           universal_before: Optional[TxnId] = None) -> "DurableBefore":
        entry = DurableEntry(majority_before, universal_before)
        pairs = [(r.start, r.end) for r in ranges]
        return DurableBefore(ReducingIntervalMap.of_ranges(pairs, entry))

    def merge(self, other: "DurableBefore") -> "DurableBefore":
        """Max-merge: combine knowledge (both maps' watermarks are true)."""
        return DurableBefore(self.map.merge(other.map, lambda a, b: a.merge_max(b)))

    def merge_min(self, other: "DurableBefore") -> "DurableBefore":
        """Min-merge: the watermark EVERY contributor agrees on — a range absent
        from either side is absent from the result (strict merge; an empty reply
        must NOT count as agreement, or watermarks would be falsely lifted to
        universal and enable premature erasure)."""
        return DurableBefore(self.map.merge(other.map, lambda a, b: a.merge_min(b),
                                            strict=True))

    def entry(self, key: RoutingKey) -> Optional[DurableEntry]:
        return self.map.get(key)

    def durability_of(self, txn_id: TxnId, key: RoutingKey) -> Durability:
        e = self.map.get(key)
        if e is None:
            return Durability.NOT_DURABLE
        if e.universal_before is not None and txn_id < e.universal_before:
            return Durability.UNIVERSAL
        if e.majority_before is not None and txn_id < e.majority_before:
            return Durability.MAJORITY
        return Durability.NOT_DURABLE

    def max_bounds_over(self, participants) -> Tuple[Optional[TxnId], Optional[TxnId]]:
        """(max majority, max universal) bound anywhere on the footprint —
        necessary-condition filters: no txn at/above the max can reach the
        corresponding cleanup tier (min_durability requires it everywhere)."""
        maj = uni = None
        for e in _entries_over(self.map, participants):
            if e is not None:
                maj = _max_ts(maj, e.majority_before)
                uni = _max_ts(uni, e.universal_before)
        return maj, uni

    def min_durability(self, txn_id: TxnId, participants) -> Durability:
        entries = list(_entries_over(self.map, participants))
        if not entries:
            return Durability.NOT_DURABLE
        out = None
        for e in entries:
            if e is None:
                return Durability.NOT_DURABLE
            if e.universal_before is not None and txn_id < e.universal_before:
                d = Durability.UNIVERSAL
            elif e.majority_before is not None and txn_id < e.majority_before:
                d = Durability.MAJORITY
            else:
                d = Durability.NOT_DURABLE
            out = d if out is None else min(out, d)
        return out if out is not None else Durability.NOT_DURABLE

    def __repr__(self):
        return f"DurableBefore({self.map!r})"


DurableBefore.EMPTY = DurableBefore()


class MaxConflicts:
    """Range map of max executeAt witnessed (MaxConflicts.java:32)."""

    __slots__ = ("map",)

    def __init__(self, map: Optional[ReducingIntervalMap] = None):
        self.map = map if map is not None else ReducingIntervalMap()

    def update(self, participants, ts: Timestamp) -> "MaxConflicts":
        pairs = _participant_pairs(participants)
        if not pairs:
            return self
        other = ReducingIntervalMap.of_ranges(pairs, ts)
        return MaxConflicts(self.map.merge(other, _max_ts))

    def get(self, participants) -> Optional[Timestamp]:
        out = None
        for v in _entries_over(self.map, participants):
            out = _max_ts(out, v)
        return out

    def __repr__(self):
        return f"MaxConflicts({self.map!r})"


class Cleanup(enum.Enum):
    """Truncation decision (Cleanup.java): what may be erased for an
    applied/invalidated txn given its redundancy + durability."""
    NO = "no"
    TRUNCATE_WITH_OUTCOME = "truncate_with_outcome"
    TRUNCATE = "truncate"
    ERASE = "erase"


def should_cleanup(command, redundant_before: RedundantBefore,
                   durable_before: DurableBefore) -> Cleanup:
    """Decide the strongest safe truncation for ``command``
    (Cleanup.shouldCleanup semantics, simplified to the three durability tiers)."""
    ss = command.save_status
    if ss.is_truncated or ss is SaveStatus.NOT_DEFINED:
        return Cleanup.NO
    # only applied or invalidated commands may be truncated
    if not (ss is SaveStatus.INVALIDATED or ss.has_been(Status.APPLIED)):
        return Cleanup.NO
    route = command.route
    if route is None:
        return Cleanup.NO
    participants = route.participants()
    if not redundant_before.is_locally_redundant(command.txn_id, participants):
        return Cleanup.NO
    if ss is SaveStatus.INVALIDATED:
        # no outcome to preserve: erase as soon as locally redundant
        return Cleanup.ERASE
    durability = durable_before.min_durability(command.txn_id, participants)
    if durability is Durability.UNIVERSAL:
        return Cleanup.ERASE
    if durability is Durability.MAJORITY:
        return Cleanup.TRUNCATE
    return Cleanup.TRUNCATE_WITH_OUTCOME


def _entries_over(map: ReducingIntervalMap, participants):
    """Every distinct map value a footprint touches: point lookups for keys,
    ``values_over`` sweeps for ranges."""
    if participants is None:
        return
    for item in participants:
        if isinstance(item, Range):
            yield from map.values_over(item.start, item.end)
        elif isinstance(item, RoutingKey):
            yield map.get(item)
        elif hasattr(item, "to_routing"):
            yield map.get(item.to_routing())
        else:
            # nested container, e.g. Deps.participants -> (RoutingKeys, Ranges)
            yield from _entries_over(map, item)


def _participant_pairs(participants):
    from ..primitives.keys import _Successor
    if participants is None:
        return ()
    if isinstance(participants, Ranges):
        return [(r.start, r.end) for r in participants]
    pairs = []
    for k in participants:
        rk = k if isinstance(k, RoutingKey) else k.to_routing()
        pairs.append((rk, _Successor(rk)))
    return pairs
