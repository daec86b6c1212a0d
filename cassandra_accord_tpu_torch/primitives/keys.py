"""Keys, ranges and their sorted-set algebra.

Capability parity with ``accord.primitives`` ``AbstractKeys``/``AbstractRanges``/
``Routables``/``Range`` (AbstractRanges.java:1-788, Routables.java:1-434,
Range.java:1-451): immutable sorted sets of keys/ranges supporting union,
intersection, slicing by ranges, and containment — the footprint algebra every phase of
the protocol runs on.  The reference supports four start/end inclusivity variants; here
ranges are uniformly half-open ``[start, end)`` (the variant Cassandra token ranges
reduce to), which simplifies the device-side interval tables without losing
expressiveness: an embedding can always map its own bounds onto half-open routing
tokens.

Keys are modelled as objects with a total order given by ``token()``; the concrete
``IntKey`` (prefix, value) mirrors the reference test harness's ``PrefixedIntHashKey``
prefix-sharded integer keys and is what the simulation harness and Maelstrom adapter
use.  ``SentinelKey`` provides per-prefix ±infinity bounds for full-prefix ranges.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

from ..utils.invariants import check_argument, check_state


class RoutingKey:
    """Base: totally ordered, hashable by ``token()``."""

    __slots__ = ()

    def token(self) -> tuple:
        raise NotImplementedError

    def __lt__(self, other: "RoutingKey") -> bool:
        return self.token() < other.token()

    def __le__(self, other: "RoutingKey") -> bool:
        return self.token() <= other.token()

    def __gt__(self, other: "RoutingKey") -> bool:
        return self.token() > other.token()

    def __ge__(self, other: "RoutingKey") -> bool:
        return self.token() >= other.token()

    def __eq__(self, other) -> bool:
        return isinstance(other, RoutingKey) and self.token() == other.token()

    def __hash__(self) -> int:
        return hash(self.token())

    def to_routing(self) -> "RoutingKey":
        """The routing projection of this key (identity for pure routing keys)."""
        return self


class Key(RoutingKey):
    """A seekable user key (storage-addressable). Subclasses add payload addressing."""

    __slots__ = ()


class IntKey(Key):
    """(prefix, value) integer key; prefix is the shard-space partition, matching the
    reference harness's PrefixedIntHashKey (BurnTest.java:278-286)."""

    __slots__ = ("prefix", "value", "_tk")

    def __init__(self, value: int, prefix: int = 0):
        self.prefix = prefix
        self.value = value
        # token tuple cache: ordering/hashing allocated a fresh tuple per
        # compare, millions of times per burn (wire decode leaves this None
        # — codec _SKIP_SLOTS — and it lazily rebuilds)
        self._tk = (prefix, 0, value)

    def token(self) -> tuple:
        tk = self._tk
        if tk is None:
            tk = self._tk = (self.prefix, 0, self.value)
        return tk

    def __repr__(self) -> str:
        return f"{self.prefix}:{self.value}" if self.prefix else f"k{self.value}"


class SentinelKey(RoutingKey):
    """Per-prefix -inf / +inf bound for constructing full-prefix ranges."""

    __slots__ = ("prefix", "is_max")

    def __init__(self, prefix: int, is_max: bool):
        self.prefix = prefix
        self.is_max = is_max

    def token(self) -> tuple:
        return (self.prefix, 1 if self.is_max else -1, 0)

    @staticmethod
    def min(prefix: int = 0) -> "SentinelKey":
        return SentinelKey(prefix, False)

    @staticmethod
    def max(prefix: int = 0) -> "SentinelKey":
        return SentinelKey(prefix, True)

    def __repr__(self) -> str:
        return f"{self.prefix}:{'+inf' if self.is_max else '-inf'}"


class Range:
    """Half-open key range [start, end)."""

    __slots__ = ("start", "end")

    def __init__(self, start: RoutingKey, end: RoutingKey):
        check_argument(start < end, "empty range %s..%s", start, end)
        self.start = start
        self.end = end

    @staticmethod
    def of(start: RoutingKey, end: RoutingKey) -> "Range":
        return Range(start, end)

    @staticmethod
    def full_prefix(prefix: int) -> "Range":
        return Range(SentinelKey.min(prefix), SentinelKey.max(prefix))

    def contains(self, key: RoutingKey) -> bool:
        return self.start <= key < self.end

    def contains_range(self, that: "Range") -> bool:
        return self.start <= that.start and that.end <= self.end

    def intersects(self, that: "Range") -> bool:
        return self.start < that.end and that.start < self.end

    def intersection(self, that: "Range") -> Optional["Range"]:
        s = self.start if self.start >= that.start else that.start
        e = self.end if self.end <= that.end else that.end
        return Range(s, e) if s < e else None

    def compare_key(self, key: RoutingKey) -> int:
        """-1 if range is entirely before key, 0 if contains, 1 if entirely after."""
        if self.end <= key:
            return -1
        if self.start > key:
            return 1
        return 0

    def _key(self) -> tuple:
        return (self.start.token(), self.end.token())

    def __lt__(self, other: "Range") -> bool:
        return self._key() < other._key()

    def __eq__(self, other) -> bool:
        return isinstance(other, Range) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"[{self.start},{self.end})"


class _SortedSet:
    """Shared machinery for Keys / RoutingKeys / Ranges wrappers."""

    __slots__ = ("_items",)

    def __init__(self, items: tuple):
        self._items = items

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator:
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __bool__(self) -> bool:
        return bool(self._items)

    def is_empty(self) -> bool:
        return not self._items

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self._items == other._items

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._items))


class AbstractKeys(_SortedSet):
    """Sorted, de-duplicated immutable set of keys (AbstractKeys.java semantics)."""

    __slots__ = ()

    @classmethod
    def of(cls, keys: Iterable[RoutingKey]):
        return cls(tuple(sorted(set(keys))))

    @classmethod
    def empty(cls):
        return cls(())

    def contains(self, key: RoutingKey) -> bool:
        i = bisect_left(self._items, key)
        return i < len(self._items) and self._items[i] == key

    def index_of(self, key: RoutingKey) -> int:
        """Index if present, else -(insertion_point)-1 (reference convention)."""
        i = bisect_left(self._items, key)
        if i < len(self._items) and self._items[i] == key:
            return i
        return -i - 1

    def union(self, that: "AbstractKeys") -> "AbstractKeys":
        if not that._items:
            return self
        if not self._items:
            return type(self)(that._items) if type(that) is not type(self) else that
        return type(self)(tuple(_merge_sorted_unique(self._items, that._items)))

    def intersecting(self, that) -> "AbstractKeys":
        """Keys of self that fall in ``that`` (Keys or Ranges)."""
        if isinstance(that, Ranges):
            return self.slice(that)
        out = [k for k in self._items if that.contains(k)]
        return type(self)(tuple(out))

    def without(self, that) -> "AbstractKeys":
        return type(self)(tuple(k for k in self._items if not that.contains(k)))

    def slice(self, ranges: "Ranges") -> "AbstractKeys":
        """Subset of keys covered by ranges — O(|ranges| * log |keys|)."""
        out: List[RoutingKey] = []
        for r in ranges:
            lo = bisect_left(self._items, r.start)
            hi = bisect_left(self._items, r.end)
            out.extend(self._items[lo:hi])
        return type(self)(tuple(out))

    def intersects(self, that) -> bool:
        if isinstance(that, Ranges):
            return any(not self._empty_slice(r) for r in that)
        i = j = 0
        a, b = self._items, that._items
        while i < len(a) and j < len(b):
            if a[i] == b[j]:
                return True
            if a[i] < b[j]:
                i += 1
            else:
                j += 1
        return False

    def _empty_slice(self, r: Range) -> bool:
        lo = bisect_left(self._items, r.start)
        return lo >= len(self._items) or not r.contains(self._items[lo])

    def foldl(self, fn, accumulate):
        acc = accumulate
        for k in self._items:
            acc = fn(k, acc)
        return acc

    def to_ranges(self) -> "Ranges":
        """Minimal covering Ranges: one unit range per key (key..key-successor).
        Since keys are tokens, use [k, k'] half-open via a zero-width successor trick:
        represent as [k, next) where next sorts immediately after k."""
        return Ranges.of(*[Range(k, _Successor(k)) for k in self._items])

    def __repr__(self) -> str:
        return "{" + ",".join(map(repr, self._items)) + "}"


class _Successor(RoutingKey):
    """A routing key sorting immediately after its base (used for key→range lift)."""

    __slots__ = ("base",)

    def __init__(self, base: RoutingKey):
        self.base = base

    def token(self) -> tuple:
        return self.base.token() + (1,)

    def __repr__(self) -> str:
        return f"{self.base}^"


class Keys(AbstractKeys):
    """Seekable key set (a txn's data footprint)."""

    __slots__ = ()

    def to_routing_keys(self) -> "RoutingKeys":
        return RoutingKeys.of(k.to_routing() for k in self._items)


class RoutingKeys(AbstractKeys):
    """Unseekable routing-key set (a txn's routing footprint)."""

    __slots__ = ()


class Ranges(_SortedSet):
    """Sorted, de-overlapped immutable set of ranges (AbstractRanges semantics)."""

    __slots__ = ()

    @classmethod
    def of(cls, *ranges: Range) -> "Ranges":
        return cls(_normalize_ranges(ranges))

    @classmethod
    def of_list(cls, ranges: Sequence[Range]) -> "Ranges":
        return cls(_normalize_ranges(ranges))

    EMPTY: "Ranges"

    @classmethod
    def empty(cls) -> "Ranges":
        return cls(())

    # -- queries ------------------------------------------------------------
    def contains(self, key: RoutingKey) -> bool:
        return self._index_containing(key) >= 0

    def _index_containing(self, key: RoutingKey) -> int:
        lo, hi = 0, len(self._items) - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            c = self._items[mid].compare_key(key)
            if c == 0:
                return mid
            if c < 0:
                lo = mid + 1
            else:
                hi = mid - 1
        return -1

    def contains_all(self, that) -> bool:
        if isinstance(that, Ranges):
            return all(self._covers(r) for r in that)
        return all(self.contains(k) for k in that)

    def _covers(self, r: Range) -> bool:
        # because ranges are coalesced, r is covered iff one range contains it
        for mine in self._items:
            if mine.contains_range(r):
                return True
            if mine.start >= r.end:
                break
        return False

    def intersects(self, that) -> bool:
        if isinstance(that, Ranges):
            i = j = 0
            while i < len(self._items) and j < len(that._items):
                a, b = self._items[i], that._items[j]
                if a.intersects(b):
                    return True
                if a.end <= b.start:
                    i += 1
                else:
                    j += 1
            return False
        if isinstance(that, Range):
            return any(r.intersects(that) for r in self._items)
        return any(self.contains(k) for k in that)

    # -- algebra ------------------------------------------------------------
    def union(self, that: "Ranges") -> "Ranges":
        if not that._items:
            return self
        if not self._items:
            return that
        return Ranges(_normalize_ranges(self._items + that._items))

    def intersection(self, that: "Ranges") -> "Ranges":
        out: List[Range] = []
        i = j = 0
        while i < len(self._items) and j < len(that._items):
            a, b = self._items[i], that._items[j]
            x = a.intersection(b)
            if x is not None:
                out.append(x)
            if a.end <= b.end:
                i += 1
            else:
                j += 1
        return Ranges(tuple(out))

    def without(self, that: "Ranges") -> "Ranges":
        """Set difference self \\ that."""
        out: List[Range] = []
        for r in self._items:
            pieces = [r]
            for b in that._items:
                nxt: List[Range] = []
                for p in pieces:
                    if not p.intersects(b):
                        nxt.append(p)
                        continue
                    if p.start < b.start:
                        nxt.append(Range(p.start, b.start))
                    if b.end < p.end:
                        nxt.append(Range(b.end, p.end))
                pieces = nxt
            out.extend(pieces)
        return Ranges(_normalize_ranges(out))

    def slice(self, covering: "Ranges") -> "Ranges":
        return self.intersection(covering)

    def __repr__(self) -> str:
        return "{" + ",".join(map(repr, self._items)) + "}"


Ranges.EMPTY = Ranges(())


def _merge_sorted_unique(a: Sequence, b: Sequence) -> Iterator:
    i = j = 0
    while i < len(a) and j < len(b):
        if a[i] == b[j]:
            yield a[i]
            i += 1
            j += 1
        elif a[i] < b[j]:
            yield a[i]
            i += 1
        else:
            yield b[j]
            j += 1
    yield from a[i:]
    yield from b[j:]


def _normalize_ranges(ranges: Sequence[Range]) -> tuple:
    """Sort and coalesce overlapping/adjacent ranges."""
    if not ranges:
        return ()
    rs = sorted(ranges)
    out: List[Range] = [rs[0]]
    for r in rs[1:]:
        last = out[-1]
        if r.start <= last.end:
            if r.end > last.end:
                out[-1] = Range(last.start, r.end)
        else:
            out.append(r)
    return tuple(out)
