"""Dependency sets: the CSR key<->txn and range<->txn multimaps.

Capability parity with ``accord.primitives.KeyDeps/RangeDeps/Deps``
(KeyDeps.java:150-439, RangeDeps.java:74-85, Deps.java:59-120) and their underlying
``RelationMultiMap`` engine (RelationMultiMap.java:40-1108).  The reference stores a
CSR (compressed sparse row) bidirectional multimap in primitive int arrays; we keep the
same layout in numpy int32 arrays — deliberately, because these offsets+indices arrays
ARE the host<->device interchange format: a KeyDeps can be shipped to the TPU data
plane (ops.deps_kernels) without reshaping.

Semantics preserved:
- keys and txn_ids are sorted & de-duplicated; per-key postings lists are sorted
  txn-index lists;
- ``invert()`` lazily builds the txn->keys view;
- ``merge`` is an n-way linear union (LinearMerger semantics);
- ``slice(ranges)`` restricts to keys covered by ranges, dropping unreferenced txns;
- ``without`` filters txn ids (used when removing redundant/committed deps).
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..utils.invariants import check_argument, check_state
from .keys import Key, Keys, Range, Ranges, RoutingKey, RoutingKeys
from .timestamp import Timestamp, TxnId

_EMPTY_I32 = np.zeros(0, dtype=np.int32)


class KeyDeps:
    """CSR bidirectional multimap RoutingKey <-> TxnId."""

    __slots__ = ("keys", "txn_ids", "offsets", "indices", "_inverted")

    def __init__(self, keys: RoutingKeys, txn_ids: Tuple[TxnId, ...],
                 offsets: np.ndarray, indices: np.ndarray):
        self.keys = keys
        self.txn_ids = txn_ids
        self.offsets = offsets      # int32[len(keys)+1]
        self.indices = indices      # int32[nnz] — indexes into txn_ids
        self._inverted: Optional[Tuple[np.ndarray, np.ndarray]] = None

    # -- construction -------------------------------------------------------
    NONE: "KeyDeps"

    @staticmethod
    def of(mapping: Dict[RoutingKey, Iterable[TxnId]]) -> "KeyDeps":
        b = KeyDepsBuilder()
        for k, tids in mapping.items():
            for t in tids:
                b.add(k, t)
        return b.build()

    # -- size / membership --------------------------------------------------
    def is_empty(self) -> bool:
        return len(self.txn_ids) == 0

    def txn_id_count(self) -> int:
        return len(self.txn_ids)

    def key_count(self) -> int:
        return len(self.keys)

    def contains(self, txn_id: TxnId) -> bool:
        i = bisect_left(self.txn_ids, txn_id)
        return i < len(self.txn_ids) and self.txn_ids[i] == txn_id

    def max_txn_id(self) -> Optional[TxnId]:
        return self.txn_ids[-1] if self.txn_ids else None

    # -- per-key access -----------------------------------------------------
    def txn_ids_for(self, key: RoutingKey) -> List[TxnId]:
        ki = self.keys.index_of(key)
        if ki < 0:
            return []
        lo, hi = int(self.offsets[ki]), int(self.offsets[ki + 1])
        return [self.txn_ids[int(i)] for i in self.indices[lo:hi]]

    def for_each_key(self, fn: Callable[[RoutingKey, List[TxnId]], None]) -> None:
        for ki, k in enumerate(self.keys):
            lo, hi = int(self.offsets[ki]), int(self.offsets[ki + 1])
            fn(k, [self.txn_ids[int(i)] for i in self.indices[lo:hi]])

    # -- per-txn access (lazy inversion, KeyDeps.invert semantics) ----------
    def _invert(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._inverted is None:
            nnz = len(self.indices)
            counts = np.zeros(len(self.txn_ids) + 1, dtype=np.int32)
            for i in self.indices:
                counts[int(i) + 1] += 1
            t_offsets = np.cumsum(counts, dtype=np.int32)
            t_indices = np.zeros(nnz, dtype=np.int32)
            cursor = t_offsets[:-1].copy()
            for ki in range(len(self.keys)):
                for p in range(int(self.offsets[ki]), int(self.offsets[ki + 1])):
                    t = int(self.indices[p])
                    t_indices[cursor[t]] = ki
                    cursor[t] += 1
            self._inverted = (t_offsets, t_indices)
        return self._inverted

    def participants(self, txn_id: TxnId) -> RoutingKeys:
        ti = bisect_left(self.txn_ids, txn_id)
        if ti >= len(self.txn_ids) or self.txn_ids[ti] != txn_id:
            return RoutingKeys.empty()
        t_offsets, t_indices = self._invert()
        lo, hi = int(t_offsets[ti]), int(t_offsets[ti + 1])
        return RoutingKeys(tuple(self.keys[int(ki)] for ki in t_indices[lo:hi]))

    def for_each_unique_txn_id(self, fn: Callable[[TxnId], None]) -> None:
        for t in self.txn_ids:
            fn(t)

    # -- algebra ------------------------------------------------------------
    def slice(self, ranges: Ranges) -> "KeyDeps":
        keep = [ki for ki, k in enumerate(self.keys) if ranges.contains(k)]
        if len(keep) == len(self.keys):
            return self
        return self._select_keys(keep)

    def intersecting(self, keys_or_ranges) -> "KeyDeps":
        if isinstance(keys_or_ranges, Ranges):
            return self.slice(keys_or_ranges)
        keep = [ki for ki, k in enumerate(self.keys) if keys_or_ranges.contains(k)]
        return self._select_keys(keep)

    def _select_keys(self, keep: List[int]) -> "KeyDeps":
        if not keep:
            return KeyDeps.NONE
        new_keys = RoutingKeys(tuple(self.keys[ki] for ki in keep))
        # gather postings, remap txn indices to the referenced subset
        referenced: Set[int] = set()
        postings: List[np.ndarray] = []
        for ki in keep:
            seg = self.indices[int(self.offsets[ki]):int(self.offsets[ki + 1])]
            postings.append(seg)
            referenced.update(int(i) for i in seg)
        old_order = sorted(referenced)
        remap = {old: new for new, old in enumerate(old_order)}
        new_txn_ids = tuple(self.txn_ids[i] for i in old_order)
        offsets = np.zeros(len(keep) + 1, dtype=np.int32)
        chunks: List[np.ndarray] = []
        for i, seg in enumerate(postings):
            offsets[i + 1] = offsets[i] + len(seg)
            chunks.append(np.array([remap[int(x)] for x in seg], dtype=np.int32))
        indices = np.concatenate(chunks) if chunks else _EMPTY_I32
        return KeyDeps(new_keys, new_txn_ids, offsets, indices)

    def without(self, predicate: Callable[[TxnId], bool]) -> "KeyDeps":
        """Remove txn ids matching predicate."""
        drop = {i for i, t in enumerate(self.txn_ids) if predicate(t)}
        if not drop:
            return self
        keep_t = [i for i in range(len(self.txn_ids)) if i not in drop]
        remap = {old: new for new, old in enumerate(keep_t)}
        new_txn_ids = tuple(self.txn_ids[i] for i in keep_t)
        new_key_idx: List[int] = []
        offsets = [0]
        indices: List[int] = []
        for ki in range(len(self.keys)):
            seg = [remap[int(i)] for i in
                   self.indices[int(self.offsets[ki]):int(self.offsets[ki + 1])]
                   if int(i) not in drop]
            if seg:
                new_key_idx.append(ki)
                indices.extend(seg)
                offsets.append(len(indices))
        new_keys = RoutingKeys(tuple(self.keys[ki] for ki in new_key_idx))
        return KeyDeps(new_keys, new_txn_ids,
                       np.array(offsets, dtype=np.int32),
                       np.array(indices, dtype=np.int32) if indices else _EMPTY_I32)

    @staticmethod
    def merge(many: Sequence["KeyDeps"]) -> "KeyDeps":
        many = [m for m in many if m is not None and not m.is_empty()]
        if not many:
            return KeyDeps.NONE
        if len(many) == 1:
            return many[0]
        b = KeyDepsBuilder()
        for m in many:
            for ki, k in enumerate(m.keys):
                lo, hi = int(m.offsets[ki]), int(m.offsets[ki + 1])
                for i in m.indices[lo:hi]:
                    b.add(k, m.txn_ids[int(i)])
        return b.build()

    def with_merged(self, other: "KeyDeps") -> "KeyDeps":
        return KeyDeps.merge([self, other])

    # -- equality -----------------------------------------------------------
    def __eq__(self, other) -> bool:
        return (isinstance(other, KeyDeps)
                and self.keys == other.keys
                and self.txn_ids == other.txn_ids
                and np.array_equal(self.offsets, other.offsets)
                and np.array_equal(self.indices, other.indices))

    def __hash__(self):
        return hash((self.keys, self.txn_ids))

    def __repr__(self) -> str:
        parts = []
        for ki, k in enumerate(self.keys):
            lo, hi = int(self.offsets[ki]), int(self.offsets[ki + 1])
            tids = ",".join(repr(self.txn_ids[int(i)]) for i in self.indices[lo:hi])
            parts.append(f"{k}:[{tids}]")
        return "KeyDeps{" + ", ".join(parts) + "}"


KeyDeps.NONE = KeyDeps(RoutingKeys.empty(), (), np.zeros(1, dtype=np.int32), _EMPTY_I32)


class KeyDepsBuilder:
    __slots__ = ("_map",)

    def __init__(self):
        self._map: Dict[RoutingKey, Set[TxnId]] = {}

    def add(self, key: RoutingKey, txn_id: TxnId) -> "KeyDepsBuilder":
        self._map.setdefault(key, set()).add(txn_id)
        return self

    def is_empty(self) -> bool:
        return not self._map

    def build(self) -> KeyDeps:
        if not self._map:
            return KeyDeps.NONE
        keys = RoutingKeys.of(self._map.keys())
        all_tids = sorted({t for s in self._map.values() for t in s})
        tid_index = {t: i for i, t in enumerate(all_tids)}
        offsets = np.zeros(len(keys) + 1, dtype=np.int32)
        indices: List[int] = []
        for i, k in enumerate(keys):
            seg = sorted(self._map[k])
            indices.extend(tid_index[t] for t in seg)
            offsets[i + 1] = len(indices)
        return KeyDeps(keys, tuple(all_tids),
                       offsets, np.array(indices, dtype=np.int32) if indices else _EMPTY_I32)


class RangeDeps:
    """CSR bidirectional multimap Range <-> TxnId with stabbing queries.

    Parity: RangeDeps.java:74-85 — its SearchableRangeList
    (CheckpointIntervalArrayBuilder.java:33-1133) is realised here as a
    sorted-start + prefix-max-end interval index: a stab at ``key`` binary
    searches the candidates with ``start <= key`` and walks back only until
    the running max end drops to ``key`` — the checkpoint that makes stabbing
    sub-linear instead of a full scan (the TPU overlap-join kernel in ``ops``
    remains the fast path for BATCHED queries)."""

    __slots__ = ("ranges", "txn_ids", "offsets", "indices", "_by_txn",
                 "_starts", "_max_end")

    def __init__(self, ranges: Tuple[Range, ...], txn_ids: Tuple[TxnId, ...],
                 offsets: np.ndarray, indices: np.ndarray):
        self.ranges = ranges        # sorted by (start, end); may overlap each other
        self.txn_ids = txn_ids
        self.offsets = offsets
        self.indices = indices
        self._by_txn = None         # lazy inversion (participants)
        self._starts = None         # lazy interval index (starts list)
        self._max_end = None        # prefix max of range ends

    def _interval_index(self):
        if self._starts is None:
            self._starts = [r.start for r in self.ranges]
            best = None
            max_end = []
            for r in self.ranges:
                best = r.end if best is None or r.end > best else best
                max_end.append(best)
            self._max_end = max_end
        return self._starts, self._max_end

    def _stab(self, key) -> Set[int]:
        """Range positions whose half-open interval contains ``key``."""
        starts, max_end = self._interval_index()
        out: Set[int] = set()
        i = bisect_right(starts, key) - 1
        while i >= 0:
            if not key < max_end[i]:
                break                       # nothing earlier can reach key
            if self.ranges[i].contains(key):
                out.add(i)
            i -= 1
        return out

    def _overlaps(self, target: "Range") -> Set[int]:
        """Range positions intersecting ``target``."""
        starts, max_end = self._interval_index()
        out: Set[int] = set()
        i = bisect_left(starts, target.end) - 1
        while i >= 0:
            if not target.start < max_end[i]:
                break
            if self.ranges[i].intersects(target):
                out.add(i)
            i -= 1
        return out

    NONE: "RangeDeps"

    @staticmethod
    def of(mapping: Dict[Range, Iterable[TxnId]]) -> "RangeDeps":
        b = RangeDepsBuilder()
        for r, tids in mapping.items():
            for t in tids:
                b.add(r, t)
        return b.build()

    def is_empty(self) -> bool:
        return len(self.txn_ids) == 0

    def txn_id_count(self) -> int:
        return len(self.txn_ids)

    def contains(self, txn_id: TxnId) -> bool:
        i = bisect_left(self.txn_ids, txn_id)
        return i < len(self.txn_ids) and self.txn_ids[i] == txn_id

    # -- stabbing queries (via the interval index) ---------------------------
    def for_each_intersecting_key(self, key: RoutingKey, fn: Callable[[TxnId], None]) -> None:
        seen: Set[int] = set()
        for ri in sorted(self._stab(key)):
            for i in self.indices[int(self.offsets[ri]):int(self.offsets[ri + 1])]:
                if int(i) not in seen:
                    seen.add(int(i))
                    fn(self.txn_ids[int(i)])

    def intersecting_txn_ids(self, target) -> List[TxnId]:
        """TxnIds whose range intersects target (a Range, Ranges, or key)."""
        if isinstance(target, Range):
            hits = self._overlaps(target)
        elif isinstance(target, Ranges):
            hits: Set[int] = set()
            for rng in target:
                hits |= self._overlaps(rng)
        else:  # key
            hits = self._stab(target)
        out: Set[int] = set()
        for ri in hits:
            out.update(int(i) for i in
                       self.indices[int(self.offsets[ri]):int(self.offsets[ri + 1])])
        return sorted(self.txn_ids[i] for i in out)

    def participants(self, txn_id: TxnId) -> Ranges:
        ti = bisect_left(self.txn_ids, txn_id)
        if ti >= len(self.txn_ids) or self.txn_ids[ti] != txn_id:
            return Ranges.EMPTY
        if self._by_txn is None:
            # one-pass lazy inversion (KeyDeps.invert semantics): per-call
            # linear scans are quadratic across a WaitingOn initialise
            m: Dict[int, List[Range]] = {}
            for ri, r in enumerate(self.ranges):
                for i in self.indices[int(self.offsets[ri]):int(self.offsets[ri + 1])]:
                    m.setdefault(int(i), []).append(r)
            self._by_txn = {i: Ranges.of(*rs) for i, rs in m.items()}
        return self._by_txn.get(ti, Ranges.EMPTY)

    # -- algebra ------------------------------------------------------------
    def slice(self, covering: Ranges) -> "RangeDeps":
        if self.is_empty():
            return self
        b = RangeDepsBuilder()
        for ri, r in enumerate(self.ranges):
            for c in covering:
                x = r.intersection(c)
                if x is not None:
                    for i in self.indices[int(self.offsets[ri]):int(self.offsets[ri + 1])]:
                        b.add(x, self.txn_ids[int(i)])
        return b.build()

    def without(self, predicate: Callable[[TxnId], bool]) -> "RangeDeps":
        if self.is_empty():
            return self
        b = RangeDepsBuilder()
        for ri, r in enumerate(self.ranges):
            for i in self.indices[int(self.offsets[ri]):int(self.offsets[ri + 1])]:
                t = self.txn_ids[int(i)]
                if not predicate(t):
                    b.add(r, t)
        return b.build()

    @staticmethod
    def merge(many: Sequence["RangeDeps"]) -> "RangeDeps":
        many = [m for m in many if m is not None and not m.is_empty()]
        if not many:
            return RangeDeps.NONE
        if len(many) == 1:
            return many[0]
        b = RangeDepsBuilder()
        for m in many:
            for ri, r in enumerate(m.ranges):
                for i in m.indices[int(m.offsets[ri]):int(m.offsets[ri + 1])]:
                    b.add(r, m.txn_ids[int(i)])
        return b.build()

    def __eq__(self, other) -> bool:
        return (isinstance(other, RangeDeps)
                and self.ranges == other.ranges
                and self.txn_ids == other.txn_ids
                and np.array_equal(self.offsets, other.offsets)
                and np.array_equal(self.indices, other.indices))

    def __hash__(self):
        return hash((self.ranges, self.txn_ids))

    def __repr__(self) -> str:
        parts = []
        for ri, r in enumerate(self.ranges):
            tids = ",".join(repr(self.txn_ids[int(i)]) for i in
                            self.indices[int(self.offsets[ri]):int(self.offsets[ri + 1])])
            parts.append(f"{r}:[{tids}]")
        return "RangeDeps{" + ", ".join(parts) + "}"


RangeDeps.NONE = RangeDeps((), (), np.zeros(1, dtype=np.int32), _EMPTY_I32)


class RangeDepsBuilder:
    __slots__ = ("_map",)

    def __init__(self):
        self._map: Dict[Range, Set[TxnId]] = {}

    def add(self, rng: Range, txn_id: TxnId) -> "RangeDepsBuilder":
        self._map.setdefault(rng, set()).add(txn_id)
        return self

    def is_empty(self) -> bool:
        return not self._map

    def build(self) -> RangeDeps:
        if not self._map:
            return RangeDeps.NONE
        ranges = tuple(sorted(self._map.keys()))
        all_tids = sorted({t for s in self._map.values() for t in s})
        tid_index = {t: i for i, t in enumerate(all_tids)}
        offsets = np.zeros(len(ranges) + 1, dtype=np.int32)
        indices: List[int] = []
        for i, r in enumerate(ranges):
            seg = sorted(self._map[r])
            indices.extend(tid_index[t] for t in seg)
            offsets[i + 1] = len(indices)
        return RangeDeps(ranges, tuple(all_tids), offsets,
                         np.array(indices, dtype=np.int32) if indices else _EMPTY_I32)


class Deps:
    """Triple of key deps (CFK-managed), range deps, and direct key deps (key txns
    whose execution CommandsForKey does NOT manage, e.g. key sync points)
    — Deps.java:59-120."""

    __slots__ = ("key_deps", "range_deps", "direct_key_deps", "_memo")

    def __init__(self, key_deps: KeyDeps = None, range_deps: RangeDeps = None,
                 direct_key_deps: KeyDeps = None):
        self.key_deps = key_deps if key_deps is not None else KeyDeps.NONE
        self.range_deps = range_deps if range_deps is not None else RangeDeps.NONE
        self.direct_key_deps = direct_key_deps if direct_key_deps is not None else KeyDeps.NONE
        # lazy derived-answer cache (never on the wire — codec _SKIP_SLOTS):
        # Deps is immutable after construction, and the hot protocol scans
        # (WaitingOn init, recovery evidence, the auditor) re-ask txn_ids()
        # and participants() for the same object repeatedly — the re-derived
        # sorted unions were a measured slice of per-commit wall cost.
        # Cached values are shared: CALLERS MUST NOT MUTATE them.
        self._memo = None

    NONE: "Deps"

    def is_empty(self) -> bool:
        return (self.key_deps.is_empty() and self.range_deps.is_empty()
                and self.direct_key_deps.is_empty())

    def txn_id_count(self) -> int:
        return len(self.txn_ids())

    def txn_ids(self) -> List[TxnId]:
        memo = self._memo
        if memo is None:
            memo = self._memo = {}
        cached = memo.get("txn_ids")
        if cached is None:
            out: Set[TxnId] = set(self.key_deps.txn_ids)
            out.update(self.range_deps.txn_ids)
            out.update(self.direct_key_deps.txn_ids)
            cached = memo["txn_ids"] = sorted(out)
        return cached

    def contains(self, txn_id: TxnId) -> bool:
        return (self.key_deps.contains(txn_id) or self.range_deps.contains(txn_id)
                or self.direct_key_deps.contains(txn_id))

    def max_txn_id(self) -> Optional[TxnId]:
        tids = self.txn_ids()
        return tids[-1] if tids else None

    def participants(self, txn_id: TxnId):
        """Union footprint of a dependency (keys + ranges).  Memoized per
        dep (immutable object, hot on the WaitingOn-init path); callers
        treat the result as read-only."""
        memo = self._memo
        if memo is None:
            memo = self._memo = {}
        cached = memo.get(txn_id)
        if cached is None:
            keys = self.key_deps.participants(txn_id).union(
                self.direct_key_deps.participants(txn_id))
            cached = memo[txn_id] = (keys, self.range_deps.participants(txn_id))
        return cached

    def slice(self, covering: Ranges) -> "Deps":
        return Deps(self.key_deps.slice(covering),
                    self.range_deps.slice(covering),
                    self.direct_key_deps.slice(covering))

    def without(self, predicate: Callable[[TxnId], bool]) -> "Deps":
        return Deps(self.key_deps.without(predicate),
                    self.range_deps.without(predicate),
                    self.direct_key_deps.without(predicate))

    @staticmethod
    def merge(many: Sequence["Deps"]) -> "Deps":
        many = [m for m in many if m is not None]
        return Deps(KeyDeps.merge([m.key_deps for m in many]),
                    RangeDeps.merge([m.range_deps for m in many]),
                    KeyDeps.merge([m.direct_key_deps for m in many]))

    def with_merged(self, other: "Deps") -> "Deps":
        return Deps.merge([self, other])

    def __eq__(self, other) -> bool:
        return (isinstance(other, Deps)
                and self.key_deps == other.key_deps
                and self.range_deps == other.range_deps
                and self.direct_key_deps == other.direct_key_deps)

    def __hash__(self):
        return hash((self.key_deps, self.range_deps, self.direct_key_deps))

    def __repr__(self) -> str:
        return f"Deps{{{self.key_deps!r}, {self.range_deps!r}, direct={self.direct_key_deps!r}}}"


Deps.NONE = Deps()


class DepsBuilder:
    """Routes each (seekable, txnId) add by domain and execution management
    (Deps.java:80-106): key txns managed by CommandsForKey go to key_deps; key txns
    NOT managed (key-domain sync points) to direct_key_deps; range txns to range_deps."""

    __slots__ = ("_keys", "_direct", "_ranges")

    def __init__(self):
        self._keys = KeyDepsBuilder()
        self._direct = KeyDepsBuilder()
        self._ranges = RangeDepsBuilder()

    def add(self, seekable, txn_id: TxnId) -> "DepsBuilder":
        if isinstance(seekable, Range):
            self._ranges.add(seekable, txn_id)
        else:
            from ..local.cfk import manages_execution
            if manages_execution(txn_id):
                self._keys.add(seekable, txn_id)
            else:
                self._direct.add(seekable, txn_id)
        return self

    def build(self) -> Deps:
        return Deps(self._keys.build(), self._ranges.build(), self._direct.build())
