"""List-append KV model store for the harness and Maelstrom adapter.

Capability parity with the reference's ``accord.impl.list`` test model
(ListStore.java 599 LoC, ListRead/ListUpdate/ListQuery/ListData/ListResult): every key
holds a list of appended values with their apply timestamps; writes append a value,
reads return the list contents.  The burn test's strict-serializability verifier
consumes exactly this read/append observation model.
"""
from __future__ import annotations

from bisect import insort
from typing import Dict, List, Optional, Tuple

from ..api.interfaces import Data, DataStore, Query, Read, Result, Update, Write
from ..primitives.keys import Key, Keys, Ranges
from ..primitives.timestamp import Timestamp, TxnId
from ..utils import async_ as au


class ListStore(DataStore):
    """In-memory per-node storage: key -> sorted list of (executeAt, value)."""

    def __init__(self, node_id: int = 0):
        self.node_id = node_id
        self.data: Dict[Key, List[Tuple[Timestamp, object]]] = {}
        # ranges with KNOWN data holes (truncated-outcome adoption landed a
        # txn whose truncated-away predecessors are absent): reads here are
        # refused (obsolete-nack -> coordinator retries another replica)
        # until a peer snapshot heals the gap
        # a MULTISET of marks: overlapping gaps from independent heals must
        # not clear each other's coverage (each heal clears only its token)
        self._stale_marks: list = []

    def mark_stale(self, rngs):
        """Returns the token to pass to clear_stale."""
        token = rngs
        self._stale_marks.append(token)
        return token

    def clear_stale(self, token) -> None:
        try:
            self._stale_marks.remove(token)
        except ValueError:
            pass

    @property
    def stale_ranges(self):
        from ..primitives.keys import Ranges as _Ranges
        out = _Ranges.EMPTY
        for r in self._stale_marks:
            out = out.union(r)
        return out

    def is_stale(self, key) -> bool:
        if not self._stale_marks:
            return False
        rk = key.to_routing() if hasattr(key, "to_routing") else key
        return any(r.contains(rk) for r in self._stale_marks)

    def get(self, key: Key) -> Tuple[object, ...]:
        return tuple(v for _, v in self.data.get(key, ()))

    def get_at(self, key: Key, execute_at: Timestamp,
               exclusive: bool = False) -> Tuple[object, ...]:
        """Snapshot read: entries applied at-or-before ``execute_at`` only.
        Keeps reads correct even when a write with a LATER executeAt landed
        early (truncated-outcome adoption applies out of dependency order).

        ``exclusive`` drops the entry at exactly ``execute_at``: executeAts
        are unique per txn, so when a read is served from a copy that already
        APPLIED the txn, the exclusive bound removes exactly the txn's OWN
        write — reconstructing the pre-apply snapshot the read semantics
        require."""
        if exclusive:
            return tuple(v for ts, v in self.data.get(key, ()) if ts < execute_at)
        return tuple(v for ts, v in self.data.get(key, ()) if ts <= execute_at)

    def append(self, key: Key, execute_at: Timestamp, value: object) -> None:
        entries = self.data.setdefault(key, [])
        # idempotent: the same (executeAt, value) may be applied once
        for ts, _ in entries:
            if ts == execute_at:
                return
        insort(entries, (execute_at, value))

    def keys_in(self, rng) -> List[Key]:
        """All stored keys within a Range, sorted (range-read enumeration)."""
        return sorted(k for k in self.data if rng.contains(k.to_routing()))

    def fetch(self, node, safe_store, ranges, sync_point, fetch_ranges,
              catch_up: bool = False):
        """Pull ``ranges``' contents from a source replica (bootstrap
        streaming; impl/AbstractFetchCoordinator.java).  Sources have applied
        the fencing sync point, so their data is complete up to it; entries are
        timestamped so concurrent Apply traffic composes idempotently.

        ``catch_up=False`` (topology-change adoption): sources are the
        PRIOR-epoch shard replicas — they held the data before the move; no
        prior topology means fresh key-space (trivially complete).
        ``catch_up=True`` (stale-range bootstrap-grade heal): this store
        already owns the ranges and is refetching IN PLACE — sources are the
        fence-epoch shard PEERS, and a slice with no reachable peer fails the
        attempt (never 'trivially complete': the data exists, we lost it)."""
        from ..messages.base import Callback
        from ..messages.fetch_messages import FetchStoreData, FetchStoreDataOk

        # fetch plan: per source-topology SHARD slice, from that shard's
        # replicas — a single source need not cover all the ranges (they may
        # span shards with disjoint replica sets)
        epoch = sync_point.txn_id.epoch
        source_topo = None
        if catch_up:
            if node.topology.has_epoch(epoch):
                source_topo = node.topology.topology_for_epoch(epoch)
        else:
            for e in range(epoch - 1, node.topology.min_epoch - 1, -1):
                if node.topology.has_epoch(e):
                    source_topo = node.topology.topology_for_epoch(e)
                    break
        plan = []   # (sub_ranges, [candidate sources])
        if source_topo is not None:
            for shard in source_topo.shards:
                sub = ranges.intersection(Ranges.of(shard.range))
                if not sub:
                    continue
                candidates = [n for n in shard.nodes if n != node.id]
                if candidates:
                    plan.append((sub, candidates))
                elif node.id in shard.nodes and not catch_up:
                    # we were the shard's only replica: our local copy IS the
                    # data, complete up to the fence by construction
                    pass
                else:
                    # a needed slice has NO source — reporting it fetched would
                    # let bootstrapped_at cover data we never obtained; fail the
                    # attempt so bootstrap retries (ListStore.fetch contract,
                    # impl/list/ListStore.java)
                    fetch_ranges.fail(RuntimeError(
                        f"no fetch source for {sub!r} "
                        f"(epoch {source_topo.epoch}, catch_up={catch_up})"))
                    return au.success_result()
        if not plan:
            if catch_up:
                # catch-up must never claim completeness without a source
                fetch_ranges.fail(RuntimeError(
                    f"no catch-up sources for {ranges!r} at epoch {epoch}"))
                return au.success_result()
            # anything the prior topology did not replicate is fresh
            # key-space: trivially complete
            fetch_ranges.fetched(ranges)
            return au.success_result()

        store = self
        remaining = {"n": len(plan)}
        # the fence shipment (Apply.Maximal of the sync point) depends only on
        # the sync point — build it once for all slices/failover retries
        from ..messages.txn_messages import Apply, ApplyOk, ApplyThenWaitUntilApplied
        from ..primitives.timestamp import TxnKind
        from ..primitives.txn import Txn
        fence_parts = sync_point.route.participants()
        fence_txn = Txn.empty(TxnKind.EXCLUSIVE_SYNC_POINT, fence_parts)
        fence_partial = fence_txn.slice(fence_parts, include_query=False)
        fence_writes = fence_txn.execute(sync_point.txn_id,
                                         sync_point.execute_at, None)

        def fetch_slice(sub: Ranges, candidates, i: int) -> None:
            class FetchCallback(Callback):
                def on_success(self, from_node: int, reply) -> None:
                    if not isinstance(reply, FetchStoreDataOk):
                        self.on_failure(from_node,
                                        RuntimeError(f"bad reply {reply!r}"))
                        return
                    for key, entries in reply.entries.items():
                        for ts, value in entries:
                            store.append(key, ts, value)
                    remaining["n"] -= 1
                    if remaining["n"] == 0:
                        fetch_ranges.fetched(ranges)

                def on_failure(self, from_node: int, failure: BaseException) -> None:
                    if i + 1 < len(candidates):
                        fetch_slice(sub, candidates, i + 1)
                    else:
                        fetch_ranges.fail(failure)

            # ship the fence to the source FIRST (Apply.Maximal + wait-applied):
            # a source outside the fence's current-epoch topology (the replica
            # the range is moving AWAY from) never hears of it otherwise, and
            # data is only complete up to an APPLIED fence
            # (impl/AbstractFetchCoordinator.java — ApplyThenWaitUntilApplied)
            fetch_cb = FetchCallback()

            class FenceCallback(Callback):
                def on_success(self, from_node: int, reply) -> None:
                    if not isinstance(reply, ApplyOk):
                        self.on_failure(from_node,
                                        RuntimeError(f"fence not applied: {reply!r}"))
                        return
                    node.send(from_node,
                              FetchStoreData(sub, sync_point.txn_id,
                                             sync_point.route),
                              fetch_cb)

                def on_failure(self, from_node: int, failure: BaseException) -> None:
                    fetch_cb.on_failure(from_node, failure)

            node.send(candidates[i], ApplyThenWaitUntilApplied(
                sync_point.txn_id, sync_point.route, sync_point.txn_id.epoch,
                Apply.MAXIMAL, sync_point.execute_at,
                sync_point.deps, fence_partial,
                fence_writes, None, route=sync_point.route), FenceCallback())

        for sub, candidates in plan:
            fetch_slice(sub, candidates, 0)
        return au.success_result()


class ListData(Data):
    """key -> tuple of values observed by the read."""

    def __init__(self, entries: Optional[Dict[Key, Tuple]] = None):
        self.entries: Dict[Key, Tuple] = entries or {}

    def merge(self, other: "Data") -> "Data":
        if not isinstance(other, ListData):
            return self
        merged = dict(self.entries)
        merged.update(other.entries)
        return ListData(merged)

    def __repr__(self):
        return f"ListData({self.entries})"


class ListRead(Read):
    def __init__(self, keys: Keys):
        self._keys = keys

    def keys(self):
        return self._keys

    def read(self, key, safe_store, execute_at, data_store) -> au.AsyncChain:
        if getattr(data_store, "is_stale", lambda _k: False)(key):
            return au.done("obsolete")   # gapped here: serve from a peer
        return au.done(ListData({key: data_store.get_at(key, execute_at)}))

    def slice(self, ranges: Ranges) -> "ListRead":
        return ListRead(self._keys.slice(ranges))

    def merge(self, other: "Read") -> "ListRead":
        return ListRead(self._keys.union(other._keys))


class ListRangeRead(Read):
    """Range-domain read: reads every stored key inside the ranges
    (the reference's range queries, BurnTest.java:208-240 / ListRead over ranges)."""

    def __init__(self, ranges: Ranges):
        self._ranges = ranges

    def keys(self):
        return self._ranges

    def read(self, rng, safe_store, execute_at, data_store) -> au.AsyncChain:
        stale = getattr(data_store, "stale_ranges", None)
        if stale is not None and len(stale) and stale.intersects(rng):
            return au.done("obsolete")   # gapped here: serve from a peer
        entries = {key: data_store.get_at(key, execute_at)
                   for key in data_store.keys_in(rng)}
        return au.done(ListData(entries))

    def slice(self, ranges: Ranges) -> "ListRangeRead":
        return ListRangeRead(self._ranges.intersection(ranges))

    def merge(self, other: "Read") -> "ListRangeRead":
        return ListRangeRead(self._ranges.union(other._ranges))


class ListWrite(Write):
    """Computed appends: key -> value."""

    def __init__(self, appends: Dict[Key, object]):
        self.appends = appends

    def apply(self, store: ListStore, key, execute_at) -> au.AsyncChain:
        if key in self.appends:
            store.append(key, execute_at, self.appends[key])
        return au.done(None)

    def merge(self, other: "ListWrite") -> "ListWrite":
        merged = dict(self.appends)
        merged.update(other.appends)
        return ListWrite(merged)


class ListUpdate(Update):
    """key -> value to append."""

    def __init__(self, appends: Dict[Key, object]):
        self.appends = appends

    def keys(self):
        return Keys.of(self.appends.keys())

    def apply(self, execute_at, data) -> ListWrite:
        return ListWrite(dict(self.appends))

    def slice(self, ranges: Ranges) -> "ListUpdate":
        return ListUpdate({k: v for k, v in self.appends.items()
                           if ranges.contains(k.to_routing())})

    def merge(self, other: "Update") -> "ListUpdate":
        merged = dict(self.appends)
        merged.update(other.appends)
        return ListUpdate(merged)


class ListResult(Result):
    """Client-visible result: what the txn read (key -> tuple) and wrote."""

    def __init__(self, txn_id: TxnId, execute_at, reads: Dict[Key, Tuple],
                 writes: Dict[Key, object]):
        self.txn_id = txn_id
        self.execute_at = execute_at
        self.reads = reads
        self.writes = writes

    def __repr__(self):
        return f"ListResult({self.txn_id!r}, reads={self.reads}, writes={self.writes})"


class ListQuery(Query):
    def __init__(self):
        pass

    def compute(self, txn_id, execute_at, keys, data, read, update) -> ListResult:
        reads = dict(data.entries) if isinstance(data, ListData) else {}
        writes = dict(update.appends) if isinstance(update, ListUpdate) else {}
        return ListResult(txn_id, execute_at, reads, writes)


def list_txn(keys_read: List[Key], appends: Dict[Key, object]):
    """Build a list-model Txn: read ``keys_read``, append ``appends``."""
    from ..primitives.txn import Txn
    all_keys = Keys.of(list(keys_read) + list(appends.keys()))
    read = ListRead(Keys.of(keys_read))
    update = ListUpdate(appends) if appends else None
    return Txn.of(all_keys, read, update, ListQuery())


def range_read_txn(ranges: Ranges):
    """Build a range-domain read Txn over ``ranges`` (reference range queries)."""
    from ..primitives.txn import Txn
    return Txn.of(ranges, ListRangeRead(ranges), None, ListQuery())


def ephemeral_read_txn(keys_read: List[Key]):
    """Build an ephemeral (1-round, non-durable) read Txn (Txn.Kind.EphemeralRead)."""
    from ..primitives.timestamp import TxnKind
    from ..primitives.txn import Txn
    keys = Keys.of(keys_read)
    return Txn(TxnKind.EPHEMERAL_READ, keys, ListRead(keys), None, ListQuery())
