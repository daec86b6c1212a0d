"""Transaction bodies, partial slices, and applied write sets.

Capability parity with ``accord.primitives.Txn/PartialTxn/Writes``
(Txn.java:53-422, PartialTxn.java, Writes.java): a Txn = Kind + Seekables (keys or
ranges) + Read + optional Update + Query; default execution helpers turn read Data into
Writes and a client Result.  ``Writes`` carries the applied write-set through the Apply
phase with an idempotent ``apply`` chain.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

from ..utils import async_ as au
from ..utils.invariants import check_argument, check_state
from .keys import Keys, Range, Ranges, RoutingKey
from .route import Route
from .timestamp import Domain, Timestamp, TxnId, TxnKind

if TYPE_CHECKING:
    from ..api.interfaces import Data, Query, Read, Result, Update

Seekables = Union[Keys, Ranges]


class Txn:
    """Immutable transaction body (Txn.java:53-113)."""

    __slots__ = ("kind", "keys", "read", "update", "query")

    def __init__(self, kind: TxnKind, keys: Seekables, read: "Read",
                 update: Optional["Update"] = None, query: Optional["Query"] = None):
        self.kind = kind
        self.keys = keys
        self.read = read
        self.update = update
        self.query = query

    # -- constructors -------------------------------------------------------
    @staticmethod
    def of(keys: Seekables, read: "Read", update: Optional["Update"] = None,
           query: Optional["Query"] = None) -> "Txn":
        kind = TxnKind.WRITE if update is not None else TxnKind.READ
        return Txn(kind, keys, read, update, query)

    @staticmethod
    def empty(kind: TxnKind, keys_or_ranges: Seekables) -> "Txn":
        from ..impl.noop_execution import NOOP_QUERY, NoopRead
        return Txn(kind, keys_or_ranges, NoopRead(keys_or_ranges), None, NOOP_QUERY)

    # -- domain -------------------------------------------------------------
    @property
    def domain(self) -> Domain:
        return Domain.RANGE if isinstance(self.keys, Ranges) else Domain.KEY

    def is_write(self) -> bool:
        return self.kind.is_write

    # -- routing ------------------------------------------------------------
    def routing_keys(self):
        if isinstance(self.keys, Ranges):
            return self.keys
        return self.keys.to_routing_keys()

    def home_key(self) -> RoutingKey:
        """Deterministic home-key pick: first routing key / range start
        (reference picks via Node.computeRoute / trySortedArraysToRoute)."""
        if isinstance(self.keys, Ranges):
            return self.keys[0].start
        return self.keys[0].to_routing()

    def to_route(self, home_key: Optional[RoutingKey] = None) -> Route:
        hk = home_key if home_key is not None else self.home_key()
        if isinstance(self.keys, Ranges):
            return Route.for_ranges(hk, self.keys)
        return Route.for_keys(hk, self.keys.to_routing_keys())

    # -- slicing (PartialTxn semantics) -------------------------------------
    def slice(self, ranges: Ranges, include_query: bool) -> "PartialTxn":
        if isinstance(self.keys, Ranges):
            keys = self.keys.intersection(ranges)
        else:
            keys = self.keys.slice(ranges)
        return PartialTxn(
            self.kind, keys,
            self.read.slice(ranges) if self.read is not None else None,
            self.update.slice(ranges) if self.update is not None else None,
            self.query if include_query else None,
        )

    def intersects(self, ranges: Ranges) -> bool:
        return ranges.intersects(self.keys) if isinstance(self.keys, Keys) \
            else self.keys.intersects(ranges)

    # -- execution helpers (Txn.java:395-422) --------------------------------
    def read_chain(self, safe_store, execute_at: Timestamp, read_scope,
                   data_store=None) -> "au.AsyncChain":
        """Execute the read hook for every key in scope; merge Data.

        ``data_store`` overrides the store view (e.g. an exclusive-snapshot
        wrapper when serving a read from an already-applied copy)."""
        chains = []
        if data_store is None:
            data_store = safe_store.data_store()
        read_keys = self.read.keys()
        for key in read_scope:
            if read_keys is not None and not isinstance(read_keys, Ranges) \
                    and not read_keys.contains(key):
                continue  # only keys the Read declares (write-only keys are skipped)
            chains.append(self.read.read(key, safe_store, execute_at, data_store))
        if not chains:
            return au.done(None)

        def merge_all(datas):
            merged = None
            for d in datas:
                if d is None:
                    continue
                if isinstance(d, str):
                    # per-key sentinel from the data store ("obsolete" on a
                    # stale-marked key): the whole store read reports it
                    return d
                merged = d if merged is None else merged.merge(d)
            return merged

        return au.all_of(chains).map(merge_all)

    def execute(self, txn_id: TxnId, execute_at: Timestamp, data: Optional["Data"]) -> "Writes":
        if self.update is None:
            return Writes(txn_id, execute_at, Keys.empty() if not isinstance(self.keys, Ranges) else self.keys, None)
        write = self.update.apply(execute_at, data)
        return Writes(txn_id, execute_at, self.update.keys(), write)

    def result(self, txn_id: TxnId, execute_at: Timestamp, data: Optional["Data"]) -> "Result":
        if self.query is None:
            from ..impl.noop_execution import NOOP_RESULT
            return NOOP_RESULT
        return self.query.compute(txn_id, execute_at, self.keys, data, self.read, self.update)

    def __repr__(self) -> str:
        return f"Txn({self.kind.short_name}, {self.keys!r})"


class PartialTxn(Txn):
    """A Txn sliced to one replica's covered ranges (PartialTxn.java)."""

    __slots__ = ()

    def covers(self, unseekables) -> bool:
        if isinstance(self.keys, Ranges):
            return all(self.keys.intersects(u) if isinstance(u, Range) else self.keys.contains(u)
                       for u in unseekables)
        covered = {k.to_routing() for k in self.keys}
        return all(u in covered for u in unseekables)

    def reconstitute_or_none(self, route: Route) -> Optional[Txn]:
        if route.is_full and self.covers(route.participants()):
            return Txn(self.kind, self.keys, self.read, self.update, self.query)
        return None

    def with_merged(self, other: "PartialTxn") -> "PartialTxn":
        if other is None:
            return self
        keys = self.keys.union(other.keys)
        read = self.read.merge(other.read) if self.read is not None and other.read is not None \
            else (self.read or other.read)
        update = self.update.merge(other.update) if self.update is not None and other.update is not None \
            else (self.update or other.update)
        return PartialTxn(self.kind, keys, read, update, self.query or other.query)


class Writes:
    """Applied write-set (Writes.java): (txnId, executeAt, keys, write)."""

    __slots__ = ("txn_id", "execute_at", "keys", "write", "_rk")

    def __init__(self, txn_id: TxnId, execute_at: Timestamp, keys, write):
        self.txn_id = txn_id
        self.execute_at = execute_at
        self.keys = keys
        self.write = write
        # lazy routing-key-set cache (commands._written_routing_keys); never
        # on the wire (codec _SKIP_SLOTS) — rebuilt on first use post-decode
        self._rk = None

    def is_empty(self) -> bool:
        return self.write is None

    def apply_to(self, safe_store, apply_ranges: Ranges) -> "au.AsyncChain":
        """Apply writes for keys within ``apply_ranges``; returns chain of done."""
        if self.write is None:
            return au.done(None)
        chains = []
        store = safe_store.data_store()
        for key in self.keys:
            if apply_ranges.contains(key.to_routing() if hasattr(key, "to_routing") else key):
                chains.append(self.write.apply(store, key, self.execute_at))
        if not chains:
            return au.done(None)
        return au.all_of(chains).map(lambda _: None)

    def slice(self, ranges: Ranges) -> "Writes":
        if isinstance(self.keys, Ranges):
            return Writes(self.txn_id, self.execute_at, self.keys.intersection(ranges), self.write)
        return Writes(self.txn_id, self.execute_at, self.keys.slice(ranges), self.write)

    def merge(self, other: Optional["Writes"]) -> "Writes":
        """Union of two per-shard slices of the same txn's writes."""
        if other is None or other.write is None:
            return self
        if self.write is None:
            return other
        keys = self.keys.union(other.keys)
        write = self.write if self.write is other.write \
            else self.write.merge(other.write)
        return Writes(self.txn_id, self.execute_at, keys, write)

    def __repr__(self) -> str:
        return f"Writes({self.txn_id!r}@{self.execute_at!r}, {self.keys!r})"
