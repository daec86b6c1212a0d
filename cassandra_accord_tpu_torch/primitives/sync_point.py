"""Sync point result handle.

Capability parity with ``accord.primitives.SyncPoint`` (SyncPoint.java): the handle a
coordinated sync point resolves with — its TxnId, the route it covers, and the
dependency set it waited on.  Consumers (Barrier, Bootstrap, durability rounds) use it
to know *which* transactions are guaranteed applied/witnessed once the sync point is.
"""
from __future__ import annotations

from .deps import Deps
from .route import Route
from .timestamp import TxnId


class SyncPoint:
    __slots__ = ("txn_id", "route", "deps", "execute_at")

    def __init__(self, txn_id: TxnId, route: Route, deps: Deps, execute_at=None):
        self.txn_id = txn_id
        self.route = route
        self.deps = deps
        # agreed executeAt (may exceed txn_id on the slow path): consumers that
        # re-disseminate the fence (fetch streaming) must use THIS
        self.execute_at = execute_at if execute_at is not None \
            else txn_id.as_timestamp()

    @property
    def keys_or_ranges(self):
        return self.route.participants()

    def __repr__(self) -> str:
        return f"SyncPoint({self.txn_id!r}, {self.route!r})"
