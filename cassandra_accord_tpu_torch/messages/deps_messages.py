"""GetDeps — the standalone dependency-calculation round.

Capability parity with ``accord.messages.GetDeps`` (GetDeps.java:39-125): for a
txn whose executeAt is already decided but whose deps are unknown on some of
its footprint (an interrupted commit being recovered — Recover.java:384-400 —
or a sync point collecting deps), ask each replica to calculate deps fresh at
``before = executeAt`` and merge per shard at a quorum
(coordinate/collect_deps.py = CollectDeps.java).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..primitives.deps import Deps
from ..primitives.keys import Ranges
from ..primitives.route import Route
from ..primitives.timestamp import Timestamp, TxnId
from .base import MessageType, Reply, TxnRequest
from .txn_messages import calculate_partial_deps

if TYPE_CHECKING:
    from ..local.node import Node


class GetDepsOk(Reply):
    __slots__ = ("deps",)

    def __init__(self, deps: Deps):
        self.deps = deps

    @property
    def type(self):
        return MessageType.GET_DEPS_RSP

    def __repr__(self):
        return f"GetDepsOk({self.deps!r})"


class GetDeps(TxnRequest):
    __slots__ = ("keys", "execute_at")

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int,
                 keys, execute_at: Timestamp):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.keys = keys
        self.execute_at = execute_at

    @property
    def type(self):
        return MessageType.GET_DEPS_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id, keys, execute_at, scope = \
            self.txn_id, self.keys, self.execute_at, self.scope

        def map_fn(safe_store):
            return calculate_partial_deps(safe_store, txn_id, keys, execute_at)

        def reduce_fn(a, b):
            return a.with_merged(b)

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_node, reply_context, failure)
            else:
                node.reply(from_node, reply_context,
                           GetDepsOk(result if result is not None else Deps.NONE))

        node.map_reduce_consume_local(scope, node.topology.min_epoch,
                                      execute_at.epoch, map_fn, reduce_fn) \
            .begin(consume)

    def prefetch_specs(self, node):
        from .txn_messages import _txn_query_specs
        return _txn_query_specs(node, self.txn_id, self.keys, self.execute_at,
                                want_max=False)

    def __repr__(self):
        return f"GetDeps({self.txn_id!r}, @{self.execute_at!r})"


class GetMaxConflictOk(Reply):
    __slots__ = ("max_conflict",)

    def __init__(self, max_conflict: Optional[Timestamp]):
        self.max_conflict = max_conflict

    @property
    def type(self):
        return MessageType.GET_MAX_CONFLICT_RSP

    def __repr__(self):
        return f"GetMaxConflictOk({self.max_conflict!r})"


class GetMaxConflict(TxnRequest):
    """The standalone MaxConflicts consult (GetMaxConflict.java): the highest
    txnId/executeAt witnessed intersecting a footprint — lets an exclusive
    sync point (or any coordinator that only needs an ordering bound) learn a
    safe timestamp floor without a full PreAccept round."""

    __slots__ = ("keys",)

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int, keys):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.keys = keys

    @property
    def type(self):
        return MessageType.GET_MAX_CONFLICT_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        keys, scope = self.keys, self.scope

        def map_fn(safe_store):
            ks = None if isinstance(keys, Ranges) else keys
            rs = keys if isinstance(keys, Ranges) else None
            return safe_store.max_conflict(ks, rs)

        def reduce_fn(a, b):
            if a is None:
                return b
            if b is None:
                return a
            return a if a > b else b

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_node, reply_context, failure)
            else:
                node.reply(from_node, reply_context, GetMaxConflictOk(result))

        node.map_reduce_consume_local(scope, node.topology.min_epoch,
                                      self.txn_id.epoch, map_fn, reduce_fn) \
            .begin(consume)

    def __repr__(self):
        return f"GetMaxConflict({self.txn_id!r})"
