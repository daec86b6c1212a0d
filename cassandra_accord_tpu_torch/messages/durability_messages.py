"""Durability watermark plumbing.

Capability parity with ``accord.messages`` SetShardDurable / SetGloballyDurable /
QueryDurableBefore (SetShardDurable.java, SetGloballyDurable.java,
QueryDurableBefore.java): the durability coordination rounds (CoordinateShardDurable /
CoordinateGloballyDurable) feed every replica's ``DurableBefore`` map through these
messages, which in turn drives truncation/erasure GC (Cleanup).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from ..local.command_store import SafeCommandStore
from ..local.durability import DurableBefore
from ..primitives.keys import Ranges
from ..primitives.timestamp import TxnId
from .base import MessageType, Reply, Request

if TYPE_CHECKING:
    from ..local.node import Node


class SetShardDurable(Request):
    """The exclusive sync point ``txn_id`` (covering ``ranges``) applied at
    EVERY replica (the durability round's all-replica WaitUntilApplied barrier):
    everything before it on those ranges is universally durable."""

    __slots__ = ("txn_id", "ranges")

    def __init__(self, txn_id: TxnId, ranges: Ranges):
        self.txn_id = txn_id
        self.ranges = ranges

    @property
    def type(self):
        return MessageType.SET_SHARD_DURABLE_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id, ranges = self.txn_id, self.ranges

        def for_store(safe_store: SafeCommandStore) -> None:
            safe_store.mark_shard_durable(txn_id, ranges)

        from .txn_messages import SIMPLE_OK
        # for_each_local is EAGER: it returns a settled-able AsyncResult, not
        # a chain — listen, don't begin (a .begin here crashed every
        # SetShardDurable, silently failing shard-durable rounds)
        node.for_each_local(ranges, txn_id.epoch, txn_id.epoch, for_store) \
            .add_listener(
                lambda _v, f: node.message_sink.reply_with_unknown_failure(
                    from_node, reply_context, f) if f is not None
                else node.reply(from_node, reply_context, SIMPLE_OK))

    def __repr__(self):
        return f"SetShardDurable({self.txn_id!r}, {self.ranges!r})"


class SetGloballyDurable(Request):
    """Adopt a cluster-wide DurableBefore map (the MAX-merge of a quorum of
    nodes' maps — each entry was proved by a completed shard round, so
    dissemination only spreads established knowledge; no promotion)."""

    __slots__ = ("durable_before",)

    def __init__(self, durable_before: DurableBefore):
        self.durable_before = durable_before

    @property
    def type(self):
        return MessageType.SET_GLOBALLY_DURABLE_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        durable_before = self.durable_before

        def for_store(safe_store: SafeCommandStore) -> None:
            safe_store.merge_durable_before(durable_before)

        from .txn_messages import SIMPLE_OK
        # for_each_local is EAGER (AsyncResult): listen, don't begin
        node.for_each_local(None, node.topology.min_epoch, node.epoch(),
                            for_store).add_listener(
            lambda _v, f: node.message_sink.reply_with_unknown_failure(
                from_node, reply_context, f) if f is not None
            else node.reply(from_node, reply_context, SIMPLE_OK))

    def __repr__(self):
        return f"SetGloballyDurable({self.durable_before!r})"


class DurableBeforeReply(Reply):
    __slots__ = ("durable_before",)

    def __init__(self, durable_before: DurableBefore):
        self.durable_before = durable_before

    @property
    def type(self):
        return MessageType.QUERY_DURABLE_BEFORE_RSP

    def __repr__(self):
        return f"DurableBeforeReply({self.durable_before!r})"


class QueryDurableBefore(Request):
    """Report this node's DurableBefore map (max-merged across its stores —
    each covers distinct ranges)."""

    __slots__ = ()

    @property
    def type(self):
        return MessageType.QUERY_DURABLE_BEFORE_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        def map_fn(safe_store: SafeCommandStore) -> DurableBefore:
            return safe_store.durable_before()

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node, reply_context,
                                                             failure)
            else:
                node.reply(from_node, reply_context, DurableBeforeReply(
                    result if result is not None else DurableBefore.EMPTY))

        node.map_reduce_consume_local(None, node.topology.min_epoch, node.epoch(),
                                      map_fn, lambda a, b: a.merge(b)).begin(consume)

    def __repr__(self):
        return "QueryDurableBefore"
