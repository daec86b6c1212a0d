"""Ephemeral (non-durable, 1-round) read messages.

Capability parity with ``accord.messages`` GetEphemeralReadDeps /
ReadEphemeralTxnData (GetEphemeralReadDeps.java, ReadEphemeralTxnData.java):
an EphemeralRead is never witnessed by other transactions and leaves no durable
state — a quorum per shard reports the writes it must be ordered after
(plus the latest epoch, so the read executes against current topology), then one
replica per shard waits for those writes to apply locally and serves the read.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..local.command_store import SafeCommandStore
from ..local.status import SaveStatus
from ..primitives.deps import Deps
from ..primitives.route import Route
from ..primitives.timestamp import Timestamp, TxnId
from ..primitives.txn import PartialTxn
from ..utils import async_ as au
from .base import MessageType, Reply, TxnRequest
from .txn_messages import ReadNack, ReadOk, calculate_partial_deps

if TYPE_CHECKING:
    from ..local.node import Node


class GetEphemeralReadDepsOk(Reply):
    __slots__ = ("deps", "latest_epoch")

    def __init__(self, deps: Deps, latest_epoch: int):
        self.deps = deps
        self.latest_epoch = latest_epoch

    @property
    def type(self):
        return MessageType.GET_EPHEMERAL_READ_DEPS_RSP

    def __repr__(self):
        return f"GetEphemeralReadDepsOk(epoch={self.latest_epoch})"


class GetEphemeralReadDeps(TxnRequest):
    """Report every witnessed txn the ephemeral read must be ordered after
    (writes and sync points on its keys), plus the node's latest epoch."""

    __slots__ = ("keys",)

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int, keys):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.keys = keys

    @property
    def type(self):
        return MessageType.GET_EPHEMERAL_READ_DEPS_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id, keys = self.txn_id, self.keys

        def map_fn(safe_store: SafeCommandStore) -> Deps:
            # ALL conflicting witnessed txns (not just < txnId): the read
            # executes after everything it may be concurrent with
            return calculate_partial_deps(safe_store, txn_id, keys, Timestamp.MAX)

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node, reply_context,
                                                             failure)
            else:
                node.reply(from_node, reply_context, GetEphemeralReadDepsOk(
                    result if result is not None else Deps.NONE, node.epoch()))

        node.map_reduce_consume_local(self.scope, txn_id.epoch, node.epoch(),
                                      map_fn, lambda a, b: a.with_merged(b)) \
            .begin(consume)

    def __repr__(self):
        return f"GetEphemeralReadDeps({self.txn_id!r})"


class ReadEphemeralTxnData(TxnRequest):
    """Wait for the given deps to apply locally, then serve the read
    (ReadEphemeralTxnData.java; no durable command state is created)."""

    __slots__ = ("partial_txn", "partial_deps", "execute_at_epoch")

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int,
                 partial_txn: PartialTxn, partial_deps: Deps, execute_at_epoch: int):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.partial_txn = partial_txn
        self.partial_deps = partial_deps
        self.execute_at_epoch = execute_at_epoch

    @property
    def type(self):
        return MessageType.READ_EPHEMERAL_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id = self.txn_id
        partial_txn, partial_deps = self.partial_txn, self.partial_deps
        stores = node.command_stores.intersecting_stores(
            self.scope, txn_id.epoch, max(txn_id.epoch, self.execute_at_epoch))
        if not stores:
            node.reply(from_node, reply_context, ReadNack("no intersecting store"))
            return

        chains = [store.submit(
            lambda s: _read_after_deps(s, txn_id, partial_txn, partial_deps))
            .flat_map(lambda c: c) for store in stores]

        def consume(datas, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node, reply_context,
                                                             failure)
                return
            # string sentinels from the data plane: "unavailable" (bootstrap)
            # and "obsolete" (stale-marked key — read_chain propagates it so
            # a gapped replica never silently serves a non-prefix snapshot)
            for sentinel, reason in (("unavailable", "unavailable"),
                                     ("obsolete", "obsolete")):
                if any(d == sentinel for d in datas):
                    node.reply(from_node, reply_context, ReadNack(reason))
                    return
            merged = None
            for d in datas:
                if d is None:
                    continue
                merged = d if merged is None else merged.merge(d)
            node.reply(from_node, reply_context, ReadOk(merged))

        au.all_of(chains).begin(consume)

    def __repr__(self):
        return f"ReadEphemeralTxnData({self.txn_id!r})"


def _read_after_deps(safe_store: SafeCommandStore, txn_id: TxnId,
                     partial_txn: PartialTxn, partial_deps: Deps) -> au.AsyncChain:
    """Chain yielding the Data once every local dep has applied (or been
    truncated/invalidated)."""
    store = safe_store.store
    local_ranges = store.all_ranges()
    deps = partial_deps.slice(local_ranges)
    redundant = safe_store.redundant_before()
    pending = set()
    result = au.settable()

    def do_read(s: SafeCommandStore):
        # data for bootstrapping ranges is incomplete here: refuse so the
        # coordinator reads another replica (same guard as _read_when_ready)
        if s.store.pending_bootstrap \
                and partial_txn.intersects(s.store.pending_bootstrap):
            result.set_success("unavailable")
            return
        read_keys = [key for key in partial_txn.keys
                     if local_ranges.contains(key.to_routing()
                                              if hasattr(key, "to_routing") else key)]
        # ephemeral reads are never witnessed: the per-key registers are the
        # ONLY record that this key was snapshotted at this timestamp — a
        # later write landing below it is a deps-completeness violation the
        # registers alone can catch (impl/TimestampsForKey.java)
        tfk = s.store.timestamps_for_key
        snapshot_at = txn_id.as_timestamp()
        for key in read_keys:
            tfk.record_ephemeral_read(key, snapshot_at)
        partial_txn.read_chain(s, snapshot_at, read_keys).begin(
            lambda data, f: result.set_failure(f) if f is not None
            else result.set_success(data))

    def dep_done(s: SafeCommandStore, dep_cmd) -> bool:
        return dep_cmd.save_status.ordinal >= SaveStatus.APPLIED.ordinal \
            or dep_cmd.save_status.is_truncated \
            or dep_cmd.save_status is SaveStatus.INVALIDATED

    for dep_id in deps.txn_ids():
        parts = deps.participants(dep_id)
        if parts is not None and redundant.is_locally_redundant(dep_id, parts):
            continue
        dep = safe_store.get_or_create(dep_id)
        if not dep_done(safe_store, dep):
            pending.add(dep_id)

    if not pending:
        do_read(safe_store)
        return result.to_chain()

    for dep_id in list(pending):
        def listener(s: SafeCommandStore, cmd, dep_id=dep_id):
            if dep_done(s, cmd):
                s.remove_transient_listener(dep_id, listener)
                pending.discard(dep_id)
                if not pending and not result.is_done():
                    do_read(s)
        safe_store.add_transient_listener(dep_id, listener)
    return result.to_chain()
