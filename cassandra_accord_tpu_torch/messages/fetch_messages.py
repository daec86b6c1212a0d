"""Bootstrap data-fetch messages.

Capability parity with the reference's bootstrap streaming
(impl/AbstractFetchCoordinator.java FETCH_DATA_REQ handling, ListFetchCoordinator):
a replica newly adopting ranges pulls their current contents from a replica of the
previous epoch.  The source replies with its store contents for the ranges; entries
are (executeAt, value)-timestamped, so application on the destination is idempotent
and composes with concurrently-arriving Apply traffic.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional

from ..primitives.keys import Ranges
from ..primitives.timestamp import TxnId
from .base import MessageType, Reply, Request

if TYPE_CHECKING:
    from ..local.node import Node


class FetchStoreDataOk(Reply):
    """entries: key -> [(executeAt, value), ...] for every key in the ranges.
    ``partial`` marks a source that itself has stale (gapped) data on the
    ranges: its entries are merge-safe (committed writes, timestamp-ordered)
    but not individually complete — union-heal counts it toward the
    quorum-intersection bound instead of treating it as authoritative."""

    __slots__ = ("entries", "partial")

    def __init__(self, entries: Dict, partial: bool = False):
        self.entries = entries
        self.partial = partial

    @property
    def type(self):
        return MessageType.FETCH_DATA_RSP

    def __repr__(self):
        tag = ", partial" if self.partial else ""
        return f"FetchStoreDataOk({len(self.entries)} keys{tag})"


class FetchStoreData(Request):
    """Stream the data-store contents for ``ranges`` to a bootstrapping replica.
    The source first waits until the fencing sync point has applied LOCALLY
    (ApplyThenWaitUntilApplied semantics): a source lagging behind the fence
    would otherwise serve a snapshot missing quorum-applied writes.

    ``allow_stale``: union-heal mode (gap healing, not bootstrap) — a source
    whose own data is stale-marked still serves what it has, flagged partial.
    Any f+1 replicas' union contains every quorum-applied write (an apply
    quorum and f+1 responders must intersect), so the healer can clear its
    stale mark from enough partial snapshots even when EVERY replica of the
    range is gapped — without this, mutually-stale replicas deadlock refusing
    each other and the range stays read-unavailable forever (the chaos+churn
    burns stalled exactly there)."""

    __slots__ = ("ranges", "sync_txn_id", "sync_route", "allow_stale")

    def __init__(self, ranges: Ranges, sync_txn_id: Optional[TxnId] = None,
                 sync_route=None, allow_stale: bool = False):
        self.ranges = ranges
        self.sync_txn_id = sync_txn_id
        self.sync_route = sync_route
        self.allow_stale = allow_stale

    @property
    def type(self):
        return MessageType.FETCH_DATA_REQ

    def wait_for_epoch(self) -> int:
        return self.sync_txn_id.epoch if self.sync_txn_id is not None else 0

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        # a source that is ITSELF still bootstrapping any of these ranges has
        # incomplete data — refuse so the fetcher tries another source
        for cmd_store in node.command_stores.all_stores():
            if cmd_store.pending_bootstrap \
                    and cmd_store.pending_bootstrap.intersects(self.ranges):
                node.message_sink.reply_with_unknown_failure(
                    from_node, reply_context,
                    RuntimeError("source bootstrapping requested ranges"))
                return
        # a source with its OWN known data gaps on these ranges (stale marks):
        # a BOOTSTRAP fetch treats one source as authoritative and must refuse
        # (serving would 'heal' the fetcher with the same hole); a union-heal
        # fetch (allow_stale) serves what it has, flagged partial
        src_stale = getattr(node.data_store, "stale_ranges", None)
        is_partial = (src_stale is not None and len(src_stale)
                      and src_stale.intersects(self.ranges))
        if is_partial and not self.allow_stale:
            node.message_sink.reply_with_unknown_failure(
                from_node, reply_context,
                RuntimeError("source has stale (gapped) data on requested ranges"))
            return

        def serve(outcome=None, failure=None) -> None:
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node,
                                                             reply_context, failure)
                return
            if outcome == "nack":
                node.message_sink.reply_with_unknown_failure(
                    from_node, reply_context,
                    RuntimeError("fence sync point invalidated"))
                return
            store = node.data_store
            entries: Dict = {}
            data = getattr(store, "data", None)
            if data is not None:
                for key, values in data.items():
                    rk = key.to_routing() if hasattr(key, "to_routing") else key
                    if self.ranges.contains(rk):
                        entries[key] = list(values)
            node.reply(from_node, reply_context,
                       FetchStoreDataOk(entries, partial=is_partial))

        if self.sync_txn_id is None or self.sync_route is None:
            serve()
            return
        from .txn_messages import await_applied_local
        # span ALL epochs this node knows: the source may hold the ranges only
        # at a PRIOR epoch (it is the replica the range is moving away from) —
        # the fence still applies there and must be awaited
        await_applied_local(node, self.sync_txn_id, self.sync_route,
                            node.topology.min_epoch,
                            max(self.sync_txn_id.epoch, node.epoch())) \
            .begin(lambda outcome, f: serve(outcome, f))

    def __repr__(self):
        return f"FetchStoreData({self.ranges!r})"
