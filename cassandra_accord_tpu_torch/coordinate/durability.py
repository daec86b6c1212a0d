"""Durability coordination rounds.

Capability parity with ``accord.coordinate`` CoordinateShardDurable /
CoordinateGloballyDurable (both files; SURVEY §2.5):

- shard round: coordinate an exclusive sync point over (a sub-range of) one shard;
  the sync point itself resolves at quorum-applied, but the durability watermark
  is only broadcast once **every** replica of the covered ranges has acknowledged
  application (``WaitUntilApplied`` to all nodes; CoordinateShardDurable.java uses
  an AppliedTracker whose per-shard waitingOn is ``shard.rf()``, not a quorum).
  Only then is ``SetShardDurable`` sent, so the watermark a replica adopts
  unconditionally proves *all-replica* application — replicas may then truncate
  outcomes below it without risk of dropping a still-needed write.
- global round: ``QueryDurableBefore`` from a quorum of all nodes, MAX-merge the
  replies (DurableBefore.merge semantics, QueryDurableBefore.java:51) and
  disseminate the merged map via ``SetGloballyDurable``.  No promotion happens
  here: universal durability is only ever derived from the all-replica apply
  acknowledgement in the shard round (CommandStore.markShardDurable sets both
  majority and universal to the sync id, CommandStore.java:520-528).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List

from ..local.durability import DurableBefore
from ..messages.base import Callback, TxnRequest
from ..messages.durability_messages import (DurableBeforeReply, QueryDurableBefore,
                                            SetGloballyDurable, SetShardDurable)
from ..messages.txn_messages import ApplyOk, WaitUntilApplied
from ..primitives.keys import Ranges
from ..utils import async_ as au
from .errors import Exhausted

if TYPE_CHECKING:
    from ..local.node import Node


def coordinate_shard_durable(node: "Node", ranges: Ranges) -> au.AsyncResult:
    """Exclusive sync point over ``ranges``; once ALL replicas of the covered
    ranges ack ``WaitUntilApplied``, broadcast ``SetShardDurable``.  Resolves
    with the SyncPoint (CoordinateShardDurable.java)."""
    result = au.settable()
    inner = node.sync_point(ranges, exclusive=True, blocking=True)

    def on_sync_point(sync_point, failure):
        if failure is not None:
            result.set_failure(failure)
            return
        participants = sync_point.route.participants()
        scope = participants if isinstance(participants, Ranges) else ranges
        _await_all_applied(node, sync_point, scope, result)

    inner.add_listener(on_sync_point)
    return result


def _await_all_applied(node: "Node", sync_point, scope: Ranges,
                       result: au.Settable) -> None:
    """Send WaitUntilApplied to EVERY replica of ``scope``; only when all have
    acked is the durability watermark broadcast.  A single unreachable replica
    fails the round (the scheduling layer retries on the next cycle) — this is
    what makes the SetShardDurable watermark safe to adopt unconditionally."""
    txn_id = sync_point.txn_id
    topologies = node.topology.precise_epochs(scope, txn_id.epoch, txn_id.epoch)
    targets = sorted(topologies.nodes())
    if not targets:
        result.set_success(sync_point)
        return
    state = {"pending": set(targets), "done": False}

    def complete() -> None:
        state["done"] = True
        for to in targets:
            node.send(to, SetShardDurable(txn_id, scope))
        result.set_success(sync_point)

    class AllAppliedCallback(Callback):
        def on_success(self, from_node: int, reply) -> None:
            if state["done"]:
                return
            if not isinstance(reply, ApplyOk):
                # e.g. ReadNack("invalidated"): not a durable apply ack
                self.on_failure(from_node, RuntimeError(f"bad reply {reply!r}"))
                return
            state["pending"].discard(from_node)
            if not state["pending"]:
                complete()

        def on_failure(self, from_node: int, failure: BaseException) -> None:
            if state["done"]:
                return
            state["done"] = True
            result.set_failure(Exhausted(
                txn_id, f"all-replica apply ack (node {from_node}: {failure})"))

    callback = AllAppliedCallback()
    for to in targets:
        req_scope = TxnRequest.compute_scope(to, topologies, sync_point.route)
        if req_scope is None:
            state["pending"].discard(to)
            continue
        wait_for = TxnRequest.compute_wait_for_epoch(to, topologies)
        node.send(to, WaitUntilApplied(txn_id, req_scope, wait_for), callback)
    if not state["pending"] and not state["done"]:
        complete()


def coordinate_globally_durable(node: "Node") -> au.AsyncResult:
    """Query DurableBefore from every node; at a quorum, MAX-merge and
    disseminate the merged map (CoordinateGloballyDurable.java:70-79 —
    no majority→universal promotion)."""
    result = au.settable()
    topology = node.topology.current()
    all_nodes = sorted(topology.nodes())
    replies: List[DurableBefore] = []
    state = {"done": False, "acks": 0, "fails": 0}
    quorum = len(all_nodes) // 2 + 1

    class QueryCallback(Callback):
        def on_success(self, from_node: int, reply) -> None:
            if state["done"] or not isinstance(reply, DurableBeforeReply):
                return
            replies.append(reply.durable_before)
            state["acks"] += 1
            if state["acks"] >= quorum:
                state["done"] = True
                _finish()

        def on_failure(self, from_node: int, failure: BaseException) -> None:
            if state["done"]:
                return
            state["fails"] += 1
            if len(all_nodes) - state["fails"] < quorum:
                state["done"] = True
                result.set_failure(Exhausted(None, "query durable before"))

    def _finish():
        # max-merge: each node's map only ever contains watermarks proved by a
        # completed shard round (majority = quorum-applied sync point past,
        # universal = all-replica-applied), so the pointwise max of any set of
        # maps is itself proved; dissemination spreads the strongest knowledge.
        merged = DurableBefore.EMPTY
        for db in replies:
            merged = merged.merge(db)
        for to in all_nodes:
            node.send(to, SetGloballyDurable(merged))
        result.set_success(merged)

    callback = QueryCallback()
    for to in all_nodes:
        node.send(to, QueryDurableBefore(), callback)
    return result
