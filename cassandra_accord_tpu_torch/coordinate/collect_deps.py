"""CollectDeps — quorum deps collection over a footprint.

Capability parity with ``accord.coordinate.CollectDeps`` (CollectDeps.java):
drive a GetDeps round to a quorum of every shard covering ``keys`` and merge
the replies.  Used by recovery when the merged commit evidence is
insufficient for part of the footprint (Recover.withCommittedDeps,
Recover.java:384-400).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict

from ..messages.base import Callback, TxnRequest
from ..messages.deps_messages import (GetDeps, GetDepsOk, GetMaxConflict,
                                      GetMaxConflictOk)
from ..primitives.deps import Deps
from ..primitives.route import Route
from ..primitives.timestamp import Timestamp, TxnId
from ..utils import async_ as au
from .errors import Exhausted
from .tracking import QuorumTracker, RequestStatus

if TYPE_CHECKING:
    from ..local.node import Node


def collect_deps(node: "Node", txn_id: TxnId, route: Route, keys,
                 execute_at: Timestamp) -> au.AsyncResult:
    """Resolve with the merged Deps for ``keys`` at ``execute_at``."""
    result = au.settable()
    topologies = node.topology.precise_epochs(route, txn_id.epoch,
                                              execute_at.epoch)
    tracker = QuorumTracker(topologies)
    oks: Dict[int, Deps] = {}
    state = {"done": False}

    class CollectCallback(Callback):
        def on_success(self, from_node: int, reply) -> None:
            if state["done"]:
                return
            if isinstance(reply, GetDepsOk):
                oks[from_node] = reply.deps
                if tracker.record_success(from_node) is RequestStatus.SUCCESS:
                    state["done"] = True
                    result.set_success(Deps.merge(list(oks.values())))

        def on_failure(self, from_node: int, failure: BaseException) -> None:
            if state["done"]:
                return
            if tracker.record_failure(from_node) is RequestStatus.FAILED:
                state["done"] = True
                result.set_failure(Exhausted(txn_id, "GetDeps quorum unreachable"))

    callback = CollectCallback()
    for to in tracker.nodes():
        scope = TxnRequest.compute_scope(to, topologies, route)
        if scope is None:
            continue
        node.send(to, GetDeps(txn_id, scope,
                              TxnRequest.compute_wait_for_epoch(to, topologies),
                              keys, execute_at), callback)
    return result


def fetch_max_conflict(node: "Node", txn_id: TxnId, route: Route,
                       keys) -> au.AsyncResult:
    """FetchMaxConflict (FetchMaxConflict.java): quorum max of every shard's
    MaxConflicts over ``keys`` — resolves with the highest Timestamp witnessed
    (or None if nothing conflicts anywhere)."""
    result = au.settable()
    topologies = node.topology.precise_epochs(route, txn_id.epoch,
                                              txn_id.epoch)
    tracker = QuorumTracker(topologies)
    best: Dict[str, object] = {"ts": None}
    state = {"done": False}

    class MaxCallback(Callback):
        def on_success(self, from_node: int, reply) -> None:
            if state["done"]:
                return
            if isinstance(reply, GetMaxConflictOk):
                ts = reply.max_conflict
                if ts is not None and (best["ts"] is None or ts > best["ts"]):
                    best["ts"] = ts
                if tracker.record_success(from_node) is RequestStatus.SUCCESS:
                    state["done"] = True
                    result.set_success(best["ts"])

        def on_failure(self, from_node: int, failure: BaseException) -> None:
            if state["done"]:
                return
            if tracker.record_failure(from_node) is RequestStatus.FAILED:
                state["done"] = True
                result.set_failure(
                    Exhausted(txn_id, "GetMaxConflict quorum unreachable"))

    callback = MaxCallback()
    for to in tracker.nodes():
        scope = TxnRequest.compute_scope(to, topologies, route)
        if scope is None:
            continue
        node.send(to, GetMaxConflict(
            txn_id, scope, TxnRequest.compute_wait_for_epoch(to, topologies),
            keys), callback)
    return result
