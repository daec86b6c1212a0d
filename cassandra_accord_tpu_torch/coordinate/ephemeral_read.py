"""Ephemeral read coordination — 1 round trip, nothing durable.

Capability parity with ``accord.coordinate.CoordinateEphemeralRead``
(CoordinateEphemeralRead.java:57-150): a quorum per shard reports deps (writes the
read must be ordered after) and the latest epoch; then ``ExecuteEphemeralRead``
sends ReadEphemeralTxnData to one replica per shard (with slow-replica retry via
ReadTracker), which waits for the deps to apply locally and serves the read.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List

from ..messages.base import Callback, TxnRequest
from ..messages.ephemeral_messages import (GetEphemeralReadDeps,
                                           GetEphemeralReadDepsOk,
                                           ReadEphemeralTxnData)
from ..messages.txn_messages import ReadNack, ReadOk
from ..primitives.deps import Deps
from ..primitives.route import Route
from ..primitives.timestamp import TxnId
from ..primitives.txn import Txn
from ..utils import async_ as au
from .coordinate_transaction import _scope_ranges
from .errors import Exhausted, Insufficient
from .tracking import QuorumTracker, ReadTracker, RequestStatus

if TYPE_CHECKING:
    from ..local.node import Node


def coordinate_ephemeral_read(node: "Node", txn_id: TxnId, txn: Txn,
                              result: au.Settable) -> None:
    route = node.compute_route(txn)
    _CoordinateEphemeralRead(node, txn_id, txn, route, result).start()


class _CoordinateEphemeralRead:
    def __init__(self, node: "Node", txn_id: TxnId, txn: Txn, route: Route,
                 result: au.Settable):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.result = result
        self.topologies = node.topology.with_unsynced_epochs(route, txn_id.epoch,
                                                             txn_id.epoch)
        self.execute_at_epoch = txn_id.epoch
        self.all_oks: List[GetEphemeralReadDepsOk] = []

    # -- deps round ----------------------------------------------------------
    def start(self) -> None:
        """Contact a quorum over the topologies spanning [txnId.epoch,
        execute_at_epoch].  If a reply reveals a LATER epoch, re-contact over
        the extended topologies so new-epoch replicas contribute deps and the
        read executes against current topology (the reference's
        onPreAcceptedOrNewEpoch loop, AbstractCoordinatePreAccept.java)."""
        contacted_epoch = self.execute_at_epoch
        tracker = QuorumTracker(self.topologies)
        oks = self.all_oks
        this = self

        class DepsCallback(Callback):
            done = False

            def on_success(self, from_node: int, reply) -> None:
                if self.done or not isinstance(reply, GetEphemeralReadDepsOk):
                    return
                oks.append(reply)
                if reply.latest_epoch > this.execute_at_epoch:
                    this.execute_at_epoch = reply.latest_epoch
                if tracker.record_success(from_node) is RequestStatus.SUCCESS:
                    self.done = True
                    if this.execute_at_epoch > contacted_epoch:
                        this._restart_for_epoch()
                    else:
                        this.execute(Deps.merge([ok.deps for ok in oks]))

            def on_failure(self, from_node: int, failure: BaseException) -> None:
                if self.done:
                    return
                if tracker.record_failure(from_node) is RequestStatus.FAILED:
                    self.done = True
                    this.result.set_failure(Exhausted(this.txn_id, "ephemeral deps"))

        callback = DepsCallback()
        self.node.send_to_each(tracker.nodes(), self._deps_request_for, callback)

    def _restart_for_epoch(self) -> None:
        def go(_v, f):
            if f is not None:
                self.result.set_failure(f)
                return
            self.topologies = self.node.topology.with_unsynced_epochs(
                self.route, self.txn_id.epoch, self.execute_at_epoch)
            self.start()

        self.node.with_epoch(self.execute_at_epoch).begin(go)

    def _deps_request_for(self, to: int):
        scope = TxnRequest.compute_scope(to, self.topologies, self.route)
        if scope is None:
            return None
        wait_for = TxnRequest.compute_wait_for_epoch(to, self.topologies)
        ranges = _scope_ranges(self.node, scope, self.topologies.current_epoch)
        from ..primitives.keys import Ranges as _Ranges
        keys = self.txn.keys.intersection(ranges) \
            if isinstance(self.txn.keys, _Ranges) else self.txn.keys.slice(ranges)
        return GetEphemeralReadDeps(self.txn_id, scope, wait_for, keys)

    # -- execute round -------------------------------------------------------
    def execute(self, deps: Deps) -> None:
        read_tracker = ReadTracker(self.topologies)
        this = self
        data_holder = {"data": None, "done": False}

        class ReadCallback(Callback):
            def on_success(self, from_node: int, reply) -> None:
                if data_holder["done"]:
                    return
                if isinstance(reply, ReadOk):
                    if reply.data is not None:
                        data_holder["data"] = reply.data if data_holder["data"] is None \
                            else data_holder["data"].merge(reply.data)
                    if read_tracker.record_read_success(from_node) \
                            is RequestStatus.SUCCESS:
                        data_holder["done"] = True
                        this.finish(data_holder["data"])
                elif isinstance(reply, ReadNack):
                    # transient single-replica conditions (bootstrapping /
                    # stale topology): retry the shard's other replicas
                    self._retry(from_node)

            def on_failure(self, from_node: int, failure: BaseException) -> None:
                if data_holder["done"]:
                    return
                self._retry(from_node)

            def _retry(self, from_node: int) -> None:
                status, retries = read_tracker.record_read_failure(
                    from_node, avoid=this.node.slow_peers())
                if status is RequestStatus.FAILED:
                    data_holder["done"] = True
                    this.result.set_failure(Exhausted(this.txn_id, "ephemeral read"))
                    return
                for to in retries:
                    req = this._read_request_for(to, deps)
                    if req is not None:
                        this.node.send(to, req, self.callback_ref)

        callback = ReadCallback()
        callback.callback_ref = callback
        for to in read_tracker.initial_contacts(prefer=self.node.id,
                                                avoid=self.node.slow_peers()):
            req = self._read_request_for(to, deps)
            if req is not None:
                self.node.send(to, req, callback)

    def _read_request_for(self, to: int, deps: Deps):
        scope = TxnRequest.compute_scope(to, self.topologies, self.route)
        if scope is None:
            return None
        wait_for = TxnRequest.compute_wait_for_epoch(to, self.topologies)
        ranges = _scope_ranges(self.node, scope, self.topologies.current_epoch)
        partial = self.txn.slice(ranges, to == self.node.id)
        return ReadEphemeralTxnData(self.txn_id, scope, wait_for, partial,
                                    deps.slice(ranges), self.execute_at_epoch)

    def finish(self, data) -> None:
        self.result.set_success(
            self.txn.result(self.txn_id, self.txn_id.as_timestamp(), data))
