"""Sync point coordination.

Capability parity with ``accord.coordinate`` CoordinateSyncPoint / ProposeSyncPoint /
ExecuteSyncPoint (CoordinateSyncPoint.java:58-140, CoordinationAdapter.java:214-264):
a sync point is an empty transaction (kind SyncPoint or ExclusiveSyncPoint) coordinated
through the standard PreAccept/Accept/Stable pipeline whose *execution* is pure
dependency-wait — once applied, every transaction in its dependency set is decided
(and, for a quorum-applied sync point, durably applied at a quorum per shard).

- inclusive, async:   resolves with the SyncPoint handle once stable (deps known);
                      applies proceed in the background (CoordinateSyncPoint.inclusive).
- inclusive, blocking: resolves once a quorum of every shard has Applied.
- exclusive:          kind ExclusiveSyncPoint — witnesses everything before it and is
                      witnessed by everything after; used by bootstrap, epoch closure
                      and shard-durability rounds.  Always quorum-applied, and notifies
                      the epoch-closure hook (CoordinationAdapter.java:214-264).
"""
from __future__ import annotations

from typing import Optional, TYPE_CHECKING

from ..local.status import SaveStatus
from ..primitives.keys import Ranges
from ..primitives.sync_point import SyncPoint
from ..primitives.timestamp import Ballot, TxnId, TxnKind
from ..primitives.txn import Seekables, Txn
from ..utils import async_ as au
from .coordinate_transaction import _CoordinateTransaction, _ExecuteTxn
from ..messages.txn_messages import Apply

if TYPE_CHECKING:
    from ..local.node import Node


def coordinate_inclusive(node: "Node", seekables: Seekables,
                         blocking: bool = False) -> au.AsyncResult:
    """Coordinate an inclusive sync point over ``seekables``
    (CoordinateSyncPoint.inclusive / inclusiveAndAwaitQuorum)."""
    return _coordinate(node, TxnKind.SYNC_POINT, seekables, blocking)


def coordinate_exclusive(node: "Node", ranges: Ranges,
                         blocking: bool = True,
                         txn_id: Optional[TxnId] = None) -> au.AsyncResult:
    """Coordinate an exclusive sync point over ``ranges``
    (CoordinateSyncPoint.exclusive; used by Bootstrap and durability rounds).
    ``txn_id`` may be pre-allocated by the caller (Bootstrap marks
    bootstrappedAt with it BEFORE coordinating)."""
    return _coordinate(node, TxnKind.EXCLUSIVE_SYNC_POINT, ranges,
                       blocking=blocking, txn_id=txn_id)


def _coordinate(node: "Node", kind: TxnKind, seekables: Seekables,
                blocking: bool, txn_id: Optional[TxnId] = None) -> au.AsyncResult:
    txn = Txn.empty(kind, seekables)
    if txn_id is None:
        txn_id = node.next_txn_id(kind, txn.domain)
    result = au.settable()

    def start(_v, f):
        if f is not None:
            result.set_failure(f)
            return
        route = node.compute_route(txn)
        _CoordinateSyncPoint(node, txn_id, txn, route, result, blocking).start()

    node.with_epoch(txn_id.epoch).begin(start)
    return result


class _CoordinateSyncPoint(_CoordinateTransaction):
    """Drives the standard pipeline but executes as a sync point."""

    def __init__(self, node: "Node", txn_id: TxnId, txn: Txn, route, result,
                 blocking: bool):
        super().__init__(node, txn_id, txn, route, result)
        self.blocking = blocking

    def on_preaccepted(self, tracker, oks) -> None:
        """CoordinateSyncPoint.onPreAccepted: deps merge from ALL replies; only
        a plain SyncPoint may take the fast path (exclusive always proposes);
        Accept-round deps are ignored (deps stay < txnId, so concurrent sync
        points' waits are acyclic)."""
        from ..primitives.deps import Deps
        from ..primitives.timestamp import Ballot as _Ballot
        execute_at = None
        for ok in oks.values():
            execute_at = ok.witnessed_at if execute_at is None \
                else execute_at.merge_max(ok.witnessed_at)
        if execute_at is not None and execute_at.is_rejected:
            from .errors import Invalidated
            self.result.set_failure(Invalidated(self.txn_id, "preaccept rejected"))
            return
        deps = Deps.merge([ok.deps for ok in oks.values()])
        from .coordinate_transaction import ExecutePath
        if tracker.has_fast_path_accepted() and self.txn_id.kind is TxnKind.SYNC_POINT:
            self.execute(ExecutePath.FAST, self.txn_id.as_timestamp(), deps)
        else:
            # sync points agree DEPS, never a bumped executeAt
            # (CoordinateSyncPoint.java): a fence's whole meaning is
            # "everything before txnId".  Proposing the merged witnessed_at
            # instead made the ACCEPT/recovery rounds recompute deps at the
            # HIGHER bound, pulling in later-started sync points — an
            # earlier fence then waited on a later one, which (correctly)
            # waited back on it: the wait-cycle anchor of the PRE_APPLIED
            # livelock class.  The epoch still extends to the witnessed
            # epoch so scopes cover churn.
            self.extend_to_epoch(
                execute_at,
                lambda: self.propose(_Ballot.ZERO,
                                     self.txn_id.as_timestamp(), deps))

    def merge_accept_deps(self, deps, accept_oks):
        return deps

    def execute(self, path: str, execute_at, deps) -> None:
        _ExecuteSyncPoint(self.node, self.txn_id, self.txn, self.route,
                          self.topologies, SaveStatus.STABLE, execute_at, deps,
                          self.result, require_stable_quorum=False,
                          blocking=self.blocking).start()

    def stabilise_and_execute(self, execute_at, deps, ballot=Ballot.ZERO) -> None:
        _ExecuteSyncPoint(self.node, self.txn_id, self.txn, self.route,
                          self.topologies, SaveStatus.STABLE, execute_at, deps,
                          self.result, require_stable_quorum=True, ballot=ballot,
                          blocking=self.blocking).start()


class _ExecuteSyncPoint(_ExecuteTxn):
    """ExecuteSyncPoint.java: same Stable round, but the result is the SyncPoint
    handle, applies are MAXIMAL (any replica can apply without prior state), and
    a blocking sync point resolves only once a quorum of every shard applied."""

    def __init__(self, *args, blocking: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.blocking = blocking

    def persist(self) -> None:
        sync_point = SyncPoint(self.txn_id, self.route, self.deps,
                               execute_at=self.execute_at)
        txn_result = self.txn.result(self.txn_id, self.execute_at, self.data)
        writes = self.txn.execute(self.txn_id, self.execute_at, self.data)
        if not self.blocking:
            self.result.set_success(sync_point)
            self.send_applies(writes, txn_result, Apply.MAXIMAL,
                              on_quorum_applied=lambda: (
                                  self.on_quorum_applied(sync_point),
                                  self.inform_durable()))
            return

        # blocking: the quorum must mean EXECUTED, not merely recorded — send
        # ApplyThenWaitUntilApplied, whose ack is deferred until the txn (and
        # hence its whole dependency set) has applied locally
        # (ExecuteSyncPoint.ExecuteBlocking, ExecuteSyncPoint.java)
        from ..messages.base import Callback, TxnRequest
        from ..messages.txn_messages import ApplyOk, ApplyThenWaitUntilApplied
        from .tracking import QuorumTracker, RequestStatus
        from .coordinate_transaction import _scope_ranges
        tracker = QuorumTracker(self.topologies)
        this = self
        state = {"done": False}

        def finish_ok():
            state["done"] = True
            if not this.result.is_done():
                this.result.set_success(sync_point)
            this.on_quorum_applied(sync_point)
            this.inform_durable()

        class AppliedCallback(Callback):
            def on_success(self, from_node: int, reply) -> None:
                if state["done"]:
                    return
                if not isinstance(reply, ApplyOk):
                    self.on_failure(from_node, RuntimeError(f"bad reply {reply!r}"))
                    return
                if tracker.record_success(from_node) is RequestStatus.SUCCESS:
                    finish_ok()

            def on_failure(self, from_node: int, failure: BaseException) -> None:
                if state["done"]:
                    return
                if tracker.record_failure(from_node) is RequestStatus.FAILED:
                    state["done"] = True
                    from .errors import Exhausted
                    if not this.result.is_done():
                        this.result.set_failure(Exhausted(this.txn_id, "apply quorum"))

        callback = AppliedCallback()
        for to in self.topologies.nodes():
            scope = TxnRequest.compute_scope(to, self.topologies, self.route)
            if scope is None:
                continue
            wait_for = TxnRequest.compute_wait_for_epoch(to, self.topologies)
            ranges = _scope_ranges(self.node, scope, self.topologies.current_epoch)
            self.node.send(to, ApplyThenWaitUntilApplied(
                self.txn_id, scope, wait_for, Apply.MAXIMAL, self.execute_at,
                self.deps.slice(ranges), self.txn.slice(ranges, include_query=False),
                writes.slice(ranges) if writes is not None else None,
                txn_result, route=self.route), callback)

    def on_quorum_applied(self, sync_point: SyncPoint) -> None:
        """Hook: exclusive sync points mark epochs closed / redundancy bounds
        here (wired by durability scheduling and bootstrap)."""
        if self.txn_id.kind is TxnKind.EXCLUSIVE_SYNC_POINT:
            participants = self.route.participants()
            if isinstance(participants, Ranges):
                self.node.on_exclusive_sync_point_applied(
                    self.txn_id, participants)
                # the applied fence witnessed every in-flight txn on these
                # ranges in the epochs below it: they are CLOSED to new
                # coordination (CoordinationAdapter exclusive sync point
                # epoch-closure, CoordinationAdapter.java:214-264)
                for e in range(self.node.topology.min_epoch, self.txn_id.epoch):
                    if self.node.topology.has_epoch(e):
                        self.node.on_epoch_closed(participants, e)
