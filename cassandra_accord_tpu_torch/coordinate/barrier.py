"""Barriers over keys/ranges.

Capability parity with ``accord.coordinate.Barrier`` (Barrier.java:56-313):

- LOCAL: resolves once SOME transaction covering the scope, from the requested epoch
  or later, has locally applied — giving a local happens-after point.  If such a txn
  has already applied locally the barrier is immediate; otherwise an inclusive sync
  point is coordinated and awaited locally.
- GLOBAL_ASYNC: coordinates an inclusive sync point, resolving once it is stable
  (its dependency set is fixed); application proceeds in the background.
- GLOBAL_SYNC: as above, but resolves only once the sync point has applied at a
  quorum of every shard.

Resolves with the SyncPoint handle (or the local witness TxnId for the fast local
path, mirroring Barrier.java's BarrierTxn result).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from ..api.interfaces import BarrierType
from ..local.status import SaveStatus
from ..primitives.keys import Ranges
from ..primitives.timestamp import TxnId
from ..primitives.txn import Seekables
from ..utils import async_ as au
from . import sync_point as sp

if TYPE_CHECKING:
    from ..local.node import Node


def barrier(node: "Node", seekables: Seekables, min_epoch: int,
            barrier_type: BarrierType) -> au.AsyncResult:
    """Coordinate a barrier (Barrier.barrier).  Awaits ``min_epoch`` before
    coordinating so the sync point's TxnId (and hence its dependency set) is
    allocated at or after the requested epoch (Barrier.java withEpoch)."""
    result = au.settable()

    if barrier_type.is_global:
        def start_global(_v, f):
            if f is not None:
                result.set_failure(f)
                return
            inner = sp.coordinate_inclusive(
                node, seekables, blocking=barrier_type.wait_on_global_application)
            inner.add_listener(lambda v, f2: result.set_failure(f2) if f2 is not None
                               else result.set_success(v))

        node.with_epoch(min_epoch).begin(start_global)
        return result

    # LOCAL: fast path — some covering txn already applied locally at >= epoch
    witness = _find_local_witness(node, seekables, min_epoch)
    if witness is not None:
        result.set_success(witness)
        return result

    # slow path: coordinate an inclusive sync point, then await ITS local apply
    def start_local(_v, f):
        if f is not None:
            result.set_failure(f)
            return
        inner = sp.coordinate_inclusive(node, seekables, blocking=False)

        def on_sync_point(sync_point, failure):
            if failure is not None:
                result.set_failure(failure)
                return
            _await_local_apply(node, sync_point, result)

        inner.add_listener(on_sync_point)

    node.with_epoch(min_epoch).begin(start_local)
    return result


def _find_local_witness(node: "Node", seekables: Seekables, min_epoch: int):
    """An already-locally-applied txn covering the whole scope at >= min_epoch
    (Barrier.java's existing-txn fast path).  Scope must fall within one store."""
    unseekables = seekables if isinstance(seekables, Ranges) \
        else seekables.to_routing_keys()
    for store in node.command_stores.all_stores():
        ranges = store.current_ranges()
        if not ranges.contains_all(unseekables):
            continue
        # the covering txn we're looking for is applied — exactly the class
        # the cache-miss plane evicts; fault the cold set in for the scan
        for cold_id in list(store.cold):
            store.lookup(cold_id)
        best: TxnId = None
        for txn_id, command in store.commands.items():
            if command.save_status.ordinal < SaveStatus.APPLIED.ordinal \
                    or command.save_status.is_truncated \
                    or command.save_status is SaveStatus.INVALIDATED:
                continue
            if command.execute_at is None or command.execute_at.epoch < min_epoch:
                continue
            if command.route is None:
                continue
            parts = command.route.participants()
            covers = parts.contains_all(unseekables) if isinstance(parts, Ranges) \
                else (not isinstance(unseekables, Ranges)
                      and all(parts.contains(k) for k in unseekables))
            if covers and (best is None or txn_id > best):
                best = txn_id
        if best is not None:
            return best
    return None


def _await_local_apply(node: "Node", sync_point, result: au.Settable) -> None:
    """Resolve ``result`` with the sync point once it has applied in every
    intersecting LOCAL store."""
    from ..messages.txn_messages import await_applied_local
    txn_id = sync_point.txn_id

    def consume(outcome, failure):
        if failure is not None:
            result.set_failure(failure)
        elif outcome == "nack":
            from .errors import Invalidated
            result.set_failure(Invalidated(txn_id, "barrier sync point invalidated"))
        else:
            result.set_success(sync_point)

    await_applied_local(node, txn_id, sync_point.route, txn_id.epoch,
                        txn_id.epoch).begin(consume)
