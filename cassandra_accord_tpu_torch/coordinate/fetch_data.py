"""Fetch missing knowledge about a txn from its peers and apply it locally.

Capability parity with ``accord.coordinate.FetchData`` / ``CheckShards``
(FetchData.java:1-255, CheckShards.java): gather ``CheckStatusOk`` from a quorum of
every shard the target participants intersect, merge the replies, and propagate the
merged knowledge into the local stores (the reference's Propagate).  The merged view
is also handed to the caller — MaybeRecover uses it both as its progress probe and
to reconstitute the txn body before escalating to full recovery.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Optional

from ..messages.base import Callback, TxnRequest
from ..messages.status_messages import CheckStatus, CheckStatusOk
from ..primitives.route import Route
from ..primitives.timestamp import TxnId
from ..utils import async_ as au
from .errors import Exhausted
from .tracking import QuorumTracker, RequestStatus

if TYPE_CHECKING:
    from ..local.node import Node


def check_status_quorum(node: "Node", txn_id: TxnId, route: Route,
                        include_info: bool = True) -> au.AsyncResult:
    """CheckStatus at a quorum of every intersecting shard; resolves with the
    merged CheckStatusOk.

    Gated on ``node.with_epoch(txn_id.epoch)`` (FetchData.java wraps the
    probe in ``node.withEpoch(srcEpoch, ...)``): a replica can learn of a
    blocked txn through deps/inform traffic BEFORE its config service has
    delivered the txn's epoch — under elastic membership the progress log
    then probes an epoch the local topology manager cannot slice yet, and
    ``precise_epochs`` throws instead of waiting.  When the epoch is already
    known ``with_epoch`` completes synchronously, so the gated path is
    byte-identical to the ungated one on every established trajectory.
    """
    result = au.settable()
    node.with_epoch(txn_id.epoch).begin(
        lambda _v, f: result.set_failure(f) if f is not None
        else _check_status_quorum(node, txn_id, route, include_info, result))
    return result


def _check_status_quorum(node: "Node", txn_id: TxnId, route: Route,
                         include_info: bool, result) -> None:
    topologies = node.topology.precise_epochs(route, txn_id.epoch, txn_id.epoch)
    tracker = QuorumTracker(topologies)
    merged: dict = {"ok": None}

    class StatusCallback(Callback):
        done = False

        def on_success(self, from_node: int, reply) -> None:
            if self.done:
                return
            if isinstance(reply, CheckStatusOk):
                merged["ok"] = reply if merged["ok"] is None else merged["ok"].merge(reply)
            if tracker.record_success(from_node) is RequestStatus.SUCCESS:
                self.done = True
                result.set_success(merged["ok"])

        def on_failure(self, from_node: int, failure: BaseException) -> None:
            if self.done:
                return
            if tracker.record_failure(from_node) is RequestStatus.FAILED:
                self.done = True
                result.set_failure(Exhausted(txn_id, "check-status quorum unreachable"))

    callback = StatusCallback()
    for to in tracker.nodes():
        scope = TxnRequest.compute_scope(to, topologies, route)
        if scope is None:
            continue
        node.send(to, CheckStatus(txn_id, scope,
                                  TxnRequest.compute_wait_for_epoch(to, topologies),
                                  include_info=include_info), callback)


def fetch_data(node: "Node", txn_id: TxnId, route: Route) -> au.AsyncResult:
    """Fetch whatever the cluster knows about ``txn_id`` over ``route``, apply it
    locally (Known upgrade), and resolve with the merged CheckStatusOk."""
    result = au.settable()

    def on_checked(merged: Optional[CheckStatusOk], failure):
        if failure is not None:
            result.set_failure(failure)
            return
        if merged is not None:
            target_route = merged.route if merged.route is not None else route
            merged.route = target_route
            # apply as a first-class LOCAL request (serializable, typed,
            # replayable — Propagate.java), and settle only when the
            # per-store application chain settles: every fetch_data listener
            # relies on the fetched knowledge being applied locally when it
            # fires (with delayed stores the application defers — settling
            # success immediately would leave the progress log checking
            # pre-propagation state and spuriously escalating to recovery).
            # Processed directly — NOT via node.receive, whose catch-all
            # would swallow an application failure and let the result settle
            # success over un-applied knowledge.
            from ..messages.base import LOCAL_NO_REPLY
            from ..messages.status_messages import Propagate
            try:
                applied = Propagate(txn_id, merged).process(
                    node, node.id, LOCAL_NO_REPLY)
            except BaseException as e:  # noqa: BLE001
                result.set_failure(e)
                return
            applied.add_listener(
                lambda _v, f: result.set_failure(f) if f is not None
                else result.set_success(merged))
            return
        result.set_success(merged)

    check_status_quorum(node, txn_id, route, include_info=True) \
        .to_chain().begin(on_checked)
    return result
