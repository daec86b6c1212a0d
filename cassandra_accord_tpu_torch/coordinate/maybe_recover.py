"""Cheap liveness probe escalating to full recovery.

Capability parity with ``accord.coordinate.MaybeRecover`` + the standalone
``Invalidate`` coordination (MaybeRecover.java, Invalidate.java:1-297): probe the
cluster's knowledge of a txn via CheckStatus; if the txn has progressed past the
caller's last-seen ProgressToken, just report the new token (someone is making
progress — stand down).  Otherwise escalate: reconstitute the txn from the merged
partials and run full recovery, or — when the definition is unrecoverable because
the txn was never witnessed at a quorum — invalidate it so nothing can block on it
forever.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple, Optional

from ..local.status import Durability, SaveStatus, Status
from ..messages.status_messages import CheckStatusOk, propagate_knowledge
from ..primitives.route import Route
from ..primitives.timestamp import Ballot, TxnId
from ..utils import async_ as au
from .errors import Invalidated, Truncated
from .fetch_data import check_status_quorum
from .recover import invalidate as do_invalidate, recover as do_recover

if TYPE_CHECKING:
    from ..local.node import Node


class ProgressToken(NamedTuple):
    """(durability, status, promised) progress lattice (ProgressToken.java):
    any component advancing means someone, somewhere, is driving the txn."""
    durability: Durability = Durability.NOT_DURABLE
    status_ordinal: int = 0
    promised: Ballot = Ballot.ZERO

    @staticmethod
    def of(merged: CheckStatusOk) -> "ProgressToken":
        return ProgressToken(merged.durability, merged.save_status.ordinal,
                             merged.promised)

    def advanced_from(self, prev: Optional["ProgressToken"]) -> bool:
        if prev is None:
            return True
        return (self.durability > prev.durability
                or self.status_ordinal > prev.status_ordinal
                or self.promised > prev.promised)

    def advanced_materially_from(self, prev: Optional["ProgressToken"]) -> bool:
        """Durability/status advance only.  A promised ballot rising with no
        status movement is the signature of FAILED recovery attempts (mutual
        preemption), not of progress — monitors treating it as progress reset
        their backoff and keep the attempt rate high forever (the hostile
        chaos+churn burns livelocked on exactly this: ballots ratcheted for
        hundreds of sim-seconds with every replica READY_TO_EXECUTE)."""
        if prev is None:
            return True
        return (self.durability > prev.durability
                or self.status_ordinal > prev.status_ordinal)

    @property
    def is_done(self) -> bool:
        return self.status_ordinal >= SaveStatus.APPLIED.ordinal


class Outcome(NamedTuple):
    """What MaybeRecover concluded: the latest token, plus whether the txn is
    settled (applied / invalidated / truncated)."""
    token: ProgressToken
    settled: bool


def maybe_recover(node: "Node", txn_id: TxnId, route: Route,
                  prev_token: Optional[ProgressToken]) -> au.AsyncResult:
    """Probe; escalate to Recover/Invalidate only if nothing progressed since
    ``prev_token``.  Resolves with an Outcome (never with the txn's result — the
    caller is a progress log, not a client)."""
    result = au.settable()

    def on_checked(merged: Optional[CheckStatusOk], failure):
        if failure is not None:
            result.set_failure(failure)
            return
        if merged is None:
            merged = CheckStatusOk.empty(txn_id)
        token = ProgressToken.of(merged)
        status = merged.save_status
        if status.is_terminal or status.is_truncated:
            if merged.route is not None:
                propagate_knowledge(node, txn_id, merged)
            result.set_success(Outcome(token, settled=True))
            return
        if token.advanced_from(prev_token):
            result.set_success(Outcome(token, settled=False))
            return

        # stalled: escalate (RecoverWithRoute)
        txn = merged.full_txn()
        if merged.route is not None and merged.route.full:
            full_route = merged.route
        elif txn is not None:
            full_route = node.compute_route(txn)   # real footprint, not the hint
        else:
            full_route = route
        rec = au.settable()
        if txn is not None:
            do_recover(node, txn_id, txn, full_route, rec)
        else:
            # definition unrecoverable: nothing durably witnessed it — invalidate
            do_invalidate(node, txn_id, full_route, rec)

        def on_recovered(_value, rec_failure):
            if rec_failure is None or isinstance(rec_failure, (Invalidated, Truncated)):
                # recovered, durably invalidated, or already truncated (decided
                # and cleaned up): the txn is settled either way
                result.set_success(Outcome(
                    ProgressToken(token.durability, SaveStatus.APPLIED.ordinal,
                                  token.promised), settled=True))
            else:
                # preempted / timed out: report the probe token; caller retries
                result.set_success(Outcome(token, settled=False))
        rec.add_listener(on_recovered)

    check_status_quorum(node, txn_id, route, include_info=True) \
        .to_chain().begin(on_checked)
    return result
