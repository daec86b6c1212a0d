"""Per-transaction replica state.

Capability parity with ``accord.local.Command`` (Command.java:1-1824): the state a
replica holds for one TxnId — save status, route, partial txn/deps, ballots, executeAt,
writes/result, and the **WaitingOn** execution frontier initialised at Stable and
drained as dependencies apply.

The reference models each status tier as an immutable subclass; here Command is a
single mutable record mutated only inside its owning CommandStore (single-logical-
thread discipline, enforced by ``CommandStore.check_in_store``), with monotonicity
asserted on every transition.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Set

from ..primitives.deps import Deps
from ..primitives.route import Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from ..primitives.txn import PartialTxn, Writes
from ..utils.invariants import Invariants, check_state
from .status import Durability, SaveStatus, Status

if TYPE_CHECKING:
    from ..api.interfaces import Result


class WaitingOn:
    """The execution frontier of a Stable command (Command.java:1225-1320): the set
    of dependency TxnIds not yet locally applied/invalidated/pruned.  The reference
    encodes this as bitsets over the deps arrays; semantics here are identical with
    explicit sets (the TPU data plane batches frontier pops in ops.deps_kernels)."""

    __slots__ = ("waiting", "applied_or_invalidated")

    def __init__(self, waiting: Set[TxnId], applied_or_invalidated: Optional[Set[TxnId]] = None):
        self.waiting = waiting
        self.applied_or_invalidated = applied_or_invalidated if applied_or_invalidated is not None else set()

    @staticmethod
    def none() -> "WaitingOn":
        return WaitingOn(set())

    def is_waiting(self) -> bool:
        return bool(self.waiting)

    def is_waiting_on(self, txn_id: TxnId) -> bool:
        return txn_id in self.waiting

    def remove(self, txn_id: TxnId, applied: bool) -> bool:
        """Returns True if removed (was present)."""
        if txn_id in self.waiting:
            self.waiting.discard(txn_id)
            if applied:
                self.applied_or_invalidated.add(txn_id)
            return True
        return False

    def __repr__(self) -> str:
        return f"WaitingOn({len(self.waiting)} pending)"


class Command:
    __slots__ = (
        "txn_id", "save_status", "durability",
        "route", "partial_txn", "partial_deps",
        "promised", "accepted_or_committed",
        "execute_at", "execute_at_least", "writes", "result",
        "waiting_on", "listeners", "applied_locally", "elided_unapplied",
    )

    def __init__(self, txn_id: TxnId):
        self.txn_id = txn_id
        self.save_status = SaveStatus.NOT_DEFINED
        self.durability = Durability.NOT_DURABLE
        self.route: Optional[Route] = None
        self.partial_txn: Optional[PartialTxn] = None
        self.partial_deps: Optional[Deps] = None
        # promised: max ballot we have promised not to go below (recovery gate)
        self.promised: Ballot = Ballot.ZERO
        # accepted_or_committed: ballot at which executeAt/deps were accepted
        self.accepted_or_committed: Ballot = Ballot.ZERO
        self.execute_at: Optional[Timestamp] = None
        # awaits-only-deps txns (sync points) with a dependency deciding a
        # LATER executeAt defer their effective local execution past it
        # (WaitingOn.Update.updateExecuteAtLeast, Commands.java:727-728) —
        # ordinary waiters order against max(execute_at, execute_at_least),
        # which is what breaks the fence<->write wait cycle
        self.execute_at_least: Optional[Timestamp] = None
        self.writes: Optional[Writes] = None
        self.result = None
        self.waiting_on: Optional[WaitingOn] = None
        # commands locally waiting on us (by TxnId) — notified on status change
        self.listeners: Set[TxnId] = set()
        # True iff the DEPENDENCY-ORDERED apply path ran here (_apply_writes):
        # every dep's write is then locally present.  Truncated-with-outcome
        # copies that adopted/landed writes out of order stay False — serving
        # a read from them requires their gap to be stale-fenced.  Journaled:
        # a cache-miss fault-in must restore it, else evicted TRUNCATED_APPLY
        # copies refuse reads they can serve and recovery livelocks return.
        self.applied_locally: bool = False
        # WRITE dependency ids dropped from this command's WaitingOn WITHOUT
        # a local-apply proof at removal time — elided below a bootstrap
        # fence (the fetch snapshot covers them, but only once it lands) or
        # truncated without applying here.  Empty/None means the frontier
        # drained entirely through local applies, so the local MVCC snapshot
        # at executeAt is COMPLETE on the footprint — the grandfathered-serve
        # condition that lets reads ignore pending-bootstrap/stale marks a
        # LATER re-fence added (the seed-6 bootstrapping-refencing wedge).
        # Entries are re-checked (and pruned) at serve time: an elided dep
        # that has SINCE applied locally (or was delivered by a completed
        # bootstrap fetch) stops being a risk.  JOURNALED (harness/journal
        # _FIELDS) so crash-restart restores it for terminal commands, and
        # snapshotted into CommandSummary so cache-miss fault-ins restore
        # it — either gap launders a tainted floor dep clean.  ASSIGN-ONLY:
        # the journal's identity-diff skip keys on object identity.
        self.elided_unapplied: Optional[Set[TxnId]] = None

    # -- status queries -----------------------------------------------------
    @property
    def status(self) -> Status:
        return self.save_status.status

    def has_been(self, status: Status) -> bool:
        return self.save_status.has_been(status)

    def is_truncated(self) -> bool:
        return self.save_status.is_truncated

    def is_stable(self) -> bool:
        return self.has_been(Status.STABLE) and not self.save_status.is_truncated \
            and self.save_status is not SaveStatus.INVALIDATED

    def known(self):
        from .status import known_for
        return known_for(self.save_status,
                         self.route is not None,
                         self.partial_txn is not None)

    # -- ballot gates (Commands.java preacceptInternal/accept/recover) -------
    def can_proceed_with(self, ballot: Ballot) -> bool:
        return self.promised <= ballot

    # -- transitions (monotonicity enforced; callers are local.commands) -----
    def set_save_status(self, new_status: SaveStatus) -> None:
        check_state(new_status.ordinal >= self.save_status.ordinal
                    or self.save_status in (SaveStatus.READY_TO_EXECUTE, SaveStatus.APPLYING),
                    "status regression %s -> %s for %s", self.save_status, new_status, self.txn_id)
        self.save_status = new_status

    def execute_at_if_known(self) -> Optional[Timestamp]:
        return self.execute_at if self.has_been(Status.PRE_COMMITTED) else None

    def effective_execute_at(self) -> Optional[Timestamp]:
        """Execution-ordering timestamp as seen by waiters: executeAt, deferred
        past execute_at_least for awaits-only-deps commands."""
        if self.execute_at_least is not None and (
                self.execute_at is None or self.execute_at_least > self.execute_at):
            return self.execute_at_least
        return self.execute_at

    def __repr__(self) -> str:
        return f"Command({self.txn_id!r}, {self.save_status.name}, @{self.execute_at!r})"
