"""ALL command state transitions.

Capability parity with ``accord.local.Commands`` (Commands.java:106-1293): static
functions operating on (SafeCommandStore, Command): preaccept, accept,
accept_invalidate, commit/precommit/stable, commit_invalidate, apply, maybe_execute,
the WaitingOn initialisation/update machinery, and durability marking.  Every
transition is ballot-gated and monotonic; listeners (dependent commands and transient
message waiters) are notified on every status change.
"""
from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Optional

from ..primitives.deps import Deps
from ..primitives.keys import Ranges
from ..primitives.route import Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId, TxnKind
from ..primitives.txn import PartialTxn, Writes
from ..protocol_batch.columns import ENGAGE_FLOOR
from ..utils.invariants import Invariants, check_state
from .cfk import InternalStatus, manages_execution
from .command import Command, WaitingOn
from .command_store import SafeCommandStore
from .status import Durability, SaveStatus, Status

if TYPE_CHECKING:
    from ..api.interfaces import Result


class AcceptOutcome(enum.Enum):
    SUCCESS = 0
    REDUNDANT = 1          # already progressed past this phase
    REJECTED_BALLOT = 2
    INSUFFICIENT = 3       # missing definition (recovery edge)
    TRUNCATED = 4


def _observe_transition(safe_store: SafeCommandStore, command: Command) -> None:
    """Report a just-applied SaveStatus transition to the run's flight
    recorder (observe.FlightRecorder) — the per-node/per-store txn lifecycle
    span plane.  Passive by contract: reads sim time, touches no RNG and
    schedules nothing (zero observer effect).  The live ``command`` and
    ``CommandStore`` ride along so the InvariantAuditor can read decision
    state (executeAt, deps, ballots, watermarks) at the transition — reads
    only; the recorder base class ignores them."""
    store = safe_store.store
    if store.batch_engine is not None:
        # the columnar mirror rides the SAME choke point: every SaveStatus
        # change flows through here, so the struct-of-arrays row is fresh at
        # every point a vectorized scan reads it (the exact-skip proofs in
        # protocol_batch/engine.py depend on this)
        store.batch_engine.note_transition(command)
    ss = command.save_status
    if ss.is_terminal:
        # terminal transitions reach the resolver's frontier mirror HERE, not
        # through register_witness: the witness path is gated behind cfk key
        # indexing, which refuses demoted-cold/pruned entries (and truncation
        # never re-registers at all) — the mirror then kept a stale STABLE
        # status and the kernel frontier reported the txn ready forever (the
        # one-sided device mirror leak, KNOWN_ISSUES round 6-11)
        store.resolver.note_terminal(
            command.txn_id, invalidated=ss is SaveStatus.INVALIDATED)
    obs = store.observer()
    if obs is not None:
        obs.on_transition(store.node.id, store.id, command.txn_id,
                          command.save_status.name,
                          safe_store.time().now_micros(),
                          command=command, command_store=store)


# ---------------------------------------------------------------------------
# PreAccept (Commands.java:113)
# ---------------------------------------------------------------------------

def _is_shard_redundant(safe_store: SafeCommandStore, txn_id: TxnId,
                        route: Optional[Route]) -> bool:
    """Erased-tombstone guard: a txn below the shard-applied watermark on its
    whole footprint was applied (with everything before it) at a quorum; late
    messages about it must not resurrect state (Commands' redundantBefore
    checks / ErasedSafeCommand semantics)."""
    if route is None:
        return False
    return safe_store.redundant_before().is_shard_redundant(
        txn_id, route.participants())


def preaccept(safe_store: SafeCommandStore, txn_id: TxnId, partial_txn: PartialTxn,
              route: Route, ballot: Ballot = Ballot.ZERO) -> AcceptOutcome:
    """Witness the txn; propose witnessedAt = txnId if no conflict is later, else a
    fresh unique timestamp greater than every conflict (PreAccept.java:245-267)."""
    if _is_shard_redundant(safe_store, txn_id, route):
        return AcceptOutcome.TRUNCATED
    command = safe_store.get_or_create(txn_id)
    if command.save_status.is_truncated:
        return AcceptOutcome.TRUNCATED
    if command.has_been(Status.PRE_ACCEPTED):
        # duplicate delivery / recovery re-preaccept: report current state
        if ballot < command.promised:
            return AcceptOutcome.REJECTED_BALLOT
        return AcceptOutcome.REDUNDANT
    if ballot < command.promised:
        return AcceptOutcome.REJECTED_BALLOT

    command.route = route if command.route is None else command.route.union(route)
    command.partial_txn = partial_txn
    command.promised = command.promised.merge_max(ballot)

    # timestamp proposal
    keys = partial_txn.keys if not isinstance(partial_txn.keys, Ranges) else None
    ranges = partial_txn.keys if isinstance(partial_txn.keys, Ranges) else None
    max_conflict = safe_store.max_conflict(keys, ranges)
    if max_conflict is None or max_conflict < txn_id:
        command.execute_at = txn_id.as_timestamp()
    else:
        command.execute_at = safe_store.time().unique_now_at_least(max_conflict)
    command.set_save_status(SaveStatus.PRE_ACCEPTED)
    _observe_transition(safe_store, command)
    safe_store.register_witness(command, InternalStatus.PREACCEPTED)
    safe_store.progress_log().pre_accepted(command, _is_progress_shard(safe_store, command))
    safe_store.journal_save(command)
    safe_store.notify_listeners(command)
    return AcceptOutcome.SUCCESS


# ---------------------------------------------------------------------------
# Recover (Commands.java:118)
# ---------------------------------------------------------------------------

def recover(safe_store: SafeCommandStore, txn_id: TxnId, partial_txn: PartialTxn,
            route: Route, ballot: Ballot) -> AcceptOutcome:
    """Ballot-gated recovery witness: promise ``ballot`` (refusing lower-ballot
    coordinators) and pre-accept the txn if this replica never witnessed it
    (Commands.java:118).  The caller then reports this replica's full evidence
    (status, accepted ballot, deps, fast-path rejection) via RecoverOk."""
    command = safe_store.get_or_create(txn_id)
    if command.save_status.is_truncated:
        return AcceptOutcome.TRUNCATED
    if ballot < command.promised:
        return AcceptOutcome.REJECTED_BALLOT
    command.promised = command.promised.merge_max(ballot)
    if not command.has_been(Status.PRE_ACCEPTED):
        outcome = preaccept(safe_store, txn_id, partial_txn, route, ballot)
        if outcome is AcceptOutcome.TRUNCATED:
            # the region (or the txn) is below this store's redundancy bound:
            # report truncated — asserting here kills the reply and starves the
            # recovery quorum forever
            return AcceptOutcome.TRUNCATED
        check_state(outcome is AcceptOutcome.SUCCESS,
                    "recovery preaccept failed with %s", outcome)
    return AcceptOutcome.SUCCESS


# ---------------------------------------------------------------------------
# Accept — slow-path proposal (Commands.java:202)
# ---------------------------------------------------------------------------

def accept(safe_store: SafeCommandStore, txn_id: TxnId, ballot: Ballot, route: Route,
           execute_at: Timestamp, partial_deps: Deps) -> AcceptOutcome:
    if _is_shard_redundant(safe_store, txn_id, route):
        # GC physically erased this txn (applied at every replica, below the
        # shard fence): a LATE Accept — chaos latencies reach seconds — must
        # not re-create it fresh at ballot zero (the auditor catches the
        # resurrection as a promised-ballot regression; stale re-created
        # ACCEPTED evidence is the round-3/4 unsound-recovery shape)
        return AcceptOutcome.TRUNCATED
    command = safe_store.get_or_create(txn_id)
    if command.save_status.is_truncated:
        return AcceptOutcome.TRUNCATED
    if command.has_been(Status.PRE_COMMITTED):
        return AcceptOutcome.REDUNDANT
    if ballot < command.promised:
        return AcceptOutcome.REJECTED_BALLOT

    command.route = route if command.route is None else command.route.union(route)
    command.promised = command.promised.merge_max(ballot)
    command.accepted_or_committed = ballot
    command.execute_at = execute_at
    command.partial_deps = partial_deps
    command.set_save_status(SaveStatus.ACCEPTED)
    _observe_transition(safe_store, command)
    safe_store.register_witness(command, InternalStatus.ACCEPTED)
    safe_store.progress_log().accepted(command, _is_progress_shard(safe_store, command))
    safe_store.journal_save(command)
    safe_store.notify_listeners(command)
    return AcceptOutcome.SUCCESS


def accept_invalidate(safe_store: SafeCommandStore, txn_id: TxnId, ballot: Ballot,
                      scope: Optional[Route] = None) -> AcceptOutcome:
    """Promise not to accept anything below ballot, voting for invalidation
    (Commands.java:250)."""
    if _is_shard_redundant(safe_store, txn_id, scope):
        # GC erased this txn because it (and everything before it) durably
        # applied at every replica — answering NOT_DEFINED here would let a
        # quorum of erased replicas invalidate an already-applied txn
        # (ErasedSafeCommand tombstone semantics)
        return AcceptOutcome.TRUNCATED
    command = safe_store.get_or_create(txn_id)
    if command.save_status.is_truncated:
        return AcceptOutcome.TRUNCATED
    if command.has_been(Status.PRE_COMMITTED):
        return AcceptOutcome.REDUNDANT
    if ballot < command.promised:
        return AcceptOutcome.REJECTED_BALLOT
    command.promised = command.promised.merge_max(ballot)
    # the invalidation vote is an ACCEPT-phase decision at ``ballot``: recovery
    # must rank it against competing Accepts BY BALLOT (an AcceptedInvalidate
    # at a later ballot supersedes an Accept at an earlier one — otherwise a
    # recoverer re-proposes the txn while the invalidator commit-invalidates)
    command.accepted_or_committed = command.accepted_or_committed.merge_max(ballot)
    if command.save_status < SaveStatus.ACCEPTED_INVALIDATE:
        command.set_save_status(SaveStatus.ACCEPTED_INVALIDATE)
        _observe_transition(safe_store, command)
    safe_store.journal_save(command)
    safe_store.notify_listeners(command)
    return AcceptOutcome.SUCCESS


# ---------------------------------------------------------------------------
# Commit / Stable (Commands.java:289,353)
# ---------------------------------------------------------------------------

class CommitOutcome(enum.Enum):
    SUCCESS = 0
    REDUNDANT = 1
    REJECTED_BALLOT = 2
    INSUFFICIENT = 3


def precommit(safe_store: SafeCommandStore, txn_id: TxnId, execute_at: Timestamp) -> CommitOutcome:
    """Mark executeAt agreed without deps (Commands.java:353)."""
    command = safe_store.get_or_create(txn_id)
    if command.has_been(Status.PRE_COMMITTED):
        _check_consistent_execute_at(safe_store, command, execute_at)
        return CommitOutcome.REDUNDANT
    command.execute_at = execute_at
    command.set_save_status(SaveStatus.PRE_COMMITTED)
    _observe_transition(safe_store, command)
    safe_store.journal_save(command)
    safe_store.progress_log().precommitted(command)
    safe_store.notify_listeners(command)
    return CommitOutcome.SUCCESS


def commit(safe_store: SafeCommandStore, txn_id: TxnId, save_status: SaveStatus,
           ballot: Ballot, route: Route, partial_txn: Optional[PartialTxn],
           execute_at: Timestamp, partial_deps: Deps) -> CommitOutcome:
    """CommitSlowPath (-> COMMITTED) or Stable* (-> STABLE + initialise WaitingOn +
    maybe_execute) — Commands.java:289."""
    check_state(save_status in (SaveStatus.COMMITTED, SaveStatus.STABLE),
                "commit called with %s", save_status)
    if _is_shard_redundant(safe_store, txn_id, route):
        return CommitOutcome.REDUNDANT
    command = safe_store.get_or_create(txn_id)
    if command.save_status.is_truncated or command.save_status is SaveStatus.INVALIDATED:
        return CommitOutcome.REDUNDANT
    if save_status is SaveStatus.COMMITTED and command.has_been(Status.COMMITTED):
        _check_consistent_execute_at(safe_store, command, execute_at)
        return CommitOutcome.REDUNDANT
    if command.has_been(Status.STABLE):
        _check_consistent_execute_at(safe_store, command, execute_at)
        return CommitOutcome.REDUNDANT
    if ballot < command.promised:
        return CommitOutcome.REJECTED_BALLOT

    command.route = route if command.route is None else command.route.union(route)
    if partial_txn is not None:
        command.partial_txn = partial_txn if command.partial_txn is None \
            else command.partial_txn.with_merged(partial_txn)
    if command.partial_txn is None:
        return CommitOutcome.INSUFFICIENT
    command.accepted_or_committed = command.accepted_or_committed.merge_max(ballot)
    command.execute_at = execute_at
    command.partial_deps = partial_deps
    command.set_save_status(save_status)
    _observe_transition(safe_store, command)
    safe_store.register_witness(command, InternalStatus.COMMITTED if save_status is SaveStatus.COMMITTED
                                else InternalStatus.STABLE)
    safe_store.journal_save(command)
    if save_status is SaveStatus.STABLE:
        initialise_waiting_on(safe_store, command)
        safe_store.progress_log().stable(command, _is_progress_shard(safe_store, command))
        maybe_execute(safe_store, command, always_notify_listeners=True)
    else:
        safe_store.notify_listeners(command)
    return CommitOutcome.SUCCESS


def adopt_truncated_outcome(safe_store: SafeCommandStore, command: Command,
                            route: Route, execute_at: Timestamp, writes,
                            result) -> None:
    """The cluster truncated this txn AFTER it applied and the outcome is still
    carried (TRUNCATE_WITH_OUTCOME): a lagging replica adopts it directly —
    writes land out of dependency order (safe: the data store orders entries by
    executeAt and applies idempotently; reads snapshot at their own executeAt)
    and the command becomes a truncated tombstone, unblocking local waiters
    (the reference's Propagate handling of truncated evidence, Propagate.java;
    Infer.safeToCleanup)."""
    command.route = route if command.route is None else command.route
    command.execute_at = execute_at
    command.writes = writes
    command.result = result

    def post(_=None, failure=None):
        if failure is not None:
            safe_store.agent().on_uncaught_exception(failure)
            return
        # adoption lands writes out of dependency order: merge the per-key
        # registers monotonically, no validation (the safeToReadAt-gated
        # case).  Owned keys only — unowned registry entries would never GC
        # (shard_redundant_before has no bound for them)
        if writes is not None and not writes.is_empty():
            _merge_applied_writes(safe_store.store, writes, execute_at)
        command.partial_txn = None
        command.partial_deps = None
        command.waiting_on = None
        command.set_save_status(SaveStatus.TRUNCATED_APPLY)
        _observe_transition(safe_store, command)
        safe_store.journal_save(command)
        safe_store.register_witness(command, InternalStatus.APPLIED)
        safe_store.progress_log().clear(command.txn_id)
        safe_store.notify_listeners(command)

    if writes is None or writes.is_empty():
        post()
    else:
        writes.apply_to(safe_store, safe_store.store.all_ranges()).begin(post)


def commit_invalidate(safe_store: SafeCommandStore, txn_id: TxnId,
                      scope: Optional[Route] = None) -> None:
    """Commands.java:434."""
    if _is_shard_redundant(safe_store, txn_id, scope):
        return   # erased-tombstone guard: the txn durably applied everywhere
    command = safe_store.get_or_create(txn_id)
    if command.has_been(Status.PRE_COMMITTED) and command.save_status is not SaveStatus.INVALIDATED:
        # a txn cannot be both committed and invalidated
        safe_store.agent().on_inconsistent_timestamp(command, command.execute_at, None)
        return
    if command.save_status is SaveStatus.INVALIDATED:
        return
    command.set_save_status(SaveStatus.INVALIDATED)
    _observe_transition(safe_store, command)
    safe_store.journal_save(command)
    safe_store.register_witness(command, InternalStatus.INVALIDATED)
    safe_store.progress_log().invalidated(command, _is_progress_shard(safe_store, command))
    safe_store.notify_listeners(command)


def _merge_applied_writes(store, writes, execute_at) -> None:
    """Merge a write's per-key execution registers monotonically, without
    write-order validation (out-of-dependency-order landings: truncation
    adoption, restart replay).  Owned keys only — unowned registry entries
    would never GC (shard_redundant_before has no bound for them)."""
    tfk = store.timestamps_for_key
    owned = store.all_ranges()
    for key in writes.keys:
        rk = key.to_routing() if hasattr(key, "to_routing") else key
        if owned.contains(rk):
            tfk.merge_applied_write(key, execute_at)


# ---------------------------------------------------------------------------
# Apply (Commands.java:462)
# ---------------------------------------------------------------------------

def apply_(safe_store: SafeCommandStore, txn_id: TxnId, route: Route,
           execute_at: Timestamp, partial_deps: Optional[Deps],
           partial_txn: Optional[PartialTxn], writes: Optional[Writes], result) -> CommitOutcome:
    if _is_shard_redundant(safe_store, txn_id, route):
        return CommitOutcome.REDUNDANT
    command = safe_store.get_or_create(txn_id)
    if command.save_status.is_truncated or command.save_status is SaveStatus.INVALIDATED:
        return CommitOutcome.REDUNDANT
    if command.has_been(Status.PRE_APPLIED):
        _check_consistent_execute_at(safe_store, command, execute_at)
        return CommitOutcome.REDUNDANT

    command.route = route if command.route is None else command.route.union(route)
    if partial_txn is not None and command.partial_txn is None:
        command.partial_txn = partial_txn
    if partial_deps is not None and command.partial_deps is None:
        command.partial_deps = partial_deps
    if command.partial_deps is None:
        return CommitOutcome.INSUFFICIENT
    command.execute_at = execute_at
    command.writes = writes
    command.result = result
    if command.waiting_on is None:
        initialise_waiting_on(safe_store, command)
    command.set_save_status(SaveStatus.PRE_APPLIED)
    _observe_transition(safe_store, command)
    safe_store.journal_save(command)
    safe_store.register_witness(command, InternalStatus.COMMITTED)
    maybe_execute(safe_store, command, always_notify_listeners=True)
    return CommitOutcome.SUCCESS


# ---------------------------------------------------------------------------
# Execution frontier (Commands.java:617-804)
# ---------------------------------------------------------------------------

def initialise_waiting_on(safe_store: SafeCommandStore, command: Command) -> None:
    """Build the WaitingOn frontier from partial_deps (Commands.java:688):
    include every dep not yet locally applied/invalidated whose executeAt is (or may
    yet be) before ours; register as listener on each."""
    if command.waiting_on is not None:
        return
    execute_at = command.execute_at
    waiting = set()
    deferred = False
    local_ranges = safe_store.store.all_ranges()
    deps = command.partial_deps.slice(local_ranges) if command.partial_deps is not None else Deps.NONE
    redundant = safe_store.redundant_before()
    # fast path: any dep below the store-wide minimum LOCAL fence is redundant
    # without a per-dep participants scan
    min_fence = None
    have_fence = True
    for rng in local_ranges:
        f = redundant.min_fence_over(rng, local_only=True)
        if f is None:
            have_fence = False
            break
        min_fence = f if min_fence is None or f < min_fence else min_fence
    min_fence = min_fence if have_fence else None
    awaits_only = command.txn_id.awaits_only_deps
    dep_ids = deps.txn_ids()
    engine = safe_store.store.batch_engine
    blocks_mask = decided_mask = None
    if engine is not None and len(dep_ids) >= ENGAGE_FLOOR:
        # the columnar frontier-init pass: one vectorized gather answers
        # _still_blocks for every dep the mirror can decide (terminal rows,
        # decided executeAt orderings); the rest fall through to the scalar
        # predicate.  Dep states are stable across this loop (it mutates
        # only the waiter and creates NOT_DEFINED stubs), so the mask
        # computed up front stays valid.
        blocks_mask, decided_mask = engine.still_blocks_mask(
            dep_ids, execute_at, awaits_only)
    for i, dep_id in enumerate(dep_ids):
        if dep_id == command.txn_id:
            continue
        if awaits_only and command.txn_id < dep_id:
            # fences (exclusive sync points) take deps only on LOWER ids: a
            # higher-id dep is structurally impossible and waiting on one
            # builds a cycle with the later fence that (correctly) waits on
            # us — defense in depth against any deps path that computed at a
            # bound above txnId
            continue
        # removeRedundantDependencies (Commands.java:704-705): deps below the
        # locally-redundant bound have applied (or are subsumed by bootstrap)
        if min_fence is not None and dep_id < min_fence:
            # the fence may be a bootstrap mark whose fetch has not landed:
            # without a local-apply proof the dep's write is not provably in
            # the local snapshot — note it (the read-serve path re-checks)
            _note_elided_unless_applied(safe_store, command, dep_id)
            continue
        dep_parts = deps.participants(dep_id)
        if dep_parts is not None and redundant.is_locally_redundant(dep_id, dep_parts):
            _note_elided_unless_applied(safe_store, command, dep_id)
            continue
        if dep_parts is not None and not _participates_at_epoch(
                safe_store, dep_id, dep_parts,
                max_epoch=execute_at.epoch if execute_at is not None else None):
            # this store owns none of the dep's footprint at ANY epoch the
            # dep can execute in — [dep.txnId.epoch, OUR executeAt.epoch]:
            # the dep executes before us, so its executeAt epoch is bounded
            # by ours — so its Apply will never be addressed HERE and
            # waiting would deadlock topology-spanning commands
            # (StoreParticipants execution gating).  Judging by the TXN
            # epoch alone dropped epoch-spanning slow-path deps at stores
            # that joined the range by the EXECUTION epoch — their applies
            # DO arrive here, and executing without them served reads
            # missing their writes (the 15-node elastic cycle: op 186's
            # read of k58 missed op 181, txn epoch 5 executed at epoch 9).
            _note_elided_unless_applied(safe_store, command, dep_id)
            continue
        if bool(blocks_mask[i]) if (decided_mask is not None
                                    and decided_mask[i]) \
                else _still_blocks(safe_store, command, dep_id, execute_at):
            waiting.add(dep_id)
            dep = safe_store.get_or_create(dep_id)
            dep.listeners.add(command.txn_id)
            deferred |= _maybe_defer_execute_at_least(safe_store, command, dep,
                                                     notify=False)
        else:
            dep = safe_store.store.commands.get(dep_id)
            executes_after = dep is not None \
                and dep.has_been(Status.PRE_COMMITTED) \
                and dep.effective_execute_at() is not None \
                and execute_at is not None \
                and dep.effective_execute_at() >= execute_at
            if not executes_after:
                _note_elided_unless_applied(safe_store, command, dep_id)
    command.waiting_on = WaitingOn(waiting)
    # mirror the wait edges into the resolver's execution-frontier plane
    safe_store.store.resolver.register_waiting(command.txn_id, waiting)
    if engine is not None:
        engine.note_waiting(command)   # deps row pointer (frontier width)
    if deferred:
        safe_store.notify_listeners(command)


def _participates_at_epoch(safe_store: SafeCommandStore, dep_id: TxnId,
                           dep_parts, max_epoch: Optional[int] = None) -> bool:
    """Does this store own any of the dep's footprint at any epoch the dep
    can apply in — [dep.txnId.epoch, max_epoch]?  ``max_epoch`` is the
    WAITER's execution epoch (the dep executes before the waiter, so its
    executeAt epoch is bounded by it); None restricts to the dep's own
    epoch.  Applies are addressed to the replicas of every epoch in
    [txnId.epoch, executeAt.epoch], so ownership anywhere in the window
    means the apply may land here and is worth waiting for."""
    store = safe_store.store
    hi = dep_id.epoch if max_epoch is None else max(dep_id.epoch, max_epoch)
    owned = Ranges.EMPTY
    for e in range(dep_id.epoch, hi + 1):
        owned = owned.union(store.ranges_at(e))
    if not owned:
        return False
    keys, rngs = dep_parts
    for k in keys:
        if owned.contains(k):
            return True
    for r in rngs:
        if owned.intersects(Ranges.of(r)):
            return True
    return False


def _maybe_defer_execute_at_least(safe_store: SafeCommandStore, waiter: Command,
                                  dep: Command, notify: bool = True) -> bool:
    """An awaits-only-deps waiter (sync point) whose dep decided an executeAt
    AFTER the waiter's id defers its effective execution past that dep
    (updateExecuteAtLeast, Commands.java:727-728).  Ordinary txns then order
    against the DEFERRED time and stop waiting on the sync point — breaking
    the fence→later-write→earlier-write→fence wait cycle."""
    if not waiter.txn_id.awaits_only_deps:
        return False
    if not dep.has_been(Status.PRE_COMMITTED) or dep.execute_at is None:
        return False
    if dep.execute_at > waiter.txn_id.as_timestamp():
        cur = waiter.execute_at_least
        if cur is None or dep.execute_at > cur:
            waiter.execute_at_least = dep.execute_at
            if notify:
                # waiters ordering against us must re-evaluate
                safe_store.notify_listeners(waiter)
            return True
    return False


def _still_blocks(safe_store: SafeCommandStore, command: Command, dep_id: TxnId,
                  execute_at: Timestamp) -> bool:
    from ..primitives.timestamp import TxnKind as _TK
    if dep_id.kind is _TK.READ:
        # MVCC execution rule: a read-only dependency WRITES nothing, so its
        # local apply contributes nothing to any later txn's snapshot — and
        # the read itself stays servable at its own executeAt from the
        # timestamped store no matter what applies above it (the same
        # property the applied-copy exclusive-snapshot serve relies on).
        # The reference (ReadData over a non-versioned store) must order
        # writes after reads; here that edge is pure liveness surface: under
        # churn it is THE seed-6 wedge — a client range read that cannot
        # assemble partial coverage blocks every later write AND the
        # bootstrap fence sync points, whose pending ranges are exactly why
        # the read lacks coverage.  Reads still wait on THEIR deps (writes
        # below their snapshot); nothing waits on reads.
        return False
    if dep_id in safe_store.store.cold:
        # eviction admits only terminal commands (applied/invalidated/
        # truncated), none of which block — answering from the cold set
        # avoids a full journal decode per dep on every WaitingOn build
        return False
    dep = safe_store.get_if_exists(dep_id)
    if dep is None:
        return True  # unwitnessed: must wait for it to commit locally
    if dep.save_status in (SaveStatus.APPLIED, SaveStatus.INVALIDATED) \
            or dep.save_status.is_truncated:
        return False
    if dep.has_been(Status.PRE_COMMITTED) and not command.txn_id.awaits_only_deps:
        dep_ea = dep.effective_execute_at()
        # >= not >: genuine executeAts of distinct txns are never equal
        # (unique_now hlc+node tiebreak), so equality can only mean the dep
        # is a sync point DEFERRED to exactly our executeAt
        # (updateExecuteAtLeast adopting dep.execute_at) — it waits on OUR
        # apply and executes after us.  Treating the tie as blocking built a
        # permanent write<->fence wait cycle (the PRE_APPLIED-backlog stall
        # root, found by the restart-matrix stall watchdog: W [STABLE]
        # waiting_on=[X], X [PRE_APPLIED] waiting_on=[W]).
        if dep_ea is not None and dep_ea >= execute_at:
            return False  # dep executes (or was deferred to execute) after us
    return True


def _writes_cover_owned_footprint(store, footprint, written_keys) -> bool:
    """Does a locally-APPLIED dep's writes slice (``written_keys``: routing
    keys, or None when the payload is stripped) cover every part of its
    footprint this store owns (in ANY epoch)?  "Applied" is per-SLICE: a
    store that held only part of the dep's payload (it owned only part of
    the footprint at the dep's epochs) applied only that part — a slice it
    adopted LATER never got its write (that arrives with the bootstrap
    fetch), and the partial apply must not certify it (seed-6 trajectory:
    node 1's other-key-only APPLY of op 12 certified the k285 write it
    never held, and a read served over the pending fetch missed v12.1)."""
    if footprint is None:
        return False
    from ..primitives.keys import Ranges as _Ranges
    owned = store.all_ranges()
    if isinstance(footprint, _Ranges):
        # range-domain writes carry no per-key payload to compare; only an
        # empty owned overlap is trivially covered
        return not owned.intersects(footprint)
    for key in footprint:
        rk = key.to_routing() if hasattr(key, "to_routing") else key
        if owned.contains(rk) and (written_keys is None
                                   or rk not in written_keys):
            return False
    return True


def _written_routing_keys(writes):
    if writes is None:
        return None
    # memoized on the (immutable) Writes object: the writes-cover check runs
    # once per dep per waiter on the frontier-init/elision path, and
    # rebuilding this set per call was a measured wall slice
    rk = writes._rk
    if rk is None:
        rk = writes._rk = {k.to_routing() if hasattr(k, "to_routing") else k
                           for k in writes.keys}
    return rk


def _dep_full_footprint(cmd):
    """The dep's FULL footprint for the writes-cover check: the route (which
    travels whole) — the partial_txn is SLICED to what this store received,
    so judging coverage by it would certify exactly the slices the store
    never held (the hole the check exists to close)."""
    if cmd.route is not None:
        return cmd.route.participants()
    return cmd.partial_txn.keys if cmd.partial_txn is not None else None


def _dep_applied_locally(store, dep_id: TxnId) -> bool:
    """Is ``dep_id``'s write provably in THIS store's data (or provably
    nonexistent)?  APPLIED / applied_locally means the dependency-ordered
    apply ran here — for the SLICE the store held (checked against the
    writes payload, see _writes_cover_owned_footprint); INVALIDATED writes
    nothing.  Cold deps answer from their terminal summaries (which carry
    applied_locally and the writes cover) without a fault-in.  A dep that
    applied while still carrying unresolved elisions of its own does NOT
    count: its write landed but the fence floor-dep it stood in for may
    cover predecessors that did not (transitive contamination)."""
    from .status import SaveStatus as _SS
    if dep_id in store.cold:
        summary = store.cold_summaries.get(dep_id)
        if summary is None:
            return False
        if summary.save_status is _SS.INVALIDATED:
            # an INVALIDATED write/read never happened — clean; an
            # INVALIDATED sync point is an ABANDONED fence whose barrier
            # claim never materialized, yet it may have been handed out as
            # the floor dep standing in for writes elided below its
            # (pre-marked) bootstrapped_at bound — those writes are
            # unaccounted, so the floor stays unresolved (seed-6 v9..v85
            # prefix loss rode an abandoned-fence floor removal)
            return not dep_id.kind.is_sync_point
        applied = summary.save_status is _SS.APPLIED or summary.applied_locally
        if not applied:
            return False
        if dep_id.is_write:
            # a WRITE dep resolves on its own write's local presence; its
            # OWN elided predecessors are NOT inherited — any of them that
            # conflict with the waiter below the waiter's executeAt are in
            # the WAITER's deps (directly or via floors) and accounted for
            # separately.  Inheriting them built never-resolving taint
            # chains through applied writes (the seed-8 liveness wedge).
            return _writes_cover_owned_footprint(store, summary.full_footprint,
                                                 summary.written_keys)
        # sync points write nothing: applied with no unresolved elisions IS
        # the (per-store) barrier claim — everything below it on its local
        # slice applied here.  A floor with unresolved elisions stays
        # unresolved: it STANDS IN for exactly those writes.
        return not summary.elided_unapplied
    dep = store.commands.get(dep_id)
    if dep is None:
        return False
    if dep.save_status is _SS.INVALIDATED:
        # abandoned fences are NOT clean: see the cold-summary branch above
        return not dep_id.kind.is_sync_point
    applied = dep.save_status is _SS.APPLIED or dep.applied_locally
    if not applied:
        return False
    if dep_id.is_write:
        return _writes_cover_owned_footprint(store, _dep_full_footprint(dep),
                                             _written_routing_keys(dep.writes))
    return not dep.elided_unapplied


def _note_elided_unless_applied(safe_store: SafeCommandStore, command: Command,
                                dep_id: TxnId) -> None:
    """Record a WaitingOn drop that lacks a local-apply proof.  Read deps
    never matter (they contribute nothing to any snapshot); WRITES do, and
    so do SYNC POINTS — a fence floor dep STANDS IN for the write deps the
    deps calculation elided below it, so dropping a fence whose own
    elisions are unresolved inherits the risk (transitive: the seed-6
    v12.1 loss rode exactly this — the bootstrap fence replaced the write
    in the waiter's deps and was itself applied mid-fetch)."""
    from ..primitives.timestamp import TxnKind as _TK
    if dep_id.kind is _TK.READ:
        return
    if _dep_applied_locally(safe_store.store, dep_id):
        return
    # ASSIGN-ONLY (never mutate in place): the journal's identity-diff skip
    # keys on object identity, and an in-place add would silently journal a
    # stale set (harness/journal.py _FIELDS note)
    prev = command.elided_unapplied or frozenset()
    if dep_id not in prev:
        command.elided_unapplied = set(prev) | {dep_id}


def update_dependency_and_maybe_execute(safe_store: SafeCommandStore, waiter: Command,
                                        dep: Command) -> None:
    """Called when ``dep`` changes status and ``waiter`` is listening
    (Commands.java:777)."""
    if waiter.waiting_on is None or not waiter.waiting_on.is_waiting_on(dep.txn_id):
        return
    _maybe_defer_execute_at_least(safe_store, waiter, dep)
    if not _still_blocks(safe_store, waiter, dep.txn_id, waiter.execute_at):
        applied = dep.save_status is SaveStatus.APPLIED or dep.save_status.is_truncated
        dep_ea = dep.effective_execute_at()
        executes_after = dep.has_been(Status.PRE_COMMITTED) \
            and dep_ea is not None and waiter.execute_at is not None \
            and dep_ea >= waiter.execute_at \
            and dep.save_status is not SaveStatus.APPLIED \
            and not dep.save_status.is_truncated
        if not executes_after:
            _note_elided_unless_applied(safe_store, waiter, dep.txn_id)
        waiter.waiting_on.remove(dep.txn_id, applied)
        safe_store.store.resolver.remove_waiting(waiter.txn_id, dep.txn_id)
        # (the columnar mirror's ``waiting`` column deliberately keeps the
        # INIT-time frontier width — it is a layout/diagnostic plane, no
        # decision reads it, and a per-edge refresh here was measured pure
        # overhead on the release fan-out path)
        dep.listeners.discard(waiter.txn_id)
        maybe_execute(safe_store, waiter, always_notify_listeners=False)


def _root_blocker(safe_store: SafeCommandStore, command: Command):
    """Walk the LOCAL dependency graph down from ``command`` to a root blocker:
    a txn that is not itself locally waiting on anything (unwitnessed here,
    or committed/stable with a drained frontier but never applied).  Escalating
    the ROOT is what makes blocked-progress resolution converge — driving an
    intermediate (itself-blocked) dependency just re-commits it without
    unblocking anyone (the reference's NotifyWaitingOn graph walk,
    Commands.java:617-775).  Returns (root_txn_id, parent_command) where
    ``parent`` is the waiter one level above the root (for route/participant
    hints)."""
    cur = command
    visited = {command.txn_id}
    while True:
        nxt_id = None
        for cand in cur.waiting_on.waiting:
            if cand not in visited:
                nxt_id = cand
                break
        if nxt_id is None:
            # fully-visited cycle: fall back to any member
            return next(iter(cur.waiting_on.waiting)), cur
        visited.add(nxt_id)
        nxt = safe_store.get_if_exists(nxt_id)
        if nxt is None or nxt.waiting_on is None or not nxt.waiting_on.is_waiting():
            return nxt_id, cur
        cur = nxt


def maybe_execute(safe_store: SafeCommandStore, command: Command,
                  always_notify_listeners: bool,
                  from_frontier: bool = False) -> bool:
    """Fire ReadyToExecute / Applying when the frontier drains (Commands.java:617).

    ``from_frontier``: the call comes from the device-frontier release task
    (frontier-driven execution mode) — bypass the exec_deferred parking."""
    if command.save_status not in (SaveStatus.STABLE, SaveStatus.PRE_APPLIED):
        if always_notify_listeners:
            safe_store.notify_listeners(command)
        return False
    if command.waiting_on is not None and command.waiting_on.is_waiting():
        # capture the blocking dep BEFORE notifying: notification can re-enter
        # this command (a dependent applies, notifying its listeners, which may
        # include us) and drain waiting_on under our feet
        blocking, parent = _root_blocker(safe_store, command)
        if always_notify_listeners:
            safe_store.notify_listeners(command)
            if command.save_status not in (SaveStatus.STABLE, SaveStatus.PRE_APPLIED):
                return False  # re-entrant notification already advanced us
        if command.waiting_on.is_waiting():
            participants = parent.partial_deps.participants(blocking) \
                if parent is not None and parent.partial_deps is not None else None
            route = parent.route if parent is not None else command.route
            safe_store.progress_log().waiting(blocking, None, route, participants)
            return False
        # frontier drained during notification but no one executed us: fall through

    if command.save_status is SaveStatus.STABLE:
        # frontier-driven execution mode (SURVEY §7 stage 8: execute-phase
        # topological wait on device): when enabled, an INDEXED key-domain
        # txn whose event-driven frontier just drained is NOT fired inline —
        # it parks in exec_deferred and only the device frontier
        # (kahn_frontier over the resolver's mirrored wait graph) releases
        # it.  The event path still does all bookkeeping, so a frontier that
        # misses a ready txn stalls the burn (loud parity failure) rather
        # than executing out of order.
        store = safe_store.store
        if store.frontier_exec and not from_frontier \
                and store.resolver.is_indexed(command.txn_id):
            store.exec_deferred.add(command.txn_id)
            return False
        command.set_save_status(SaveStatus.READY_TO_EXECUTE)
        _observe_transition(safe_store, command)
        safe_store.progress_log().ready_to_execute(command)
        safe_store.notify_listeners(command)
        return True

    # PRE_APPLIED -> Applying -> Applied
    command.set_save_status(SaveStatus.APPLYING)
    _observe_transition(safe_store, command)
    _apply_writes(safe_store, command)
    return True


def _apply_writes(safe_store: SafeCommandStore, command: Command) -> None:
    """writes.apply + postApply (Commands.java:587-597)."""
    ranges = safe_store.store.all_ranges()
    t0 = safe_store.time().now_micros()

    def post_apply(_=None, failure=None):
        if failure is not None:
            safe_store.agent().on_uncaught_exception(failure)
            return
        # per-key execution registers: the NORMAL (dependency-ordered) apply
        # path validates write monotonicity (TimestampsForKeys.java:36-69)
        if command.writes is not None and not command.writes.is_empty():
            tfk = safe_store.store.timestamps_for_key
            for key in command.writes.keys:
                rk = key.to_routing() if hasattr(key, "to_routing") else key
                if ranges.contains(rk):
                    tfk.update_last_execution(safe_store, key,
                                              command.execute_at, True,
                                              txn_id=command.txn_id)
        command.set_save_status(SaveStatus.APPLIED)
        _observe_transition(safe_store, command)
        command.applied_locally = True
        safe_store.journal_save(command)
        safe_store.register_witness(command, InternalStatus.APPLIED)
        # an applied exclusive sync point waited on everything before it on its
        # ranges: all of that has now locally applied (RedundantBefore advance)
        if command.txn_id.kind is TxnKind.EXCLUSIVE_SYNC_POINT \
                and command.route is not None:
            participants = command.route.participants()
            from ..primitives.keys import Ranges as _Ranges
            if isinstance(participants, _Ranges):
                safe_store.mark_locally_applied_before(command.txn_id, participants)
        safe_store.progress_log().executed(command, _is_progress_shard(safe_store, command))
        agent = safe_store.agent()
        agent.metrics_events_listener().on_applied(command, t0)
        safe_store.notify_listeners(command)

    if command.writes is None or command.writes.is_empty():
        post_apply()
    else:
        command.writes.apply_to(safe_store, ranges).begin(post_apply)


# ---------------------------------------------------------------------------
# Journal replay (node restart; the reference's Journal.replay -> Commands load)
# ---------------------------------------------------------------------------

# save_status -> witness-plane registration at replay, mirroring what the live
# transition path registered (ACCEPTED_INVALIDATE / PRE_COMMITTED / ERASED are
# not indexed on the live path either; PRE_APPLIED registers COMMITTED exactly
# as apply_ does pre-execution)
_REPLAY_WITNESS = {
    SaveStatus.PRE_ACCEPTED: InternalStatus.PREACCEPTED,
    SaveStatus.ACCEPTED: InternalStatus.ACCEPTED,
    SaveStatus.COMMITTED: InternalStatus.COMMITTED,
    SaveStatus.STABLE: InternalStatus.STABLE,
    SaveStatus.PRE_APPLIED: InternalStatus.COMMITTED,
    SaveStatus.APPLIED: InternalStatus.APPLIED,
    SaveStatus.TRUNCATED_APPLY: InternalStatus.APPLIED,
    SaveStatus.INVALIDATED: InternalStatus.INVALIDATED,
}


def _replay_integrity_problem(command: Command) -> Optional[str]:
    """Structural validation of one journal-rebuilt command BEFORE it touches
    any index: a record that passed its checksum can still decode to state
    replay cannot execute (field-level damage, or a harness bug).  Returns a
    description of the problem, or None when the command is installable.
    Conservative: only conditions replay itself depends on are checked."""
    status = command.save_status
    if not isinstance(status, SaveStatus):
        return f"save_status decoded to {type(status).__name__}"
    if status in (SaveStatus.STABLE, SaveStatus.PRE_APPLIED):
        # pass 2 re-derives the execution frontier from these
        if command.execute_at is None:
            return f"{status.name} without execute_at"
        if command.partial_deps is None:
            return f"{status.name} without partial_deps"
        if command.route is None:
            return f"{status.name} without route"
        if command.partial_txn is None and not command.txn_id.kind.awaits_only_deps:
            return f"{status.name} without partial_txn"
    elif command.has_been(Status.PRE_COMMITTED) and not status.is_truncated \
            and status is not SaveStatus.INVALIDATED \
            and command.execute_at is None:
        return f"{status.name} without execute_at"
    return None


def install_quarantine_tombstone(safe_store: SafeCommandStore,
                                 txn_id: TxnId) -> Command:
    """Replace journal-lost state with an ERASED tombstone (the truncated
    tier).  The distinction is load-bearing for evidence soundness: an
    absent command answers recovery/inference with "never witnessed", and a
    quorum of quarantined replicas then PROVES a false negative — the
    durability-watermark ``invalid_if_undecided`` inference invalidated an
    applied-at-UNIVERSAL txn on every replica that asked.  A truncated
    tombstone instead answers "decided but unknowable": recovery gives up
    (Lost-class), preaccept refuses resurrection, and the quarantine
    bootstrap streams the actual outcome's data from peers."""
    command = Command(txn_id)
    command.save_status = SaveStatus.ERASED
    safe_store.store.commands[txn_id] = command
    _observe_transition(safe_store, command)
    safe_store.journal_save(command)
    return command


def replay_journal(safe_store: SafeCommandStore, rebuilt,
                   on_damaged=None) -> None:
    """Install journal-reconstructed commands into a FRESH store (restart after
    crash).  Volatile state was lost with the process: commands arrive at
    their durable tier (STABLE / PRE_APPLIED at most transient-wise) with no
    waiting_on and no listeners.  Two passes keep the planes consistent:

    1. install + re-index every command (cfk / resolver / range table /
       max-conflicts via register_witness; per-key execution registers for
       terminal applied writes, merged monotonically — replay order is
       arbitrary, so no write-order validation);
    2. re-derive the execution frontier (initialise_waiting_on) for
       STABLE / PRE_APPLIED commands and resume execution.  Deps that are
       unknown locally (their Commit/Apply was in flight to the dead node)
       stay in waiting_on; maybe_execute reports them to the progress log's
       blocked-dependency machinery, which fetches or recovers them — that is
       how a restarted replica catches up past what its journal predates.

    Corruption handling: each command is structurally validated BEFORE
    touching any index.  A damaged one is reported through
    ``on_damaged(txn_id, command, problem)`` — the restart path quarantines
    its journal entries and bootstraps its footprint — and replaced by an
    ERASED tombstone via ``install_quarantine_tombstone``: the replica's
    knowledge was LOST, not absent, so it must answer "truncated /
    unknowable", never "never witnessed" (a quarantined replica presenting
    watermark-based non-witness evidence got an APPLIED txn invalidated
    cluster-wide).  With no handler the damage halts replay loudly (a
    silently-installed broken command is how replicas diverge)."""
    store = safe_store.store
    damaged: set = set()
    for txn_id, command in rebuilt.items():
        problem = _replay_integrity_problem(command)
        if problem is not None:
            check_state(on_damaged is not None,
                        "journal replay of %s decoded damaged state: %s",
                        txn_id, problem)
            damaged.add(txn_id)
            on_damaged(txn_id, command, problem)
            install_quarantine_tombstone(safe_store, txn_id)
            continue
        # NOT_DEFINED records (e.g. an InformOfTxn-created stub) install too —
        # the journal tracks them, so the store must keep tracking them or the
        # end-of-burn persistence check reads the gap as an untracked erasure
        store.commands[txn_id] = command
        _observe_transition(safe_store, command)   # timeline: replayed tier
        status = _REPLAY_WITNESS.get(command.save_status)
        if status is not None:
            safe_store.register_witness(command, status)
        if command.save_status in (SaveStatus.APPLIED, SaveStatus.TRUNCATED_APPLY) \
                and command.writes is not None and not command.writes.is_empty() \
                and command.execute_at is not None:
            # empty-writes gate mirrors the live apply paths: a range READ's
            # Writes carries its read footprint (Ranges) in .keys
            _merge_applied_writes(store, command.writes, command.execute_at)
    for command in list(rebuilt.values()):
        if command.txn_id in damaged:
            continue
        if command.save_status in (SaveStatus.STABLE, SaveStatus.PRE_APPLIED):
            initialise_waiting_on(safe_store, command)
            maybe_execute(safe_store, command, always_notify_listeners=False)


# ---------------------------------------------------------------------------
# Truncation / erasure (Commands.java:824-930, Cleanup.java)
# ---------------------------------------------------------------------------

def truncate(safe_store: SafeCommandStore, command: Command, cleanup) -> None:
    """Apply a Cleanup decision: strip payloads, downgrade to a truncated
    SaveStatus.  TRUNCATE_WITH_OUTCOME keeps writes/result for peers that may
    still need the outcome; ERASE drops everything but the tombstone.

    DATA-GAP GUARD: truncating a WRITE that never applied LOCALLY leaves a
    hole in this replica's data (waiters drop the dep and execute without its
    writes; the cluster truncated it so its Apply will never arrive) — the
    store is marked stale over the txn's local footprint (reads redirect to
    peers) and a peer-snapshot heal is scheduled.  The hostile 1000-op burns
    caught readers observing the hole without this."""
    from .durability import Cleanup
    # committed-or-later only: truncating a NEVER-COMMITTED write (the
    # below-fence settled/erased case) leaves no hole — no writes exist
    # anywhere — and must not refuse reads or launch heals
    if command.txn_id.is_write and command.has_been(Status.PRE_COMMITTED) \
            and not command.has_been(Status.APPLIED) \
            and command.save_status is not SaveStatus.INVALIDATED \
            and command.route is not None:
        local_parts = command.route.participants().slice(
            safe_store.current_ranges())
        if len(local_parts):
            if command.writes is not None and command.execute_at is not None:
                # the outcome is retained (TRUNCATE_WITH_OUTCOME arriving
                # here, or an adopted outcome): land its OWN writes locally
                # before anything else — no network needed for this txn's gap
                command.writes.apply_to(safe_store, safe_store.store.all_ranges())
                _merge_applied_writes(safe_store.store, command.writes,
                                      command.execute_at)
            # predecessors may be missing too (that is WHY this txn never
            # applied): stale-mark + peer-snapshot heal over the footprint
            from ..messages.status_messages import _heal_store_gaps
            _heal_store_gaps(safe_store.store.node, safe_store, local_parts)
    if command.save_status is SaveStatus.INVALIDATED:
        # invalidation is terminal: strip any payloads left from earlier phases
        command.partial_txn = None
        command.partial_deps = None
        command.waiting_on = None
        safe_store.notify_listeners(command)
        command.listeners.clear()
        return
    command.partial_deps = None
    command.waiting_on = None
    if cleanup is Cleanup.TRUNCATE_WITH_OUTCOME:
        command.partial_txn = None
        command.set_save_status(SaveStatus.TRUNCATED_APPLY)
    elif cleanup is Cleanup.TRUNCATE:
        command.partial_txn = None
        command.writes = None
        command.result = None
        command.set_save_status(SaveStatus.TRUNCATED_APPLY)
    elif cleanup is Cleanup.ERASE:
        command.partial_txn = None
        command.writes = None
        command.result = None
        command.set_save_status(SaveStatus.ERASED)
    _observe_transition(safe_store, command)
    safe_store.journal_save(command)
    # waiters must LEARN of the truncation (a truncated dep no longer blocks,
    # _still_blocks) — clearing their registrations silently would strand them
    # in waiting_on forever
    safe_store.notify_listeners(command)
    command.listeners.clear()


# ---------------------------------------------------------------------------
# Durability (Commands.java:927)
# ---------------------------------------------------------------------------

def set_durability(safe_store: SafeCommandStore, txn_id: TxnId, durability: Durability,
                   route: Optional[Route] = None,
                   execute_at: Optional[Timestamp] = None) -> Command:
    command = safe_store.get_or_create(txn_id)
    if route is not None and command.route is None:
        command.route = route
    if execute_at is not None and not command.has_been(Status.PRE_COMMITTED):
        command.execute_at = execute_at
    if durability > command.durability:
        was = command.durability
        command.durability = durability
        safe_store.progress_log().durable(command)
        if durability >= Durability.UNIVERSAL and was < Durability.UNIVERSAL:
            # the outcome is applied at EVERY replica (the coordinator saw
            # all Apply acks — inform_universal): widen the per-key elision
            # gate NOW instead of at the next range durability round — this
            # is what keeps per-op deps cost flat with history.  MAJORITY is
            # NOT sufficient: a later txn's elided deps can reach the very
            # replica the majority missed, whose local apply order then
            # silently loses the elided txn (round-5 stale-cascade)
            safe_store.mark_txn_durable(command)
    safe_store.journal_save(command)   # route/execute_at may have changed too
    return command


# ---------------------------------------------------------------------------

def _check_consistent_execute_at(safe_store: SafeCommandStore, command: Command,
                                 execute_at: Timestamp) -> None:
    if command.execute_at is not None and execute_at is not None \
            and command.has_been(Status.PRE_COMMITTED) and command.execute_at != execute_at:
        safe_store.agent().on_inconsistent_timestamp(command, command.execute_at, execute_at)


def _is_progress_shard(safe_store: SafeCommandStore, command: Command) -> bool:
    """Is this store the home (progress) shard for the txn?"""
    return (command.route is not None
            and safe_store.store.current_ranges().contains(command.route.home_key))
