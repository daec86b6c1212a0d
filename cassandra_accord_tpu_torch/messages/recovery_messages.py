"""Recovery wire messages: BeginRecovery, invalidation, and commit-waits.

Capability parity with ``accord.messages`` BeginRecovery / Accept.Invalidate /
Commit.Invalidate / WaitOnCommit (BeginRecovery.java:1-381, Accept.java:219-296,
Commit.java:312-409, WaitOnCommit.java): ``BeginRecovery`` promises a ballot on every
intersecting store, pre-accepting the txn if unwitnessed, and reports the replica's
full recovery evidence:

  - status / accepted ballot / executeAt / deps (the Paxos-style "highest accepted"
    evidence merged coordinator-side by phase-then-ballot),
  - ``rejects_fast_path``: this replica witnessed a conflicting txn that was accepted
    or committed *started after ours* — or decided to *execute after ours* — without
    our txnId in its deps, which is incompatible with our txn having taken the fast
    path (BeginRecovery.java:354-380),
  - ``earlier_committed_witness`` / ``earlier_accepted_no_witness``: conflicting txns
    started before ours that did / did not witness us — the "wait before deciding the
    fast path succeeded" sets (BeginRecovery.java:329-352).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Set

from ..local import commands as C
from ..local.command_store import SafeCommandStore
from ..local.status import Phase, SaveStatus, Status
from ..primitives.deps import Deps, DepsBuilder
from ..primitives.keys import Ranges
from ..primitives.latest_deps import KnownDeps, LatestDeps
from ..primitives.route import Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from ..primitives.txn import PartialTxn
from .base import MessageType, Reply, Request, TxnRequest
from .txn_messages import calculate_partial_deps

if TYPE_CHECKING:
    from ..local.command import Command
    from ..local.node import Node


# ---------------------------------------------------------------------------
# replies
# ---------------------------------------------------------------------------

class RecoverOk(Reply):
    __slots__ = ("txn_id", "status", "accepted", "execute_at", "deps",
                 "earlier_committed_witness", "earlier_accepted_no_witness",
                 "later_unknown_witness", "rejects_fast_path", "writes",
                 "result")

    def __init__(self, txn_id: TxnId, status: Status, accepted: Ballot,
                 execute_at: Optional[Timestamp], deps: LatestDeps,
                 earlier_committed_witness: Deps, earlier_accepted_no_witness: Deps,
                 rejects_fast_path: bool, writes, result,
                 later_unknown_witness: Deps = Deps.NONE):
        self.txn_id = txn_id
        self.status = status
        self.accepted = accepted
        self.execute_at = execute_at
        self.deps = deps
        self.earlier_committed_witness = earlier_committed_witness
        self.earlier_accepted_no_witness = earlier_accepted_no_witness
        self.later_unknown_witness = later_unknown_witness
        self.rejects_fast_path = rejects_fast_path
        self.writes = writes
        self.result = result

    @property
    def type(self):
        return MessageType.BEGIN_RECOVER_RSP

    def merge(self, other: "RecoverOk") -> "RecoverOk":
        """Merge two per-store/per-node replies (BeginRecovery.reduce): keep the
        evidence of the max (phase, ballot-within-Accept-phase) reply, merge the
        LatestDeps maps per range by phase, union the earlier-witness sets."""
        a, b = self, other
        if _reply_order_key(b) > _reply_order_key(a):
            a, b = b, a
        ecw = a.earlier_committed_witness.with_merged(b.earlier_committed_witness)
        eanw = a.earlier_accepted_no_witness.with_merged(b.earlier_accepted_no_witness) \
            .without(ecw.contains)
        if a.status is Status.PRE_ACCEPTED:
            execute_at = a.execute_at if b.execute_at is None \
                else (b.execute_at if a.execute_at is None
                      else a.execute_at.merge_max(b.execute_at))
        else:
            execute_at = a.execute_at
        return RecoverOk(a.txn_id, a.status, a.accepted, execute_at,
                         a.deps.merge(b.deps), ecw, eanw,
                         a.rejects_fast_path or b.rejects_fast_path,
                         a.writes, b.result if a.result is None else a.result,
                         later_unknown_witness=a.later_unknown_witness
                         .with_merged(b.later_unknown_witness))

    def __repr__(self):
        return (f"RecoverOk({self.txn_id!r}, {self.status.name}, acc={self.accepted!r},"
                f" @{self.execute_at!r}, rejectsFP={self.rejects_fast_path})")


def _reply_order_key(ok: "RecoverOk"):
    """Ordering of recovery evidence (Status.max, Status.java:927-963): phase first;
    within the Accept phase the higher accepted ballot wins; otherwise status."""
    ballot_key = ok.accepted if ok.status.phase is Phase.ACCEPT else Ballot.ZERO
    return (ok.status.phase, ballot_key, ok.status.ordinal)


def max_accepted_reply(oks: List["RecoverOk"]) -> Optional["RecoverOk"]:
    """The reply whose evidence governs recovery: max by (phase, ballot) among those
    that reached at least the Accept phase (RecoverOk.maxAccepted)."""
    accepted = [ok for ok in oks if ok.status.phase >= Phase.ACCEPT]
    if not accepted:
        return None
    return max(accepted, key=_reply_order_key)


class RecoverNack(Reply):
    __slots__ = ("superseded_by",)

    def __init__(self, superseded_by: Optional[Ballot]):
        self.superseded_by = superseded_by

    @property
    def type(self):
        return MessageType.BEGIN_RECOVER_RSP

    def __repr__(self):
        return f"RecoverNack({self.superseded_by!r})"


# ---------------------------------------------------------------------------
# replica-side evidence queries (BeginRecovery.java:329-380)
# ---------------------------------------------------------------------------

def _footprint(command: "Command"):
    """A command's key footprint (shared definition — see
    command_store.command_footprint; CommandSummary snapshots the same)."""
    from ..local.command_store import command_footprint
    return command_footprint(command)


def _routing_set(keys) -> Optional[Set]:
    if keys is None or isinstance(keys, Ranges):
        return None
    return {k.to_routing() if hasattr(k, "to_routing") else k for k in keys}


def _intersects(a, b) -> bool:
    """Footprint intersection across Keys/Ranges combinations."""
    if a is None or b is None:
        return False
    a_keys, b_keys = _routing_set(a), _routing_set(b)
    if a_keys is not None and b_keys is not None:
        return not a_keys.isdisjoint(b_keys)
    if a_keys is not None:            # b is Ranges
        return any(b.contains(k) for k in a_keys)
    if b_keys is not None:            # a is Ranges
        return any(a.contains(k) for k in b_keys)
    return a.intersects(b)


def _add_overlap(builder: DepsBuilder, dep_id: TxnId, dep_footprint, our_keys) -> None:
    """Record dep_id against the overlapping portion of the footprints so
    Deps.participants(dep_id) later targets WaitOnCommit correctly."""
    our_set = _routing_set(our_keys)
    if isinstance(dep_footprint, Ranges):
        if our_set is None:
            for rng in dep_footprint:
                if our_keys.intersects(rng):
                    builder.add(rng, dep_id)
        else:
            for k in our_set:
                if dep_footprint.contains(k):
                    builder.add(k, dep_id)
    else:
        dep_set = _routing_set(dep_footprint)
        if our_set is None:
            for k in dep_set:
                if our_keys.contains(k):
                    builder.add(k, dep_id)
        else:
            for k in dep_set & our_set:
                builder.add(k, dep_id)


def _scan_conflicting(safe_store: SafeCommandStore, txn_id: TxnId, keys):
    """Yield (command, footprint) for every other command conflicting with ``keys``
    whose kind would witness ours (the mapReduceFull scan; the reference indexes
    this via cfk, we scan the command map — recovery is rare)."""
    # evicted commands answer from their CommandSummary (snapshotted at evict
    # time — terminal, so exact): the evidence scan must see EVERY conflicting
    # txn, memory-resident or not, but repeated scans must NOT re-decode the
    # whole cold set through the journal each time (BeginRecovery churn at
    # quiesce ran 125k+ fault-ins).  Summary-less cold ids (none in practice)
    # take the old peek-route + fault-in path.
    store = safe_store.store
    journal = store.journal
    for cold_id in list(store.cold):
        if cold_id == txn_id or not txn_id.witnessed_by(cold_id.kind):
            continue
        summary = store.cold_summaries.get(cold_id)
        if summary is not None:
            if summary.footprint is not None \
                    and _intersects(keys, summary.footprint):
                yield summary, summary.footprint
            continue
        if journal is not None:
            route = journal.peek_route(store, cold_id)
            if route is not None \
                    and not _intersects(keys, route.participants()):
                continue
        safe_store.get_if_exists(cold_id)
    for other_id, command in safe_store.store.commands.items():
        if other_id == txn_id or not txn_id.witnessed_by(other_id.kind):
            continue
        footprint = _footprint(command)
        if footprint is not None and _intersects(keys, footprint):
            yield command, footprint


def recovery_evidence(safe_store: SafeCommandStore, txn_id: TxnId, keys):
    """Compute (rejects_fast_path, earlier_committed_witness,
    earlier_accepted_no_witness, later_unknown_witness) for a
    pre-accepted-only txn."""
    rejects_fast_path = False
    ecw = DepsBuilder()
    eanw = DepsBuilder()
    lnw = DepsBuilder()
    for command, footprint in _scan_conflicting(safe_store, txn_id, keys):
        other = command.txn_id
        status = command.status
        # SOUNDNESS: 'did not witness us' is only evidence when the command's
        # DECIDED deps are actually present.  A deps-less command
        # (PRE_COMMITTED stores no deps; truncation strips them) must not be
        # read as a non-witness — the hostile 1000-op burns caught recovery
        # invalidating a FAST-COMMITTED txn off exactly that misreading.
        # (The fast-path argument needs real deps: any fast quorum of ours
        # intersects the other txn's preaccept quorum in a member that voted
        # for us first, so its decided deps MUST contain us.)
        deps_known = command.partial_deps is not None
        witnessed_us = deps_known and command.partial_deps.contains(txn_id)
        is_proposed = status in (Status.ACCEPTED, Status.PRE_COMMITTED, Status.COMMITTED)
        is_stable = (status.has_been(Status.STABLE)
                     and not command.save_status.is_truncated
                     and command.save_status is not SaveStatus.INVALIDATED)
        if deps_known and not witnessed_us:
            # started after ours and accepted/committed => our fast path cannot
            # have reached a quorum (its deps calc would have witnessed us)
            if other > txn_id and is_proposed:
                rejects_fast_path = True
            # decided to execute after ours without witnessing us — EXCEPT
            # awaits-only-deps kinds (exclusive sync points): they never agree
            # an execution time and only take deps on LOWER txnIds, so one
            # executing after us structurally cannot have witnessed us and
            # proves nothing about our fast path (the hostile burns caught an
            # ESP's evidence invalidating a fast-committed write here)
            if is_stable and not other.awaits_only_deps \
                    and command.execute_at is not None \
                    and command.execute_at > txn_id.as_timestamp():
                rejects_fast_path = True
        if other < txn_id:
            if is_stable and witnessed_us:
                _add_overlap(ecw, other, footprint, keys)
            elif is_proposed and not witnessed_us \
                    and not other.awaits_only_deps \
                    and command.execute_at is not None \
                    and command.execute_at > txn_id.as_timestamp():
                # (awaits-only-deps kinds excluded: they cannot witness a
                # higher txnId, so waiting for them to commit decides nothing)
                _add_overlap(eanw, other, footprint, keys)
        elif not deps_known and not other.awaits_only_deps \
                and status.has_been(Status.PRE_ACCEPTED) \
                and command.save_status is not SaveStatus.INVALIDATED \
                and not command.save_status.is_truncated:
            # LATER-started conflict whose witness status is UNKNOWN here
            # (in flight: no decided deps yet).  Completing our fast path at
            # txnId is only sound if every later-started conflicting COMMIT
            # witnessed us — which cannot be established while such txns are
            # unsettled (the superseding race, KNOWN_ISSUES seed 112): the
            # recovery coordinator must wait for them to settle and
            # re-examine (their decided deps then either witness us or
            # become rule-1 rejection evidence)
            _add_overlap(lnw, other, footprint, keys)
    return rejects_fast_path, ecw.build(), eanw.build(), lnw.build()


# ---------------------------------------------------------------------------
# BeginRecovery
# ---------------------------------------------------------------------------

class BeginRecovery(TxnRequest):
    __slots__ = ("partial_txn", "ballot", "route")

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int,
                 partial_txn: PartialTxn, ballot: Ballot,
                 route: Optional[Route] = None):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.partial_txn = partial_txn
        self.ballot = ballot
        # full route (BeginRecovery.java route field)
        self.route = route if route is not None else scope

    @property
    def type(self):
        return MessageType.BEGIN_RECOVER_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id, partial_txn, ballot, scope = self.txn_id, self.partial_txn, self.ballot, self.scope
        route = self.route

        def map_fn(safe_store: SafeCommandStore):
            outcome = C.recover(safe_store, txn_id, partial_txn, route, ballot)
            if outcome is C.AcceptOutcome.TRUNCATED:
                return RecoverNack(None)
            if outcome is C.AcceptOutcome.REJECTED_BALLOT:
                return RecoverNack(safe_store.get_if_exists(txn_id).promised)
            command = safe_store.get_if_exists(txn_id)
            # phase-aware deps evidence (BeginRecovery.java:95-121): the
            # coordinator-held deps at their knowledge phase, plus a fresh
            # local calculation while no committed/decided deps exist
            coordinated = command.partial_deps
            if command.has_been(Status.STABLE):
                known = KnownDeps.KNOWN
            elif command.has_been(Status.COMMITTED):
                known = KnownDeps.COMMITTED
            elif command.status is Status.ACCEPTED and coordinated is not None:
                known = KnownDeps.PROPOSED
            else:
                known = KnownDeps.UNKNOWN   # incl. PreCommitted/AcceptedInvalidate
            local = None
            if known <= KnownDeps.PROPOSED:
                local = calculate_partial_deps(safe_store, txn_id, partial_txn.keys,
                                               txn_id.as_timestamp())
            deps = LatestDeps.create(
                safe_store.store.ranges_at(txn_id.epoch),
                known, command.accepted_or_committed, coordinated, local)
            if command.has_been(Status.PRE_COMMITTED):
                rejects, ecw, eanw, lnw = False, Deps.NONE, Deps.NONE, Deps.NONE
            else:
                rejects, ecw, eanw, lnw = recovery_evidence(
                    safe_store, txn_id, partial_txn.keys)
            return RecoverOk(txn_id, command.status, command.accepted_or_committed,
                             command.execute_at, deps, ecw, eanw, rejects,
                             command.writes, command.result,
                             later_unknown_witness=lnw)

        def reduce_fn(a, b):
            if isinstance(a, RecoverNack):
                return a
            if isinstance(b, RecoverNack):
                return b
            return a.merge(b)

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node, reply_context, failure)
            else:
                node.reply(from_node, reply_context, result)

        node.map_reduce_consume_local(scope, node.topology.min_epoch, txn_id.epoch,
                                      map_fn, reduce_fn,
                                      preload=self.preload_ids()).begin(consume)

    def __repr__(self):
        return f"BeginRecovery({self.txn_id!r}, ballot={self.ballot!r})"


# ---------------------------------------------------------------------------
# Invalidation (Accept.Invalidate / Commit.Invalidate)
# ---------------------------------------------------------------------------

class InvalidateOk(Reply):
    __slots__ = ("status", "route", "has_definition")

    def __init__(self, status: Status, route: Optional[Route],
                 has_definition: bool = False):
        self.status = status
        self.route = route
        self.has_definition = has_definition

    @property
    def type(self):
        return MessageType.BEGIN_INVALIDATE_RSP

    def __repr__(self):
        return f"InvalidateOk({self.status.name})"


class InvalidateNack(Reply):
    """Rejected: a higher ballot holds the promise (``superseded_by``), the
    txn is already (pre)committed (``committed``), or it sits below this home
    shard's durable fence (``truncated`` — NOT a commit claim: a below-fence
    txn is SETTLED, having either durably applied everywhere that matters and
    been erased, or being forever unable to newly commit since preaccept
    below the fence refuses; conflating this with 'committed' sent
    invalidation into a permanent preempt loop)."""
    __slots__ = ("superseded_by", "committed", "truncated")

    def __init__(self, superseded_by: Optional[Ballot], committed: bool = False,
                 truncated: bool = False):
        self.superseded_by = superseded_by
        self.committed = committed
        self.truncated = truncated

    @property
    def type(self):
        return MessageType.BEGIN_INVALIDATE_RSP

    def __repr__(self):
        return (f"InvalidateNack(committed={self.committed}, "
                f"truncated={self.truncated})")


class AcceptInvalidate(TxnRequest):
    """Propose invalidation at ``ballot`` (Accept.Invalidate): replicas promise the
    ballot and vote AcceptedInvalidate unless the txn already (pre)committed."""
    __slots__ = ("ballot",)

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int, ballot: Ballot):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.ballot = ballot

    @property
    def type(self):
        return MessageType.ACCEPT_INVALIDATE_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id, ballot = self.txn_id, self.ballot

        def map_fn(safe_store: SafeCommandStore):
            outcome = C.accept_invalidate(safe_store, txn_id, ballot, scope=self.scope)
            command = safe_store.get_if_exists(txn_id)
            if outcome is C.AcceptOutcome.REJECTED_BALLOT:
                return InvalidateNack(command.promised)
            if outcome is C.AcceptOutcome.TRUNCATED:
                # below this shard's durable fence: SETTLED, not committed
                return InvalidateNack(None, truncated=True)
            if outcome is C.AcceptOutcome.REDUNDANT:
                return InvalidateNack(None, committed=True)
            return InvalidateOk(command.status, command.route,
                                has_definition=command.partial_txn is not None)

        def reduce_fn(a, b):
            if isinstance(a, InvalidateNack):
                return a
            if isinstance(b, InvalidateNack):
                return b
            keep = a if a.status >= b.status else b
            other = b if keep is a else a
            if not keep.has_definition and other.has_definition:
                keep = InvalidateOk(keep.status, other.route if keep.route is None
                                    else keep.route, True)
            return keep

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node, reply_context, failure)
            else:
                node.reply(from_node, reply_context, result)

        node.map_reduce_consume_local(self.scope, node.topology.min_epoch, txn_id.epoch,
                                      map_fn, reduce_fn,
                                      preload=self.preload_ids()).begin(consume)

    def __repr__(self):
        return f"AcceptInvalidate({self.txn_id!r}, ballot={self.ballot!r})"


class CommitInvalidate(TxnRequest):
    __slots__ = ()

    @property
    def type(self):
        return MessageType.COMMIT_INVALIDATE_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id = self.txn_id

        def for_store(safe_store: SafeCommandStore):
            C.commit_invalidate(safe_store, txn_id, scope=self.scope)

        node.for_each_local(self.scope, node.topology.min_epoch, txn_id.epoch,
                            for_store, preload=self.preload_ids())

    def __repr__(self):
        return f"CommitInvalidate({self.txn_id!r})"


# ---------------------------------------------------------------------------
# WaitOnCommit (WaitOnCommit.java)
# ---------------------------------------------------------------------------

class WaitOnCommitOk(Reply):
    __slots__ = ()

    @property
    def type(self):
        return MessageType.WAIT_ON_COMMIT_RSP

    def __repr__(self):
        return "WaitOnCommitOk"


WAIT_ON_COMMIT_OK = WaitOnCommitOk()


class WaitOnCommit(TxnRequest):
    """Reply once the txn is (pre)committed / invalidated / truncated on every
    intersecting store (used by recovery to await earlier-no-witness txns)."""
    __slots__ = ()

    @property
    def type(self):
        return MessageType.WAIT_ON_COMMIT_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        from ..utils import async_ as au
        txn_id = self.txn_id
        stores = node.command_stores.intersecting_stores(self.scope, txn_id.epoch, txn_id.epoch)
        if not stores:
            node.reply(from_node, reply_context, WAIT_ON_COMMIT_OK)
            return

        def wait_in(safe_store: SafeCommandStore) -> au.AsyncChain:
            result = au.settable()

            def is_done(command) -> bool:
                return (command.has_been(Status.PRE_COMMITTED)
                        or command.save_status is SaveStatus.INVALIDATED
                        or command.save_status.is_truncated)

            command = safe_store.get_or_create(txn_id)
            if is_done(command):
                result.set_success(None)
            else:
                def listener(s: SafeCommandStore, cmd):
                    if is_done(cmd):
                        s.remove_transient_listener(txn_id, listener)
                        result.try_success(None)
                safe_store.add_transient_listener(txn_id, listener)
            return result.to_chain()

        chains = [store.submit(wait_in, preload=(txn_id,))
                  .flat_map(lambda c: c) for store in stores]

        def consume(_values, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node, reply_context, failure)
            else:
                node.reply(from_node, reply_context, WAIT_ON_COMMIT_OK)

        au.all_of(chains).begin(consume)

    def __repr__(self):
        return f"WaitOnCommit({self.txn_id!r})"
