"""Recovery coordination.

Capability parity with ``accord.coordinate`` Recover / Invalidate
(Recover.java:80-471, Invalidate.java:1-297): a recovering coordinator promises a
ballot at a slow-path quorum of every shard via ``BeginRecovery`` (which also
pre-accepts the txn wherever it was unwitnessed), then resumes the standard pipeline
at the phase matching the strongest evidence found:

  outcome known (PreApplied+)      -> persist (Apply.Maximal) and report the result
  Stable                           -> execute (Stable+Read) at the known executeAt
  (Pre)Committed                   -> stabilise then execute at the known executeAt
  Accepted                         -> re-propose (Accept round at our ballot) the
                                      max-ballot proposal's executeAt/deps
  AcceptedInvalidate               -> propose invalidation, then commit-invalidate
  all PreAccepted or unwitnessed   -> fast-path analysis (Recover.java:354-380):
      * any shard where too many electorate members witnessed a timestamp other
        than txnId (tracker), or any replica that witnessed a conflicting txn
        ordered after ours without our txnId in its deps => the original
        coordinator CANNOT have fast-committed: safe to invalidate;
      * otherwise the fast path may have succeeded, so it must be completed: wait
        (WaitOnCommit) for any earlier-started txn that proposed an executeAt after
        ours without witnessing us to commit, retry recovery; when none remain,
        re-propose at executeAt = txnId with the merged pre-accept deps.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional

from ..messages.base import Callback, TxnRequest
from ..messages.recovery_messages import (
    AcceptInvalidate, BeginRecovery, CommitInvalidate, InvalidateNack, InvalidateOk,
    RecoverNack, RecoverOk, WaitOnCommit, WaitOnCommitOk, max_accepted_reply,
)
from ..local.status import Phase, Status
from ..primitives.deps import Deps
from ..primitives.keys import Ranges
from ..primitives.latest_deps import LatestDeps
from ..primitives.route import Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from ..primitives.txn import Txn
from ..utils import async_ as au
from .coordinate_transaction import persist_maximal, resume_propose, resume_stabilise
from .errors import Exhausted, Invalidated, Preempted, Timeout, Truncated
from .tracking import QuorumTracker, RecoveryTracker, RequestStatus

if TYPE_CHECKING:
    from ..local.node import Node


def recover(node: "Node", txn_id: TxnId, txn: Txn, route: Route,
            result: au.Settable, ballot: Optional[Ballot] = None) -> None:
    """Entry point (Recover.recover): pick a ballot above anything we've issued and
    drive recovery of ``txn_id`` to a terminal outcome.  ``result`` resolves with
    the txn's Result on success, or Invalidated/Preempted/Exhausted."""
    if ballot is None:
        ballot = node.ballot_after(None)
    observer = getattr(node, "observer", None)
    if observer is not None:
        # recovery attribution: the txn's span records who tried to recover
        # it and how often (the flight recorder's recovery.* counters); the
        # sim timestamp feeds the trace export's recovery counter track and
        # closes the auditor's unattended-SLO flag
        observer.on_recovery(node.id, txn_id, ballot, node.now_micros())
    _Recover(node, ballot, txn_id, txn, route, result).start()


class _Recover:
    def __init__(self, node: "Node", ballot: Ballot, txn_id: TxnId, txn: Txn,
                 route: Route, result: au.Settable):
        self.node = node
        self.ballot = ballot
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.result = result
        self.topologies = node.topology.precise_epochs(route, txn_id.epoch, txn_id.epoch)
        self.tracker = RecoveryTracker(self.topologies)
        self.oks: Dict[int, RecoverOk] = {}
        self.done = False

    # -- BeginRecovery round -------------------------------------------------
    def start(self) -> None:
        this = self

        class RecoverCallback(Callback):
            def on_success(self, from_node: int, reply) -> None:
                if this.done:
                    return
                if isinstance(reply, RecoverNack):
                    if reply.superseded_by is None:
                        # the txn was truncated: it is durably decided everywhere
                        # that matters; report the terminal outcome, don't retry
                        this.fail(Truncated(this.txn_id, "truncated before recovery"))
                    else:
                        this.fail(Preempted(this.txn_id,
                                            f"recovery superseded by {reply.superseded_by}"))
                    return
                this.oks[from_node] = reply
                fast_path_vote = reply.execute_at is not None \
                    and reply.execute_at == this.txn_id.as_timestamp()
                if this.tracker.record_success(from_node, fast_path_vote) is RequestStatus.SUCCESS:
                    this.analyse()

            def on_failure(self, from_node: int, failure: BaseException) -> None:
                if this.done:
                    return
                if this.tracker.record_failure(from_node) is RequestStatus.FAILED:
                    this.fail(Exhausted(this.txn_id, "recovery quorum unreachable"))

        callback = RecoverCallback()
        self.node.send_to_each(
            self.tracker.nodes(),
            lambda to: self._begin_recovery_for(to),
            callback)

    def _begin_recovery_for(self, to: int) -> Optional[BeginRecovery]:
        scope = TxnRequest.compute_scope(to, self.topologies, self.route)
        if scope is None:
            return None
        wait_for = TxnRequest.compute_wait_for_epoch(to, self.topologies)
        ranges = scope.covering
        partial = self.txn.slice(ranges, to == self.node.id) if ranges is not None \
            else self.txn.slice(self.node.topology.topology_for_epoch(self.txn_id.epoch).ranges(),
                                to == self.node.id)
        return BeginRecovery(self.txn_id, scope, wait_for, partial, self.ballot,
                             route=self.route)

    # -- quorum analysis (Recover.recover, Recover.java:245-380) --------------
    def analyse(self) -> None:
        oks = list(self.oks.values())
        best = max_accepted_reply(oks)
        latest = LatestDeps.merge_all([ok.deps for ok in oks])

        if best is not None:
            status, execute_at = best.status, best.execute_at
            if status is Status.INVALIDATED or status is Status.TRUNCATED:
                self.commit_invalidate()
                return
            if status.has_been(Status.PRE_APPLIED):
                self.persist_known_outcome(execute_at, latest)
                return
            if status.has_been(Status.STABLE) or status.has_been(Status.PRE_COMMITTED):
                # executeAt decided: (re-)stabilise at it with the PHASE-AWARE
                # deps merge (LatestDeps.mergeCommit): committed-grade ranges
                # use the decided deps; fast-path ranges may substitute local
                # calculations; anything else is fetched via GetDeps.  Claim
                # ``done`` NOW: a straggler nack arriving during the async
                # GetDeps round must not settle the result out from under the
                # stabilisation this branch has committed to
                self.done = True

                def stabilise_with(deps: Deps) -> None:
                    resume_stabilise(self.node, self.txn_id, self.txn, self.route,
                                     self.result, self.ballot, execute_at, deps)
                    self._on_settled()
                self.with_committed_deps(execute_at, latest, stabilise_with)
                return
            if status is Status.ACCEPTED:
                self.done = True
                resume_propose(self.node, self.txn_id, self.txn, self.route,
                               self.result, self.ballot, execute_at,
                               latest.merge_proposal())
                self._on_settled()
                return
            if status is Status.ACCEPTED_INVALIDATE:
                self.propose_invalidate()
                return

        # all replies PreAccepted (BeginRecovery pre-accepts unwitnessed replicas)
        if self.tracker.rejects_fast_path() or any(ok.rejects_fast_path for ok in oks):
            # the fast path provably did not commit; nothing else was proposed
            self.propose_invalidate()
            return

        ecw = Deps.merge([ok.earlier_committed_witness for ok in oks])
        eanw = Deps.merge([ok.earlier_accepted_no_witness for ok in oks]).without(ecw.contains)
        if not eanw.is_empty():
            # earlier txns proposed to execute after us without witnessing us: if
            # one commits that way, our fast path provably failed; wait for them
            # to settle then re-examine from scratch (Recover.java:361-375)
            self.await_commits(eanw)
            return

        lnw = Deps.merge([ok.later_unknown_witness for ok in oks])
        if not lnw.is_empty():
            # LATER-started in-flight conflicts whose deps are undecided:
            # completing the fast path at txnId is only sound once every
            # later-started conflicting COMMIT provably witnessed us — wait
            # for them to settle, then re-examine (their decided deps either
            # include us, or become rule-1 fast-path-rejection evidence and
            # we invalidate).  The superseding race (KNOWN_ISSUES seed 112):
            # without this wait, recovery completed a fast path that a
            # later fast-committed conflict had already ordered around.
            self.await_commits(lnw)
            return

        # the fast path may have committed: complete it at executeAt = txnId
        self.done = True
        resume_propose(self.node, self.txn_id, self.txn, self.route, self.result,
                       self.ballot, self.txn_id.as_timestamp(),
                       latest.merge_proposal())
        self._on_settled()

    def with_committed_deps(self, execute_at: Timestamp, latest: LatestDeps,
                            use_deps) -> None:
        """Phase-aware commit deps (Recover.withCommittedDeps,
        Recover.java:384-400): merge the quorum's evidence per range; any part
        of the footprint the merge is insufficient for is collected fresh via
        a GetDeps round at executeAt.  Callers have already claimed ``done``,
        so failures settle the result DIRECTLY (the progress log retries) —
        routing them through fail() would drop them on the floor."""
        deps, sufficient = latest.merge_commit(self.txn_id, execute_at)
        missing = [key for key in self.txn.keys
                   if not sufficient.contains(
                       key.to_routing() if hasattr(key, "to_routing") else key)] \
            if not isinstance(self.txn.keys, Ranges) \
            else self.txn.keys.without(sufficient)
        if (isinstance(missing, Ranges) and missing.is_empty()) or not missing:
            use_deps(deps)
            return
        this = self
        from .collect_deps import collect_deps

        def on_collected(extra, failure):
            if failure is not None:
                this.result.set_failure(failure)
                return
            use_deps(deps.with_merged(extra))

        collect_deps(self.node, self.txn_id, self.route, missing,
                     execute_at).add_listener(on_collected)

    def persist_known_outcome(self, execute_at: Timestamp,
                              latest: LatestDeps) -> None:
        """Some replica applied the txn: assemble the COMPLETE outcome before
        re-disseminating it.  A single RecoverOk's writes are that replica's
        per-shard SLICE — persisting a slice as if it were the whole write-set
        silently drops the other shards' writes at every replica that adopts it
        (the divergence class the hostile burn caught).  Fetch the outcome over
        the full route (slice-union + applied_for coverage check,
        CheckStatusOk.merge); if the union does not yet cover the footprint,
        fall back to re-stabilise/execute at the known executeAt with
        phase-aware merged deps."""
        this = self
        self.done = True
        from .fetch_data import fetch_data

        def on_fetched(merged, failure):
            if failure is not None:
                this.result.set_failure(failure)   # progress log retries
                return
            parts = this.route.participants()
            if merged is not None and merged.writes is not None \
                    and merged.execute_at is not None \
                    and merged.applied_for.contains_all(parts) \
                    and merged.partial_deps is not None \
                    and merged.stable_for.contains_all(parts):
                persist_maximal(this.node, this.txn_id, this.txn, this.route,
                                this.topologies, merged.execute_at,
                                merged.partial_deps, merged.writes, merged.result)
                this.node.agent.metrics_events_listener().on_recover(
                    this.txn_id, this.ballot)
                this.result.set_success(merged.result)
            else:
                def stabilise_with(deps: Deps) -> None:
                    resume_stabilise(this.node, this.txn_id, this.txn, this.route,
                                     this.result, this.ballot, execute_at, deps)
                    this._on_settled()
                this.with_committed_deps(execute_at, latest, stabilise_with)

        fetch_data(self.node, self.txn_id, self.route).add_listener(on_fetched)

    # -- await earlier uncommitted no-witness txns ----------------------------
    def await_commits(self, waiting_on: Deps) -> None:
        txn_ids = waiting_on.txn_ids()
        remaining = {"n": len(txn_ids)}
        this = self

        def one_done(_v, failure):
            if this.done:
                return
            if failure is not None:
                this.fail(failure)
                return
            remaining["n"] -= 1
            if remaining["n"] == 0:
                this.retry()

        for dep_id in txn_ids:
            _AwaitCommit(self.node, dep_id, waiting_on.participants(dep_id)) \
                .result.add_listener(one_done)

    def retry(self) -> None:
        self.done = True
        _Recover(self.node, self.node.ballot_after(self.ballot), self.txn_id,
                 self.txn, self.route, self.result).start()

    # -- invalidation ---------------------------------------------------------
    def propose_invalidate(self) -> None:
        """Propose invalidation at our ballot to a quorum of the home shard
        (Propose.Invalidate.proposeInvalidate)."""
        topology = self.node.topology.topology_for_epoch(self.txn_id.epoch)
        shard = topology.for_key_required(self.route.home_key)
        tracker = QuorumTracker(self.node.topology.precise_epochs(
            self.route.home_key_only(), self.txn_id.epoch, self.txn_id.epoch))
        this = self

        class InvalidateCallback(Callback):
            def on_success(self, from_node: int, reply) -> None:
                if this.done:
                    return
                if isinstance(reply, InvalidateNack):
                    if reply.truncated:
                        # settled below the durable fence: adopt and report
                        adopt_erased(this.node, this.txn_id, this.route)
                        this.fail(Truncated(this.txn_id,
                                            "below the durable fence"))
                    elif reply.committed:
                        # txn (pre)committed concurrently: restart recovery to
                        # pick up the commit evidence
                        this.retry()
                    else:
                        this.fail(Preempted(this.txn_id,
                                            f"invalidate superseded by {reply.superseded_by}"))
                    return
                if reply.status.has_been(Status.PRE_COMMITTED):
                    this.retry()
                    return
                if reply.status.has_been(Status.ACCEPTED):
                    # a real Accept vote at some ballot: the txn may have been
                    # committed by that proposer — re-run recovery to adopt it
                    # (the Paxos value-adoption rule; invalidating would race a
                    # completed commit)
                    this.retry()
                    return
                if tracker.record_success(from_node) is RequestStatus.SUCCESS:
                    this.commit_invalidate()

            def on_failure(self, from_node: int, failure: BaseException) -> None:
                if this.done:
                    return
                if tracker.record_failure(from_node) is RequestStatus.FAILED:
                    this.fail(Exhausted(this.txn_id, "invalidate quorum unreachable"))

        scope = self.route.home_key_only()
        for to in shard.nodes:
            self.node.send(to, AcceptInvalidate(self.txn_id, scope, self.txn_id.epoch,
                                                self.ballot), InvalidateCallback())

    def commit_invalidate(self) -> None:
        """Broadcast CommitInvalidate across the route and report Invalidated
        (Propose.Invalidate.proposeAndCommitInvalidate tail)."""
        for to in self.topologies.nodes():
            scope = TxnRequest.compute_scope(to, self.topologies, self.route)
            if scope is None:
                continue
            wait_for = TxnRequest.compute_wait_for_epoch(to, self.topologies)
            self.node.send(to, CommitInvalidate(self.txn_id, scope, wait_for))
        self.fail(Invalidated(self.txn_id, "invalidated during recovery"))

    # -- terminal -------------------------------------------------------------
    def succeed(self, txn_result) -> None:
        if not self.done:
            self.done = True
            self.node.agent.metrics_events_listener().on_recover(self.txn_id, self.ballot)
            self.result.set_success(txn_result)

    def fail(self, failure: BaseException) -> None:
        if not self.done:
            self.done = True
            self.result.set_failure(failure)

    def _on_settled(self) -> None:
        """Metrics hook once a resumed pipeline settles the result."""
        node, txn_id, ballot = self.node, self.txn_id, self.ballot

        def notify(_v, failure):
            if failure is None:
                node.agent.metrics_events_listener().on_recover(txn_id, ballot)
        self.result.add_listener(notify)


def adopt_erased(node: "Node", txn_id: TxnId, route: Route) -> None:
    """A home-shard quorum member asserted ``txn_id`` sits below its durable
    fence: the txn is settled — but 'settled' means EITHER it can never commit
    OR it applied at a quorum and was then erased.  A locally-undecided copy
    cannot tell the two apart, and erasing it in the second case would drop
    the dep as truncated and let waiters execute without the committed write's
    data (the truncate() data-gap guard is gated on PRE_COMMITTED, so it never
    fires here).  So: fetch_data FIRST — if a peer still carries the outcome,
    Propagate applies it and the normal path (with its own gap-heal) takes
    over.  Any copy STILL undecided after the fetch is erased with a
    conservative stale-mark + peer-snapshot heal of its local write footprint,
    because the outcome remains unknowable.  Decided local copies are left
    alone — they resolve through the normal apply path."""
    from ..local import commands as C
    from ..local.durability import Cleanup
    from ..local.status import Status

    def adopt(_merged=None, _failure=None) -> None:
        # runs whether the fetch succeeded or not: on failure (quorum
        # unreachable) waiters must still unblock, and the conservative heal
        # below keeps reads redirected until the data plane is whole again
        def for_store(safe_store) -> None:
            from ..local.status import SaveStatus as _SS
            probe = safe_store.get_if_exists(txn_id)
            if (probe is None or not probe.listeners) \
                    and C._is_shard_redundant(safe_store, txn_id, route):
                # GC physically erased this txn below the shard fence: do
                # not resurrect a fresh stub just to mark it ERASED (ballot
                # regression; the fend-off shared with accept/propagate) —
                # unless a local waiter still lists it (listeners), in
                # which case the truncation below is exactly what unblocks
                # the waiter
                return
            cmd = safe_store.get_if_exists(txn_id)
            if cmd is None or cmd.save_status.is_truncated \
                    or cmd.save_status is _SS.INVALIDATED \
                    or cmd.has_been(Status.PRE_COMMITTED):
                # an INVALIDATED tombstone already unblocks waiters and must
                # persist AS INVALIDATED until the shard fence (never
                # downgrade to ERASED: the round-4 resurrection class)
                return
            if txn_id.is_write:
                cmd_route = cmd.route if cmd.route is not None else route
                local_parts = cmd_route.participants().slice(
                    safe_store.current_ranges())
                if len(local_parts):
                    from ..messages.status_messages import _heal_store_gaps
                    _heal_store_gaps(node, safe_store, local_parts)
            C.truncate(safe_store, cmd, Cleanup.ERASE)

        node.for_each_local(route, txn_id.epoch, txn_id.epoch, for_store)

    from .fetch_data import fetch_data
    fetch_data(node, txn_id, route).add_listener(adopt)


def invalidate(node: "Node", txn_id: TxnId, route: Route, result: au.Settable,
               ballot: Optional[Ballot] = None) -> None:
    """Standalone invalidation (Invalidate.java): used when a txn blocks others but
    its definition cannot be recovered (never witnessed at a quorum).  Promises a
    ballot at a quorum of the home-key shard, then commit-invalidates everywhere.
    Resolves ``result`` with Invalidated on success (the txn is settled: it will
    never execute), Preempted if a competing coordinator holds a higher ballot or
    the txn turns out to be committed."""
    if ballot is None:
        ballot = node.ballot_after(None)
    observer = getattr(node, "observer", None)
    if observer is not None:
        # invalidation attribution for the txn's flight-recorder span
        observer.on_invalidate(node.id, txn_id, node.now_micros())
    topologies = node.topology.precise_epochs(route, txn_id.epoch, txn_id.epoch)
    topology = node.topology.topology_for_epoch(txn_id.epoch)
    shard = topology.for_key_required(route.home_key)
    tracker = QuorumTracker(node.topology.precise_epochs(
        route.home_key_only(), txn_id.epoch, txn_id.epoch))
    state = {"done": False, "learned_route": None, "has_definition": False,
             "has_accept": False}

    def finish(failure: BaseException) -> None:
        if not state["done"]:
            state["done"] = True
            result.set_failure(failure)

    def commit_invalidate() -> None:
        for to in topologies.nodes():
            scope = TxnRequest.compute_scope(to, topologies, route)
            if scope is None:
                continue
            node.send(to, CommitInvalidate(
                txn_id, scope, TxnRequest.compute_wait_for_epoch(to, topologies)))
        finish(Invalidated(txn_id, "invalidated (definition unrecoverable)"))

    def escalate(learned_route: Route) -> None:
        """SAFETY (Invalidate.java): our home-shard quorum intersects any fast-path
        quorum, so if a contacted replica knows the definition the txn may have
        fast-committed — recover it instead of invalidating.  Fetch the definition
        cluster-wide, reconstitute, and run full recovery.

        LIVENESS (Invalidate.java:125-135, 170-195): when even a quorum read of
        EVERY shard of the full route cannot reassemble the definition and no
        shard shows Accepted+, the fast path provably never committed (a fast
        quorum per shard must hold that shard's definition slice, and every
        majority read intersects every fast quorum), and our home-shard promises
        block any future fast-path decision — so invalidation is safe.  Without
        this rule, a PreAccept that reached only a minority of some shard makes
        invalidate<->recover ping-pong forever."""
        state["done"] = True
        from .fetch_data import fetch_data

        def attempt(fetch_route: Route, allow_refetch: bool) -> None:
            def on_fetched(merged, failure):
                if failure is not None:
                    result.set_failure(failure)
                    return
                txn = merged.full_txn() if merged is not None else None
                mroute = merged.route if merged is not None else None
                if txn is not None:
                    full_route = mroute if mroute is not None and mroute.full \
                        else fetch_route
                    recover(node, txn_id, txn, full_route, result,
                            ballot=node.ballot_after(ballot))
                    return
                if allow_refetch and mroute is not None and mroute.full \
                        and mroute != fetch_route:
                    attempt(mroute, False)   # now query the txn's FULL footprint
                    return
                if mroute is not None and mroute.full and merged is not None \
                        and not merged.save_status.has_been(Status.ACCEPTED):
                    # quorum of every shard read; no definition, nothing Accepted+
                    state["done"] = False    # re-arm terminal bookkeeping
                    commit_invalidate()
                    return
                result.set_failure(Exhausted(
                    txn_id, "definition known but not reconstitutable yet"))

            fetch_data(node, txn_id, fetch_route).add_listener(on_fetched)

        attempt(learned_route, True)

    class InvalidateCallback(Callback):
        def on_success(self, from_node: int, reply) -> None:
            if state["done"]:
                return
            if isinstance(reply, InvalidateNack):
                if reply.truncated:
                    # below the home shard's durable fence: settled — adopt
                    # the tombstone locally so waiters unblock, report
                    # Truncated (outcome unknowable here)
                    adopt_erased(node, txn_id, route)
                    finish(Truncated(txn_id, "below the durable fence"))
                    return
                finish(Preempted(txn_id, "invalidation superseded"
                                 if not reply.committed else "txn committed"))
                return
            if reply.status.has_been(Status.PRE_COMMITTED):
                finish(Preempted(txn_id, "txn committed concurrently"))
                return
            if reply.status.has_been(Status.ACCEPTED):
                # a real Accept vote (which carries no definition): the txn may
                # be committed — never count this toward an invalidation quorum;
                # escalate to recovery via the definition-fetch path instead
                # (Paxos value adoption: the highest accepted value governs)
                state["has_accept"] = True
            if reply.has_definition or reply.route is not None:
                state["has_definition"] = state["has_definition"] or reply.has_definition
                if reply.route is not None:
                    state["learned_route"] = reply.route if state["learned_route"] is None \
                        else state["learned_route"]
            if tracker.record_success(from_node) is RequestStatus.SUCCESS:
                if state["has_definition"] or state["has_accept"]:
                    escalate(state["learned_route"] if state["learned_route"] is not None
                             else route)
                else:
                    commit_invalidate()

        def on_failure(self, from_node: int, failure: BaseException) -> None:
            if state["done"]:
                return
            if tracker.record_failure(from_node) is RequestStatus.FAILED:
                finish(Exhausted(txn_id, "invalidate quorum unreachable"))

    scope = route.home_key_only()
    callback = InvalidateCallback()
    for to in shard.nodes:
        node.send(to, AcceptInvalidate(txn_id, scope, txn_id.epoch, ballot), callback)


class _AwaitCommit:
    """Quorum WaitOnCommit on one txn's participants (Recover.AwaitCommit)."""

    def __init__(self, node: "Node", txn_id: TxnId, participants):
        self.result = au.settable()
        # Deps.participants returns the (RoutingKeys, Ranges) footprint pair
        keys, ranges = participants
        if len(keys):
            route = Route.for_keys(keys[0], keys)
        else:
            route = Route.for_ranges(ranges[0].start, ranges)
        topologies = node.topology.precise_epochs(route, txn_id.epoch, txn_id.epoch)
        tracker = QuorumTracker(topologies)
        this = self

        class WaitCallback(Callback):
            def on_success(self, from_node: int, reply) -> None:
                if tracker.record_success(from_node) is RequestStatus.SUCCESS:
                    this.result.try_success(None)

            def on_failure(self, from_node: int, failure: BaseException) -> None:
                if tracker.record_failure(from_node) is RequestStatus.FAILED:
                    this.result.set_failure(Timeout(txn_id, "await-commit quorum unreachable"))

        callback = WaitCallback()
        for to in tracker.nodes():
            scope = TxnRequest.compute_scope(to, topologies, route)
            if scope is None:
                continue
            node.send(to, WaitOnCommit(txn_id, scope,
                                       TxnRequest.compute_wait_for_epoch(to, topologies)),
                      callback)
