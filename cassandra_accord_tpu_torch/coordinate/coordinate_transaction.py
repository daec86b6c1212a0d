"""The coordinator-side transaction pipeline.

Capability parity with ``accord.coordinate`` CoordinateTransaction / CoordinatePreAccept
/ Propose / Stabilise / ExecuteTxn / PersistTxn (CoordinateTransaction.java:50-113,
CoordinatePreAccept.java:51-164, Propose.java:1-234, CoordinationAdapter.java:48-331):

  PreAccept round (FastPathTracker)
    fast path:  witnessedAt == txnId at a fast-path quorum of every shard
                -> executeAt = txnId, deps = merge of fast-path-voting replicas' deps
                -> Execute (Stable+Read fused)
    slow path:  executeAt = mergeMax(witnessedAt); Propose (Accept round, ballot 0)
                -> deps at executeAt from AcceptOks -> Stabilise+Execute
  Execute:      Stable(+Read) to one replica per shard, Stable to the rest;
                on data from every shard: Writes = txn.execute, Result = txn.result
  Persist:      reply to client FIRST, then Apply.Minimal to every replica
                (CoordinationAdapter.java:192-197).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Set

from ..messages.base import Callback, FailureReply, TxnRequest
from ..messages.txn_messages import (
    Accept, AcceptNack, AcceptOk, Apply, ApplyOk, Commit, CommitNack, CommitOk,
    PreAccept, PreAcceptNack, PreAcceptOk, ReadNack, ReadOk,
)
from ..local.status import SaveStatus
from ..primitives.deps import Deps
from ..primitives.route import Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from ..primitives.txn import Txn
from ..utils import async_ as au
from .errors import Exhausted, Insufficient, Invalidated, Preempted, Timeout
from .tracking import (AppliedTracker, FastPathTracker, QuorumTracker, ReadTracker,
                       RequestStatus)

if TYPE_CHECKING:
    from ..local.node import Node


class ExecutePath:
    FAST = "fast"
    SLOW = "slow"
    RECOVER = "recover"


def coordinate_transaction(node: "Node", txn_id: TxnId, txn: Txn,
                           result: au.Settable) -> None:
    route = node.compute_route(txn)
    _CoordinateTransaction(node, txn_id, txn, route, result).start()


class _CoordinateTransaction:
    def __init__(self, node: "Node", txn_id: TxnId, txn: Txn, route: Route,
                 result: au.Settable):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.result = result
        self.topologies = node.topology.with_unsynced_epochs(route, txn_id.epoch, txn_id.epoch)

    # -- PreAccept round ----------------------------------------------------
    def start(self) -> None:
        tracker = FastPathTracker(self.topologies)
        oks: Dict[int, PreAcceptOk] = {}
        this = self

        class PreAcceptCallback(Callback):
            done = False

            def on_success(self, from_node: int, reply) -> None:
                if self.done:
                    return
                if isinstance(reply, PreAcceptNack):
                    # a competing ballot exists (recovery in progress)
                    status = tracker.record_failure(from_node)
                else:
                    oks[from_node] = reply
                    status = tracker.record_success(from_node, reply.witnessed_fast_path)
                if status is RequestStatus.SUCCESS:
                    self.done = True
                    this.on_preaccepted(tracker, oks)
                elif status is RequestStatus.FAILED:
                    self.done = True
                    this.result.set_failure(Exhausted(this.txn_id, "preaccept"))

            def on_failure(self, from_node: int, failure: BaseException) -> None:
                if self.done:
                    return
                # a failure can DECIDE the round: an unreachable electorate
                # member is a fast-path reject, so the tracker may flip to
                # SUCCESS (slow path) here — not just FAILED
                status = tracker.record_failure(from_node)
                if status is RequestStatus.SUCCESS:
                    self.done = True
                    this.on_preaccepted(tracker, oks)
                elif status is RequestStatus.FAILED:
                    self.done = True
                    this.result.set_failure(Exhausted(this.txn_id, "preaccept"))

        callback = PreAcceptCallback()
        max_epoch = self.topologies.current_epoch
        self.node.send_to_each(
            tracker.nodes(),
            lambda to: self._preaccept_for(to, max_epoch),
            callback)

    def _preaccept_for(self, to: int, max_epoch: int) -> Optional[PreAccept]:
        scope = TxnRequest.compute_scope(to, self.topologies, self.route)
        if scope is None:
            return None
        wait_for = TxnRequest.compute_wait_for_epoch(to, self.topologies)
        partial = self.txn.slice(_scope_ranges(self.node, scope, max_epoch), to == self.node.id)
        return PreAccept(self.txn_id, scope, wait_for, partial, max_epoch,
                         route=self.route)

    def on_preaccepted(self, tracker: FastPathTracker, oks: Dict[int, PreAcceptOk]) -> None:
        # executeAt = fold mergeMax over witnessed timestamps (CoordinatePreAccept:152-163)
        execute_at: Optional[Timestamp] = None
        for ok in oks.values():
            execute_at = ok.witnessed_at if execute_at is None else execute_at.merge_max(ok.witnessed_at)

        observer = getattr(self.node, "observer", None)
        if tracker.has_fast_path_accepted():
            if observer is not None:
                observer.on_path(self.txn_id, ExecutePath.FAST,
                                 tracker.fast_path_votes())
            # merge deps only from replicas that voted fast-path (they witnessed
            # everything that could execute before us) — CoordinateTransaction:71-77
            deps = Deps.merge([ok.deps for ok in oks.values() if ok.witnessed_fast_path])
            self.execute(ExecutePath.FAST, self.txn_id.as_timestamp(), deps)
        elif execute_at is not None and execute_at.is_rejected:
            self.result.set_failure(Invalidated(self.txn_id, "preaccept rejected"))
        else:
            if observer is not None:
                observer.on_path(self.txn_id, ExecutePath.SLOW,
                                 tracker.fast_path_votes())
            deps = Deps.merge([ok.deps for ok in oks.values()])
            self.extend_to_epoch(execute_at,
                                 lambda: self.propose(Ballot.ZERO, execute_at, deps))

    def extend_to_epoch(self, execute_at: Timestamp, cont) -> None:
        """Epoch-spanning coordination (CoordinationAdapter.Invoke topology
        recompute; AbstractCoordinatePreAccept epoch-extension): when executeAt
        lands in a later epoch than txnId, every subsequent round must also
        contact the execution epoch's replicas — otherwise replicas that joined
        in the new epoch never receive Stable/Apply and replica sets diverge."""
        if execute_at is None or execute_at.epoch <= self.topologies.current_epoch:
            cont()
            return

        def go(_v, f):
            if f is not None:
                self.result.set_failure(f)
                return
            self.topologies = self.node.topology.with_unsynced_epochs(
                self.route, self.txn_id.epoch, execute_at.epoch)
            cont()

        self.node.with_epoch(execute_at.epoch).begin(go)

    # -- Propose (Accept round, Propose.java) --------------------------------
    def propose(self, ballot: Ballot, execute_at: Timestamp, deps: Deps) -> None:
        topologies = self.topologies
        tracker = QuorumTracker(topologies)
        accept_oks: List[AcceptOk] = []
        this = self

        class AcceptCallback(Callback):
            done = False

            def on_success(self, from_node: int, reply) -> None:
                if self.done:
                    return
                if isinstance(reply, AcceptNack):
                    self.done = True
                    this.result.set_failure(Preempted(this.txn_id, f"by {reply.supersceded_by}"))
                    return
                accept_oks.append(reply)
                if tracker.record_success(from_node) is RequestStatus.SUCCESS:
                    self.done = True
                    stable_deps = this.merge_accept_deps(deps, accept_oks)
                    this.stabilise_and_execute(execute_at, stable_deps, ballot)

            def on_failure(self, from_node: int, failure: BaseException) -> None:
                if self.done:
                    return
                if tracker.record_failure(from_node) is RequestStatus.FAILED:
                    self.done = True
                    this.result.set_failure(Exhausted(this.txn_id, "accept"))

        callback = AcceptCallback()
        self.node.send_to_each(
            tracker.nodes(),
            lambda to: self._accept_for(to, ballot, execute_at, deps),
            callback)

    def _accept_for(self, to: int, ballot: Ballot, execute_at: Timestamp,
                    deps: Deps) -> Optional[Accept]:
        scope = TxnRequest.compute_scope(to, self.topologies, self.route)
        if scope is None:
            return None
        wait_for = TxnRequest.compute_wait_for_epoch(to, self.topologies)
        ranges = _scope_ranges(self.node, scope, self.topologies.current_epoch)
        from ..primitives.keys import Ranges as _Ranges
        keys = self.txn.keys.intersection(ranges) if isinstance(self.txn.keys, _Ranges) \
            else self.txn.keys.slice(ranges)
        return Accept(self.txn_id, scope, wait_for, ballot, execute_at,
                      keys, deps.slice(ranges), route=self.route)

    def merge_accept_deps(self, deps: Deps, accept_oks: List[AcceptOk]) -> Deps:
        """Deps at executeAt = merge of accept-ok deps (Propose.java).  Sync
        points override: their deps are fixed by PreAccept (all < txnId), so
        waiting never forms cycles between concurrent sync points
        (CoordinateSyncPoint.java:129 'we don't need to fetch deps from Accept')."""
        return Deps.merge([deps] + [ok.deps for ok in accept_oks])

    # -- Stabilise + Execute -------------------------------------------------
    def execute(self, path: str, execute_at: Timestamp, deps: Deps) -> None:
        """Fast path: Stable+Read immediately (stability is recoverable from the
        fast-path quorum)."""
        _ExecuteTxn(self.node, self.txn_id, self.txn, self.route, self.topologies,
                    SaveStatus.STABLE, execute_at, deps, self.result,
                    require_stable_quorum=False).start()

    def stabilise_and_execute(self, execute_at: Timestamp, deps: Deps,
                              ballot: Ballot = Ballot.ZERO) -> None:
        """Slow path: the Stable round must reach a quorum per shard before the
        outcome is reported, so recovery always finds the stable deps
        (Stabilise.java)."""
        _ExecuteTxn(self.node, self.txn_id, self.txn, self.route, self.topologies,
                    SaveStatus.STABLE, execute_at, deps, self.result,
                    require_stable_quorum=True, ballot=ballot).start()


class _ExecuteTxn:
    """Sends Stable(+Read fused) and collects per-shard Data (ExecuteTxn.java:53-200,
    ReadCoordinator.java)."""

    def __init__(self, node: "Node", txn_id: TxnId, txn: Txn, route: Route,
                 topologies, kind_status: SaveStatus, execute_at: Timestamp, deps: Deps,
                 result: au.Settable, require_stable_quorum: bool,
                 ballot: Ballot = Ballot.ZERO):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.topologies = topologies
        self.kind_status = kind_status
        self.execute_at = execute_at
        self.deps = deps
        self.result = result
        self.require_stable_quorum = require_stable_quorum
        self.ballot = ballot
        # reads execute against the EXECUTION epoch's replicas only (a replica
        # that lost a range by then cannot serve its data) — ExecuteTxn.java
        from ..topology.topology import Topologies
        self.read_tracker = ReadTracker(Topologies([topologies.current()]))
        self.stable_tracker = QuorumTracker(topologies)
        self.data = None
        self.done = False
        # partial-coverage accounting: per shard, the footprint slice still
        # unread.  A replica mid-bootstrap serves its clean slice and reports
        # the pending remainder unavailable (ReadOk.unavailable); coverage
        # completes when the UNION of replies covers each shard — no single
        # replica needs to serve the whole slice (ReadCoordinator capability;
        # without it, wide range reads deadlocked against bootstrap fences
        # under topology churn)
        # transient-nack read re-rounds: obsolete/unavailable mean a replica
        # state that RESOLVES by itself (PRE_APPLIED drains to APPLIED, where
        # the MVCC read serves; bootstrap completes) — when a read round
        # exhausts on only those, re-run it after a beat instead of failing
        # the whole (often recovery-driven) execution.  Bounded so a
        # genuinely wedged footprint still escalates (sustained-chaos
        # recovery livelocked exactly here: every copy raced to APPLIED and
        # each attempt's reads exhausted on obsolete — seed-4 churn stall).
        self.read_rounds = 0
        self._read_retry_pending = False
        self._init_unread()
        # grandfathered-coverage accounting (the seed-6 refencing wedge):
        # residue snapshot at the last retry-round launch — a round that
        # strictly SHRANK the residue doesn't charge the round budget
        self._last_residue = None

    MAX_READ_ROUNDS = 3

    def _init_unread(self) -> None:
        parts = self.route.participants()
        from ..primitives.keys import Ranges as _Rs
        self._unread = {}
        for i, t in enumerate(self.read_tracker.trackers):
            if isinstance(parts, _Rs):
                sl = parts.intersection(_Rs.of(t.shard.range))
                if len(sl):
                    self._unread[i] = sl
            else:
                ks = {k for k in parts if t.shard.range.contains(k)}
                if ks:
                    self._unread[i] = ks

    def _residue_snapshot(self):
        """Canonical snapshot of the per-shard unread residues.  Coverage is
        monotone (``absorb_partial`` only intersects), so inequality with the
        previous round's snapshot means the residue strictly shrank."""
        out = []
        for i in sorted(self._unread):
            cur = self._unread[i]
            if isinstance(cur, set):
                out.append((i, tuple(sorted(cur))))
            else:
                out.append((i, tuple((r.start, r.end) for r in cur)))
        return tuple(out)

    def retry_read_round_or_fail(self) -> None:
        """A read round exhausted on TRANSIENT nacks (obsolete: the copy is
        mid-apply and will serve from the MVCC snapshot once APPLIED;
        unavailable: bootstrap in flight).  Re-run the round after a beat —
        bounded, so a genuinely wedged footprint still fails the attempt.

        One retry per ROUND: the tracker reports FAILED independently per
        exhausted shard, and without the pending guard a multi-shard route
        would burn the whole round budget (and launch racing duplicate
        rounds) on a single exhaustion."""
        if self._read_retry_pending:
            return
        cfg = getattr(self.node, "config", None)
        max_rounds = cfg.max_read_rounds if cfg is not None \
            else self.MAX_READ_ROUNDS
        snap = self._residue_snapshot()
        if self._last_residue is not None and snap != self._last_residue:
            # the last round strictly shrank the unread residue: coverage IS
            # assembling, so the round is progress, not a failure — only
            # NO-PROGRESS rounds charge the budget (the residue is monotone
            # non-increasing over a finite set of reply boundaries, so this
            # still terminates).  Without it, the round budget raced the
            # truncation/staleness ladder's re-fencing cadence and a read
            # gathering one new slice per round still exhausted (seed 6).
            self.read_rounds = 0
        self._last_residue = snap
        if self.read_rounds >= max_rounds:
            # NOTE: rounds exhausted partly by hard (link FAILURE) replies
            # still retry — in the chaos model link failures are transient
            # (links re-randomize every few sim-seconds), and failing the
            # attempt on any hard failure livelocks recovery churn (measured:
            # hostile seed 0 stalls).  A shard whose candidates ALL hard-fail
            # already Exhausts immediately via on_failure.
            self.done = True
            self.result.set_failure(Exhausted(self.txn_id, "read"))
            return
        self.read_rounds += 1
        self._read_retry_pending = True

        def go():
            self._read_retry_pending = False
            if self.done:
                return
            from ..topology.topology import Topologies
            # GRANDFATHER the assembled coverage (the seed-6 refencing
            # wedge): slices already served are FINAL — the read is at a
            # fixed executeAt and the data store is an immutable MVCC
            # snapshot there — so the union built in earlier rounds
            # survives into this one.  Resetting it each round raced
            # coverage assembly against the truncation/staleness ladder's
            # re-fencing cadence: every round restarted from zero while a
            # fresh catch-up fence kept SOME slice pending somewhere, and
            # the budget exhausted into Exhausted(read) -> recovery churn.
            prev_unread = self._unread
            self.read_tracker = ReadTracker(Topologies([self.topologies.current()]))
            self._init_unread()
            for i in list(self._unread):
                if i in prev_unread:
                    self._unread[i] = prev_unread[i]
            # shards the union already covers need no further reads: mark
            # them read so neither contacts nor candidate exhaustion is
            # burned on them (their data was banked in an earlier round)
            for i, t in enumerate(self.read_tracker.trackers):
                cur = self._unread.get(i)
                if cur is None or not len(cur):
                    t.data_received = True
            # rotate EVERY shard's pick per round: re-contacting the same
            # (deterministically chosen) stuck copy every round re-creates
            # the livelock the rounds exist to break
            for to in self.read_tracker.initial_contacts(
                    prefer=self.node.id, rotate=self.read_rounds,
                    avoid=self.node.slow_peers()):
                self.send_read_retry(to)
            self._arm_read_speculation()   # retry rounds speculate too
        delay = cfg.read_retry_delay_s if cfg is not None else 0.15
        self.node.scheduler.once(delay, go)

    @property
    def needs_read(self) -> bool:
        """Sync points (and any read-less txn) have no data to collect: their
        execution phase is a pure dependency wait at the replicas, so no read
        is fused with Stable (ExecuteSyncPoint vs ExecuteTxn,
        CoordinationAdapter.java:214-264)."""
        return self.txn.read is not None and not self.txn_id.kind.is_sync_point

    def start(self) -> None:
        # route the per-shard data reads around peers the gray-failure
        # tracker currently marks slow (paused-but-alive, stalled disk):
        # contacting one burns a whole reply-timeout + speculation round
        read_nodes = set(self.read_tracker.initial_contacts(
            prefer=self.node.id, avoid=self.node.slow_peers())) \
            if self.needs_read else set()
        this = self

        class ExecuteCallback(Callback):
            def on_success(self, from_node: int, reply) -> None:
                if this.done:
                    return
                if isinstance(reply, ReadOk):
                    if reply.data is not None:
                        this.data = reply.data if this.data is None else this.data.merge(reply.data)
                    this.on_stable_ack(from_node)
                    if reply.unavailable is not None and len(reply.unavailable):
                        # partial read: absorb the served slice; the shard
                        # completes when the union of replies covers it
                        if this.absorb_partial(from_node, reply.unavailable):
                            if this.read_tracker.record_read_success(from_node) \
                                    is RequestStatus.SUCCESS:
                                this.maybe_finish()
                            return
                        status, retries = this.read_tracker.record_read_failure(
                            from_node, avoid=this.node.slow_peers())
                        if status is RequestStatus.FAILED:
                            this.retry_read_round_or_fail()
                            return
                        for to in retries:
                            this.send_read_retry(to)
                        return
                    this.absorb_partial(from_node, None)
                    if not this.done and this.read_tracker.record_read_success(from_node) \
                            is RequestStatus.SUCCESS:
                        this.maybe_finish()
                elif isinstance(reply, ReadNack):
                    if reply.reason in ("unavailable", "obsolete"):
                        # bootstrapping replica, or one that raced past
                        # ReadyToExecute (an Apply won): read elsewhere
                        # (the Stable part already acked separately)
                        status, retries = this.read_tracker.record_read_failure(
                            from_node, avoid=this.node.slow_peers())
                        if status is RequestStatus.FAILED:
                            this.retry_read_round_or_fail()
                            return
                        for to in retries:
                            this.send_read_retry(to)
                        return
                    this.done = True
                    this.result.set_failure(Insufficient(this.txn_id, reply.reason))
                elif isinstance(reply, CommitNack):
                    from ..local.commands import CommitOutcome
                    this.done = True
                    if reply.outcome is CommitOutcome.REJECTED_BALLOT:
                        this.result.set_failure(Preempted(this.txn_id, "commit"))
                    else:
                        this.result.set_failure(Insufficient(this.txn_id, str(reply.outcome)))
                else:  # CommitOk / StableAck
                    this.on_stable_ack(from_node)
                    if not this.done:
                        this.maybe_finish()

            def on_failure(self, from_node: int, failure: BaseException) -> None:
                if this.done:
                    return
                if this.stable_tracker.record_failure(from_node) is RequestStatus.FAILED:
                    this.done = True
                    this.result.set_failure(Exhausted(this.txn_id, "stabilise"))
                    return
                if not this.needs_read:
                    return
                status, retries = this.read_tracker.record_read_failure(
                    from_node, avoid=this.node.slow_peers())
                if status is RequestStatus.FAILED:
                    this.done = True
                    this.result.set_failure(Exhausted(this.txn_id, "read"))
                    return
                for to in retries:
                    this.send_read_retry(to)

        self.callback = ExecuteCallback()
        # send_to_each: a node whose route scope slice is empty (topology
        # churn) must FAIL its tracker slot, not silently skip — the same
        # hang fixed in Node.send_to_each applies to this tracker too
        self.node.send_to_each(
            self.stable_tracker.nodes(),
            lambda to: self.commit_for(to, read=to in read_nodes),
            self.callback)
        if read_nodes:
            self._arm_read_speculation()

    def _arm_read_speculation(self) -> None:
        """Slow-replica read speculation (ReadTracker.java): if any shard's
        data read hasn't answered within the slow threshold, speculatively
        contact the next-preferred replica — without failing the slow one.
        The reference speculates immediately on its slow signal; waiting for
        the failure path instead costs whole reply-timeout rounds under
        chaos (VERDICT r04 item 3)."""
        cfg = getattr(self.node, "config", None)
        delay = cfg.slow_read_threshold_s if cfg is not None else 1.5

        def fire():
            if self.done:
                return
            for to in self.read_tracker.speculate(
                    avoid=self.node.slow_peers()):
                self.send_read_retry(to)
        self.node.scheduler.once(delay, fire)

    def commit_for(self, to: int, read: bool) -> Optional[Commit]:
        scope = TxnRequest.compute_scope(to, self.topologies, self.route)
        if scope is None:
            return None
        wait_for = TxnRequest.compute_wait_for_epoch(to, self.topologies)
        ranges = _scope_ranges(self.node, scope, self.topologies.current_epoch)
        partial = self.txn.slice(ranges, to == self.node.id)
        return Commit(self.txn_id, scope, wait_for, self.kind_status, self.execute_at,
                      partial, self.deps.slice(ranges), read=read, ballot=self.ballot,
                      route=self.route)

    def send_read_retry(self, to: int) -> None:
        self.node.send_to_each([to], lambda t: self.commit_for(t, read=True),
                               self.callback)

    def on_stable_ack(self, from_node: int) -> None:
        self.stable_tracker.record_success(from_node)

    def absorb_partial(self, from_node: int, unavailable) -> bool:
        """Fold one read reply's coverage into the per-shard unread residue:
        remaining = remaining ∩ unavailable (what this replica could NOT
        serve).  Returns True iff every shard this node was reading for is
        now fully covered by the union of replies so far."""
        all_covered = True
        for i, t in enumerate(self.read_tracker.trackers):
            if from_node not in t.in_flight_reads:
                continue
            cur = self._unread.get(i)
            if cur is None:
                continue
            if unavailable is None or not len(unavailable):
                cur = type(cur)() if isinstance(cur, set) else cur.without(cur)
            elif isinstance(cur, set):
                cur = {k for k in cur if unavailable.contains(k)}
            else:
                cur = cur.intersection(unavailable)
            self._unread[i] = cur
            if cur and len(cur):
                all_covered = False
            else:
                # the union of replies covers this shard: it is READ — the
                # tracker must not burn further candidates on it (exhausting
                # them reported spurious read failure while coverage was
                # already complete)
                t.data_received = True
        return all_covered

    def maybe_finish(self) -> None:
        if self.done:
            return
        reads_done = not self.needs_read \
            or self.read_tracker._all_success(lambda t: t.data_received)
        stable_done = (not self.require_stable_quorum
                       or self.stable_tracker.has_reached_quorum())
        if reads_done and stable_done:
            self.done = True
            self.persist()

    # -- Persist (PersistTxn; client callback FIRST) -------------------------
    def persist(self) -> None:
        txn_result = self.txn.result(self.txn_id, self.execute_at, self.data)
        writes = self.txn.execute(self.txn_id, self.execute_at, self.data)
        self.result.set_success(txn_result)
        # sync points always apply Maximal so any replica (e.g. one that never
        # witnessed it) can apply without prior state (CoordinationAdapter:214-264)
        apply_kind = Apply.MAXIMAL if self.txn_id.kind.is_sync_point else Apply.MINIMAL
        self.send_applies(writes, txn_result, apply_kind,
                          on_quorum_applied=self.inform_durable)

    def send_applies(self, writes, txn_result, apply_kind: str,
                     on_quorum_applied=None, on_quorum_impossible=None) -> None:
        """Broadcast Apply to every replica; fire ``on_quorum_applied`` once a
        quorum of every shard has acked (PersistTxn.java; progress logs then
        stand down via InformDurable), or ``on_quorum_impossible`` once some
        shard can no longer reach an apply quorum.  MAXIMAL applies carry the
        full txn definition so any replica can apply without prior state.

        When EVERY contacted replica acks, a second InformDurable wave
        upgrades the txn to UNIVERSAL — per-txn universal durability is the
        sound gate for transitive-elision (a merely-majority-applied txn may
        be unapplied at the very replica a later txn's elided deps reach;
        universality is what the range durability rounds proved when they
        were the only gate)."""
        applied = AppliedTracker(self.topologies)
        this = self
        contacted: List[int] = []

        class ApplyCallback(Callback):
            informed = False
            acked: Set[int] = set()
            impossible_universal = False

            def _failed(self, from_node: int) -> None:
                self.impossible_universal = True
                if applied.record_failure(from_node) is RequestStatus.FAILED \
                        and not self.informed:
                    self.informed = True
                    if on_quorum_impossible is not None:
                        on_quorum_impossible()

            def on_success(self, from_node: int, reply) -> None:
                if not isinstance(reply, ApplyOk):
                    # e.g. ReadNack("insufficient"): NOT a durable apply ack
                    self._failed(from_node)
                    return
                if not self.informed \
                        and applied.record_success(from_node) is RequestStatus.SUCCESS:
                    self.informed = True
                    if on_quorum_applied is not None:
                        on_quorum_applied()
                self.acked.add(from_node)
                if not self.impossible_universal \
                        and len(self.acked) == len(contacted):
                    this.inform_universal()

            def on_failure(self, from_node: int, failure: BaseException) -> None:
                self._failed(from_node)

        callback = ApplyCallback()
        for to in self.topologies.nodes():
            scope = TxnRequest.compute_scope(to, self.topologies, self.route)
            if scope is None:
                continue
            contacted.append(to)
            wait_for = TxnRequest.compute_wait_for_epoch(to, self.topologies)
            ranges = _scope_ranges(self.node, scope, self.topologies.current_epoch)
            partial_txn = self.txn.slice(ranges, include_query=False) \
                if apply_kind == Apply.MAXIMAL else None
            self.node.send(to, Apply(
                self.txn_id, scope, wait_for, apply_kind, self.execute_at,
                self.deps.slice(ranges), partial_txn, writes.slice(ranges),
                txn_result, route=self.route), callback)

    def inform_universal(self) -> None:
        """Every contacted replica acked its Apply: broadcast the UNIVERSAL
        durability upgrade (widens the per-txn elision gate everywhere)."""
        from ..local.status import Durability
        from ..messages.status_messages import InformDurable
        for to in self.topologies.nodes():
            scope = TxnRequest.compute_scope(to, self.topologies, self.route)
            if scope is None:
                continue
            wait_for = TxnRequest.compute_wait_for_epoch(to, self.topologies)
            self.node.send(to, InformDurable(self.txn_id, scope, wait_for,
                                             self.execute_at,
                                             Durability.UNIVERSAL))

    def inform_durable(self) -> None:
        from ..local.status import Durability
        from ..messages.status_messages import InformDurable, InformHomeDurable
        for to in self.topologies.nodes():
            scope = TxnRequest.compute_scope(to, self.topologies, self.route)
            if scope is None:
                continue
            wait_for = TxnRequest.compute_wait_for_epoch(to, self.topologies)
            self.node.send(to, InformDurable(self.txn_id, scope, wait_for,
                                             self.execute_at, Durability.MAJORITY))
        # the HOME shard owns global progress responsibility: tell it
        # explicitly so its progress machinery stands down even where it
        # holds no data for the txn (InformHomeDurable.java)
        home_scope = self.route.home_key_only()
        topology = self.node.topology.topology_for_epoch(self.txn_id.epoch)
        shard = topology.for_key_required(self.route.home_key)
        for to in shard.nodes:
            self.node.send(to, InformHomeDurable(
                self.txn_id, home_scope, self.txn_id.epoch,
                self.execute_at, Durability.MAJORITY))


# ---------------------------------------------------------------------------
# Recovery re-entry points (CoordinationAdapter.Step.InitiateRecovery): recovery
# resumes the standard pipeline at the phase matching the strongest evidence it
# found, carrying its ballot through every subsequent round.
# ---------------------------------------------------------------------------

def _resume_coordinator(node: "Node", txn_id: TxnId, txn: Txn, route: Route,
                        result: au.Settable) -> "_CoordinateTransaction":
    """Recovery resume must drive sync points through the sync-point adapter:
    their execution phase is a pure dependency wait with MAXIMAL applies and NO
    read round — resuming one through the txn adapter sends reads that replicas
    past ReadyToExecute nack as obsolete, exhausting every recovery attempt
    (CoordinationAdapter recovery adapters, CoordinationAdapter.java:214-264)."""
    if txn_id.kind.is_sync_point:
        from .sync_point import _CoordinateSyncPoint
        return _CoordinateSyncPoint(node, txn_id, txn, route, result, blocking=True)
    return _CoordinateTransaction(node, txn_id, txn, route, result)


def resume_propose(node: "Node", txn_id: TxnId, txn: Txn, route: Route,
                   result: au.Settable, ballot: Ballot, execute_at: Timestamp,
                   deps: Deps) -> None:
    """Re-run the Accept round at ``ballot`` (recovery of an Accepted txn, or
    re-proposal at txnId when the fast path may have succeeded)."""
    c = _resume_coordinator(node, txn_id, txn, route, result)
    c.extend_to_epoch(execute_at, lambda: c.propose(ballot, execute_at, deps))


def resume_stabilise(node: "Node", txn_id: TxnId, txn: Txn, route: Route,
                     result: au.Settable, ballot: Ballot, execute_at: Timestamp,
                     deps: Deps) -> None:
    """Re-run Stable+Execute (recovery of a Committed/Stable txn)."""
    c = _resume_coordinator(node, txn_id, txn, route, result)
    c.extend_to_epoch(execute_at,
                      lambda: c.stabilise_and_execute(execute_at, deps, ballot))


def persist_maximal(node: "Node", txn_id: TxnId, txn: Txn, route: Route,
                    topologies, execute_at: Timestamp, deps: Deps, writes,
                    txn_result) -> None:
    """Broadcast Apply.Maximal — carrying the full txn definition and deps so any
    replica can apply without prior state (recovery with a known outcome,
    Persist.java / CoordinationAdapter.java:192-197)."""
    for to in topologies.nodes():
        scope = TxnRequest.compute_scope(to, topologies, route)
        if scope is None:
            continue
        wait_for = TxnRequest.compute_wait_for_epoch(to, topologies)
        ranges = _scope_ranges(node, scope, topologies.current_epoch)
        node.send(to, Apply(
            txn_id, scope, wait_for, Apply.MAXIMAL, execute_at,
            deps.slice(ranges), txn.slice(ranges, include_query=False),
            writes.slice(ranges) if writes is not None else None, txn_result,
            route=route))


def _scope_ranges(node: "Node", scope: Route, max_epoch: int):
    """The ranges a scope covers (for slicing txn/deps payloads)."""
    if scope.covering is not None:
        return scope.covering
    from ..primitives.keys import Ranges
    out = Ranges.EMPTY
    for e in range(node.topology.min_epoch, max_epoch + 1):
        if node.topology.has_epoch(e):
            out = out.union(node.topology.topology_for_epoch(e).ranges())
    return out
