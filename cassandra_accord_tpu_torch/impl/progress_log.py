"""The reference progress log: home-shard liveness monitoring + blocked-dependency
resolution.

Capability parity with ``accord.impl.SimpleProgressLog`` (SimpleProgressLog.java:78-729):

- **CoordinateState** (home shard only): every txn whose progress shard is this
  store is monitored until durably settled.  Each poll compares the txn's
  ProgressToken against the last poll; no advancement means the coordinator may
  have died, so escalate through ``maybe_recover`` (CheckStatus probe, then full
  recovery / invalidation).  Polls are staggered by the owning node's scheduler.

- **BlockingState**: when a Stable command reports it is waiting on a dependency
  (``waiting`` callback), the blocking txn is monitored; if it stays undecided
  locally, fetch its state from its participants' replicas (FetchData -> local
  Propagate upgrade); if the whole cluster has nothing committed for it, recovery
  of the *blocking* txn is escalated the same way (it was pre-accepted by our
  PreAccept round, so its home shard may know nothing — recovery invalidates it).
"""
from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Dict, Optional

from ..api.interfaces import ProgressLog
from ..local.status import SaveStatus, Status
from ..protocol_batch.columns import ENGAGE_FLOOR
from ..primitives.route import Route
from ..primitives.timestamp import TxnId
from ..utils.invariants import check_state

if TYPE_CHECKING:
    from ..local.command_store import CommandStore


class Progress(enum.Enum):
    EXPECTED = 0        # progress expected from elsewhere; check next poll
    NO_PROGRESS = 1     # nothing moved since last poll; escalate now
    INVESTIGATING = 2   # a probe/recovery is in flight
    DONE = 3


class _MonitorState:
    """Per-txn monitoring record, used both for home-shard coordination
    monitoring and for blocked-dependency resolution.

    ``backoff``/``cooldown``: after a failed investigation (preempted, quorum
    unreachable) the monitor sits out an exponentially growing number of polls
    before escalating again — without this, several nodes monitoring the same
    stuck txn perpetually preempt each other's recovery/invalidation ballots
    (the reference staggers its retries through randomized requeue delays,
    SimpleProgressLog.java)."""
    __slots__ = ("txn_id", "route", "progress", "token", "backoff", "cooldown")

    def __init__(self, txn_id: TxnId, route: Route):
        self.txn_id = txn_id
        self.route = route
        self.progress = Progress.EXPECTED
        self.token = None
        self.backoff = 0
        self.cooldown = 0

    def investigation_failed(self) -> None:
        # ballot-only movement no longer resets the backoff (material-advance
        # gating), so mutual preemption decays on its own — the cap can stay
        # low for fast retries once the cluster heals
        self.backoff = min(self.backoff * 2 + 1, 8)
        self.cooldown = self.backoff
        self.progress = Progress.NO_PROGRESS

    def investigation_progressed(self) -> None:
        self.backoff = 0
        self.cooldown = 0

    def in_cooldown(self) -> bool:
        if self.cooldown > 0:
            self.cooldown -= 1
            return True
        return False


_CoordinateState = _MonitorState
_BlockingState = _MonitorState


class _NonHomeState:
    """A txn pre-accepted here whose home shard is elsewhere: if it stays
    undecided, tell the home shard it exists (InformHomeOfTxn semantics) so its
    progress log starts monitoring."""
    __slots__ = ("txn_id", "route", "polls")

    def __init__(self, txn_id: TxnId, route: Route):
        self.txn_id = txn_id
        self.route = route
        self.polls = 0


class SimpleProgressLog(ProgressLog):
    """One instance per CommandStore; all callbacks arrive inside the store."""

    def __init__(self, store: "CommandStore", poll_interval_s: float = 0.5):
        self.store = store
        self.node = store.node
        self.coordinating: Dict[TxnId, _CoordinateState] = {}
        self.blocking: Dict[TxnId, _BlockingState] = {}
        self.non_home: Dict[TxnId, _NonHomeState] = {}
        # jittered cadence: [0.6, 1.6) × base, resampled per cycle, so polls of
        # different stores/nodes never stay aligned (cross-node recovery
        # collisions would otherwise livelock on mutual preemption)
        rng = self.node.random.fork()
        interval = lambda: poll_interval_s * (0.6 + rng.next_float())  # noqa: E731
        self._scheduled = self.node.scheduler.recurring(interval, self._poll)
        # retry budget (local/overload.py): a deterministic token bucket
        # bounding investigation/blocked-fetch launches per sim-second.  The
        # stagger window spreads a herd WITHIN a poll tick; the budget bounds
        # the rate ACROSS ticks — under sustained overload the backlog would
        # otherwise relaunch wholesale every poll.  None when the knob is off.
        self._budget = None
        cfg = getattr(self.node, "config", None)
        if cfg is not None and cfg.retry_budget_enabled:
            from ..local.overload import TokenBucket
            self._budget = TokenBucket(
                cfg.retry_budget_rate_s, cfg.retry_budget_burst,
                cfg.retry_budget_jitter,
                salt=(self.node.id << 16) ^ (store.id + 1),
                now_s=self.node.now_micros() / 1e6)

    def close(self) -> None:
        self._scheduled.cancel()

    def resume_after_restart(self) -> None:
        """Post-restart re-investigation seeding (crash-restart nemesis): the
        crash destroyed every monitor, so scan the journal-rebuilt store and
        re-register them.  Undecided home-shard txns resume CoordinateState
        monitoring — a crashed COORDINATOR's own in-flight txns land here, and
        if nothing advances them the next polls escalate through maybe_recover
        so peers supersede the dead coordination (commit or invalidate).
        Non-home undecided txns resume the InformHomeOfTxn path.  Blocked
        STABLE/PRE_APPLIED txns re-enter blocking monitoring separately, via
        the replay pass's maybe_execute -> waiting() callbacks."""
        store = self.store
        for txn_id, command in list(store.commands.items()):
            if command.save_status.ordinal >= SaveStatus.APPLIED.ordinal \
                    or command.save_status is SaveStatus.INVALIDATED \
                    or command.save_status.is_truncated:
                continue
            if command.durability.is_durable or command.route is None:
                continue
            progress_shard = store.current_ranges().contains(
                command.route.home_key)
            self._track(command, progress_shard)

    # -- lifecycle callbacks (home shard monitoring) -------------------------
    def _track(self, command, progress_shard: bool) -> None:
        if command.route is None:
            return
        if not progress_shard:
            if command.txn_id not in self.non_home and command.route.full:
                self.non_home[command.txn_id] = _NonHomeState(command.txn_id, command.route)
            return
        state = self.coordinating.get(command.txn_id)
        if state is None:
            self.coordinating[command.txn_id] = _CoordinateState(command.txn_id, command.route)

    def unwitnessed(self, txn_id, home_key, progress_shard) -> None:
        if progress_shard and txn_id not in self.coordinating:
            cmd = self.store.lookup(txn_id)
            if cmd is not None and cmd.route is not None:
                self.coordinating[txn_id] = _CoordinateState(txn_id, cmd.route)

    def pre_accepted(self, command, progress_shard) -> None:
        self._track(command, progress_shard)

    def accepted(self, command, progress_shard) -> None:
        self._track(command, progress_shard)

    def precommitted(self, command) -> None:
        pass

    def stable(self, command, progress_shard) -> None:
        self._track(command, progress_shard)

    def ready_to_execute(self, command) -> None:
        pass

    def executed(self, command, progress_shard) -> None:
        # outcome reached locally: the home shard's liveness duty is discharged
        # (durability scheduling handles global durability)
        self._done(command.txn_id)

    def durable(self, command) -> None:
        # durability discharges home-shard monitoring, but NOT blocked-dependency
        # tracking: a dep durable elsewhere may still need its writes applied HERE
        self.coordinating.pop(command.txn_id, None)
        self.non_home.pop(command.txn_id, None)

    def invalidated(self, command, progress_shard) -> None:
        self._done(command.txn_id)

    def clear(self, txn_id) -> None:
        self._done(txn_id)

    def _done(self, txn_id: TxnId) -> None:
        self.coordinating.pop(txn_id, None)
        self.blocking.pop(txn_id, None)
        self.non_home.pop(txn_id, None)

    # -- blocked-dependency callbacks ----------------------------------------
    def waiting(self, blocked_by, blocked_until, blocked_on_route,
                blocked_on_participants) -> None:
        if blocked_by in self.blocking:
            return
        route = _route_for_participants(blocked_by, blocked_on_route,
                                        blocked_on_participants)
        # route=None: a txn known only by id (InformOfTxnId-class knowledge) —
        # still monitored; _resolve_blocked discovers the route first
        # (FindSomeRoute/RecoverWithSomeRoute capability)
        self.blocking[blocked_by] = _BlockingState(blocked_by, route)
        self._observe("blocked_monitors")

    # -- the poll loop (SimpleProgressLog.run) --------------------------------
    def _poll(self) -> None:
        self.store.execute(lambda _safe_store: self._poll_in_store())

    def _launch_staggered(self, launch) -> None:
        """Spread investigation launches across the poll window instead of
        firing the whole backlog at one tick: with hundreds of blocked txns a
        same-tick herd of recoveries ballot-preempts itself faster than any
        attempt completes (the sustained-chaos livelock class; the reference
        staggers via randomized requeue delays, SimpleProgressLog.java)."""
        if not hasattr(self, "_stagger_rng"):
            self._stagger_rng = self.node.random.fork()
        window = getattr(self.node, "config", None)
        window = window.investigation_stagger_s if window is not None else 0.5
        delay = window * self._stagger_rng.next_float()
        self.node.scheduler.once(
            delay, lambda: self.store.execute(lambda _s: launch()))

    def _poll_in_store(self) -> None:
        if not self.coordinating and not self.blocking and not self.non_home:
            return   # nothing monitored: skip the import + scan setup
        from ..coordinate.maybe_recover import ProgressToken

        # columnar settlement pre-scan (protocol_batch/): ONE vectorized
        # gather answers "settled / outcome known / resident" for every
        # monitored id instead of a per-txn lookup + attribute chase.  Only
        # RESIDENT rows are decided from the mirror — for those the scalar
        # ``store.lookup`` is a pure dict hit, so skipping it skips no
        # fault-in; non-resident ids take the scalar path unchanged (their
        # lookup may fault evicted state in, which is observable).
        engine = self.store.batch_engine
        coord_ids = list(self.coordinating.keys())
        done_m = outcome_m = resident_m = None
        if engine is not None and len(coord_ids) >= ENGAGE_FLOOR:
            done_m, outcome_m, resident_m = engine.settled_partition(coord_ids)
        for i, txn_id in enumerate(coord_ids):
            state = self.coordinating.get(txn_id)
            if state is None or state.progress is Progress.INVESTIGATING:
                continue
            if resident_m is not None and resident_m[i]:
                if done_m[i]:
                    self._done(txn_id)
                    continue
                if outcome_m[i]:
                    continue
                command = self.store.commands.get(txn_id)  # resident: dict hit
            else:
                command = self.store.lookup(txn_id)
                if command is not None and (
                        command.save_status.ordinal
                        >= SaveStatus.APPLIED.ordinal):
                    self._done(txn_id)
                    continue
                if command is not None and command.save_status.ordinal \
                        >= SaveStatus.PRE_APPLIED.ordinal:
                    # the OUTCOME is already known locally: nothing to
                    # recover — the txn is waiting on its deps' applies,
                    # which the blocked-dep machinery drives.  Launching
                    # recoveries here is what starves applies behind
                    # recovery churn (the PRE_APPLIED-backlog livelock
                    # class: each recovery preempts coordinators actually
                    # draining the chain; the reference's ladder gates
                    # investigation while a txn is advancing,
                    # SimpleProgressLog.java:228-340)
                    continue
            local_token = None if command is None else ProgressToken(
                command.durability, command.save_status.ordinal, command.promised)
            if state.token is None or (local_token is not None
                                       and local_token.advanced_from(state.token)):
                # first poll / local progress since last poll: give it a cycle
                state.token = local_token
                state.progress = Progress.EXPECTED
                continue
            if state.in_cooldown():
                continue
            if not self._budget_ok():
                state.cooldown = max(state.cooldown, 1)
                continue
            state.progress = Progress.INVESTIGATING
            self._launch_staggered(lambda state=state: self._investigate(state))

        # blocking map: the resolved check is the only consumer of the
        # command object, so resident rows answer it entirely from the
        # mirror — no per-txn lookup at all for the (typically large under
        # chaos) still-blocked majority
        block_ids = list(self.blocking.keys())
        resolved_m = bresident_m = None
        if engine is not None and len(block_ids) >= ENGAGE_FLOOR:
            resolved_m, bresident_m = engine.resolved_partition(block_ids)
        for i, txn_id in enumerate(block_ids):
            state = self.blocking.get(txn_id)
            if state is None or state.progress is Progress.INVESTIGATING:
                continue
            if bresident_m is not None and bresident_m[i]:
                if resolved_m[i]:
                    self.blocking.pop(txn_id, None)
                    continue
            else:
                command = self.store.lookup(txn_id)
                if command is not None and self._locally_resolved(command):
                    self.blocking.pop(txn_id, None)
                    continue
            if state.progress is Progress.EXPECTED:
                # freshly blocked: give the normal pipeline one poll cycle
                state.progress = Progress.NO_PROGRESS
                continue
            if state.in_cooldown():
                continue
            if not self._budget_ok():
                state.cooldown = max(state.cooldown, 1)
                continue
            state.progress = Progress.INVESTIGATING
            self._launch_staggered(
                lambda state=state: self._resolve_blocked(state))

        for txn_id in list(self.non_home.keys()):
            state = self.non_home.get(txn_id)
            command = self.store.lookup(txn_id)
            if command is None or command.has_been(Status.PRE_COMMITTED):
                self.non_home.pop(txn_id, None)
                continue
            state.polls += 1
            if state.polls >= 2:
                self._inform_home(state)
                self.non_home.pop(txn_id, None)

    @staticmethod
    def _locally_resolved(command) -> bool:
        """A blocking dep no longer blocks anyone here: applied locally, or will
        never execute."""
        return (command.save_status.ordinal >= SaveStatus.APPLIED.ordinal
                or command.save_status is SaveStatus.INVALIDATED
                or command.save_status.is_truncated)

    def _observe(self, kind: str) -> None:
        obs = getattr(self.node, "observer", None)
        if obs is not None:
            obs.on_progress(kind, self.node.id, self.store.id)

    def _budget_ok(self) -> bool:
        """Retry-budget gate for a monitor launch.  A denial defers the txn to
        the next poll cycle (its monitor state is untouched beyond a one-poll
        cooldown) — the backlog drains at the budgeted rate instead of
        relaunching wholesale every tick."""
        if self._budget is None:
            return True
        if self._budget.try_acquire(self.node.now_micros() / 1e6):
            return True
        counters = getattr(self.node, "overload_counters", None)
        if counters is not None:
            counters["budget_denied"] += 1
        obs = getattr(self.node, "observer", None)
        if obs is not None:
            obs.registry.counter("overload.budget_denied", node=self.node.id,
                                 store=self.store.id).inc()
        return False

    def _investigate(self, state: _CoordinateState) -> None:
        from ..coordinate.maybe_recover import maybe_recover
        self._observe("investigations")

        def on_done(outcome, failure):
            current = self.coordinating.get(state.txn_id)
            if failure is not None:
                if current is not None:
                    current.investigation_failed()
                return
            if outcome.settled:
                self._done(state.txn_id)
            elif current is not None:
                # ballot-only movement is NOT progress: it means competing
                # recovery attempts are preempting each other — back off so
                # one of them eventually runs uncontended to completion
                if outcome.token.advanced_materially_from(current.token):
                    current.investigation_progressed()
                else:
                    current.investigation_failed()
                current.token = outcome.token
                current.progress = Progress.EXPECTED

        maybe_recover(self.node, state.txn_id, state.route, state.token) \
            .add_listener(on_done)

    def _resolve_blocked(self, state: _BlockingState) -> None:
        """One CheckStatus quorum probe (fetch_data, which also propagates any
        knowledge found into our stores); if the blocking txn is undecided
        cluster-wide AND made no progress since the last probe, drive it to a
        decision: recover when the definition reconstitutes, invalidate when it
        cannot (it was never durably witnessed)."""
        from ..coordinate.errors import Invalidated
        from ..coordinate.fetch_data import fetch_data
        from ..coordinate.maybe_recover import ProgressToken
        from ..coordinate.recover import invalidate as do_invalidate, recover as do_recover
        from ..utils import async_ as au
        self._observe("blocked_probes")

        if state.route is None:
            # route unknown (the txn was learned by id only): discover it
            # before anything else — RecoverWithSomeRoute (FindSomeRoute ->
            # RecoverWithRoute, RecoverWithRoute.java:1-242)
            from ..messages.status_messages import find_some_route

            def on_route(route, failure):
                current = self.blocking.get(state.txn_id)
                if current is None:
                    return
                if failure is not None or route is None:
                    # nobody in the cluster knows it yet: back off and retry
                    # (an InformOfTxn may still be in flight)
                    current.investigation_failed()
                    return
                current.route = route
                current.progress = Progress.NO_PROGRESS  # escalate next poll

            find_some_route(self.node, state.txn_id).add_listener(on_route)
            return

        def on_fetched(merged, failure):
            current = self.blocking.get(state.txn_id)
            if current is None:
                return
            if failure is not None:
                current.investigation_failed()
                return
            # fetch_data propagated any knowledge found; resolved iff the dep is
            # now APPLIED (or settled) *locally* — being merely (pre)committed
            # cluster-wide doesn't unblock local execution
            command = self.store.lookup(state.txn_id)
            if command is not None and self._locally_resolved(command):
                self.blocking.pop(state.txn_id, None)
                return
            token = ProgressToken.of(merged) if merged is not None else None
            if token is not None and token.advanced_from(current.token):
                # real (status/durability) advance: reset the backoff; a
                # ballot-only advance stands down (a competing attempt is in
                # flight — preempting it helps nobody) but GROWS the backoff
                if token.advanced_materially_from(current.token):
                    current.investigation_progressed()
                    current.progress = Progress.NO_PROGRESS  # escalate next poll if stalled
                else:
                    current.investigation_failed()
                current.token = token
                return

            # stalled and undecided: settle it
            rec = au.settable()
            txn = merged.full_txn() if merged is not None else None
            if merged is not None and merged.route is not None and merged.route.full:
                full_route = merged.route
            elif txn is not None:
                # reconstituted definition: recover over the txn's REAL
                # footprint — a partial hint would slice recovery to one shard
                # and stall it forever (empty partials at the others)
                full_route = self.node.compute_route(txn)
            else:
                full_route = state.route
            if txn is not None:
                do_recover(self.node, state.txn_id, txn, full_route, rec)
            else:
                do_invalidate(self.node, state.txn_id, full_route, rec)

            def on_settled(_value, rec_failure):
                from ..coordinate.errors import Truncated
                cur = self.blocking.get(state.txn_id)
                if cur is not None:
                    if rec_failure is None or isinstance(rec_failure,
                                                        (Invalidated, Truncated)):
                        self.blocking.pop(state.txn_id, None)
                    else:
                        cur.investigation_failed()
            rec.add_listener(on_settled)

        fetch_data(self.node, state.txn_id, state.route).add_listener(on_fetched)

    def _inform_home(self, state: _NonHomeState) -> None:
        """Send InformOfTxn to the home-shard replicas (InformHomeOfTxn)."""
        from ..messages.status_messages import InformOfTxn
        topology = self.node.topology.topology_for_epoch(state.txn_id.epoch)
        shard = topology.for_key(state.route.home_key)
        if shard is None:
            return
        for to in shard.nodes:
            if to != self.node.id:
                self.node.send(to, InformOfTxn(state.txn_id, state.route,
                                               state.txn_id.epoch))


def _route_for_participants(txn_id: TxnId, waiter_route: Optional[Route],
                            participants) -> Optional[Route]:
    """Best route hint for a blocking txn: its participants from the waiter's
    deps — a SUBSET of its true route, so the hint is a partial route (it must
    never be mistaken for the full footprint by txn reconstitution)."""
    if participants is not None:
        keys, ranges = participants
        if len(keys):
            return Route(keys[0], keys, full=False)
        if len(ranges):
            return Route(ranges[0].start, ranges, full=False)
    return waiter_route


def progress_log_factory(poll_interval_s: float = 0.5):
    """Factory suitable for Node(progress_log_factory=...)."""
    def make(store: "CommandStore") -> SimpleProgressLog:
        return SimpleProgressLog(store, poll_interval_s)
    return make
