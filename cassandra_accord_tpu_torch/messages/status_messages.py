"""Status interrogation and knowledge propagation.

Capability parity with ``accord.messages.CheckStatus`` / ``Propagate``
(CheckStatus.java:21-933, Propagate.java:1-546): ``CheckStatus`` reports everything a
replica knows about a txn — save status, ballots, executeAt, durability, route, and
(with ``include_info``) the partial txn/deps/writes/result — and the caller merges
replies field-wise into a single knowledge view.  ``propagate_knowledge`` applies a
merged view to the local stores, upgrading the local ``Known`` (the reference's
local-only Propagate message family).

Also: the hint messages ``InformOfTxn`` (tell the home shard an unwitnessed txn
exists, InformOfTxnId.java) and ``InformDurable`` (durability notice, InformDurable.java).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..local import commands as C
from ..local.command_store import SafeCommandStore
from ..local.status import Durability, SaveStatus, Status
from ..primitives.deps import Deps
from ..primitives.route import Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from ..primitives.txn import PartialTxn, Txn, Writes
from .base import Callback, MessageType, Reply, Request, TxnRequest

if TYPE_CHECKING:
    from ..local.node import Node


class CheckStatusOk(Reply):
    """One replica's (or a merge of several replicas') knowledge of a txn."""

    __slots__ = ("txn_id", "save_status", "promised", "accepted", "execute_at",
                 "durability", "route", "partial_txn", "partial_deps", "writes",
                 "result", "stable_for", "applied_for", "invalid_if_undecided")

    def __init__(self, txn_id: TxnId, save_status: SaveStatus, promised: Ballot,
                 accepted: Ballot, execute_at: Optional[Timestamp],
                 durability: Durability, route: Optional[Route],
                 partial_txn: Optional[PartialTxn], partial_deps: Optional[Deps],
                 writes: Optional[Writes], result,
                 stable_for=None, applied_for=None,
                 invalid_if_undecided: bool = False):
        from ..primitives.keys import Ranges
        self.txn_id = txn_id
        self.save_status = save_status
        self.promised = promised
        self.accepted = accepted
        self.execute_at = execute_at
        self.durability = durability
        self.route = route
        self.partial_txn = partial_txn
        self.partial_deps = partial_deps
        self.writes = writes
        self.result = result
        # coverage of this knowledge (the reference's FoundKnownMap / Known
        # sufficiency, CheckStatus.java): the ranges for which the carried deps
        # (>= STABLE) and writes (>= PRE_APPLIED) slices are known-complete
        self.stable_for = stable_for if stable_for is not None else Ranges.EMPTY
        self.applied_for = applied_for if applied_for is not None else Ranges.EMPTY
        # Infer hint (Infer.InvalidIfNot.IfUndecided, Infer.java:63-186): this
        # replica's majority-durability watermark passed txnId on its queried
        # ranges, so every lower txn is either durably applied or invalidated —
        # if a quorum says so and the txn is still undecided, it provably never
        # committed and can never commit (preaccept below the fence refuses)
        self.invalid_if_undecided = invalid_if_undecided

    @property
    def type(self):
        return MessageType.CHECK_STATUS_RSP

    @staticmethod
    def of(txn_id: TxnId, command, local_ranges=None) -> "CheckStatusOk":
        """``local_ranges`` must be the ranges this store's PAYLOAD slices
        actually cover — the ranges it owned at the txn's coordination epochs
        (``payload_coverage``), NOT its current ranges.  A store that adopted
        a range AFTER the txn's epochs holds deps/writes slices that never
        included it; claiming current ranges let a peer adopt a partial
        writes payload as if it covered the newly-adopted range and silently
        drop the missing key's write (seed-6 elastic trajectory: node 5's
        epoch-8 [k857]-only slice adopted at node 3 as covering k285 —
        replica divergence, v80.0 lost)."""
        from ..primitives.keys import Ranges
        local = local_ranges if local_ranges is not None else Ranges.EMPTY
        invalidated = command.save_status is SaveStatus.INVALIDATED
        stable_for = local if command.save_status.has_been(Status.STABLE) \
            and not command.save_status.is_truncated and not invalidated \
            else Ranges.EMPTY
        # applied_for asserts "the CARRIED writes cover these ranges" — it is
        # what gates outcome adoption at peers, so it must track the writes
        # payload: TRUNCATE_WITH_OUTCOME keeps its writes and still serves the
        # outcome; plain TRUNCATE/ERASE (writes dropped) claims nothing
        applied_for = local if command.writes is not None and not invalidated \
            and command.save_status.has_been(Status.PRE_APPLIED) else Ranges.EMPTY
        return CheckStatusOk(txn_id, command.save_status, command.promised,
                             command.accepted_or_committed, command.execute_at,
                             command.durability, command.route, command.partial_txn,
                             command.partial_deps, command.writes, command.result,
                             stable_for=stable_for, applied_for=applied_for)

    @staticmethod
    def payload_coverage(safe_store, txn_id: TxnId, command):
        """The ranges this store's txn/deps/writes slices can actually cover:
        the union of the ranges it owned over the txn's coordination window
        [txnId.epoch, executeAt.epoch] — what ``compute_scope`` sliced the
        payloads to when they were sent here.  Ranges adopted in LATER epochs
        are excluded: no payload for them ever arrived."""
        from ..primitives.keys import Ranges
        lo = txn_id.epoch
        hi = lo
        if command is not None and command.execute_at is not None:
            hi = max(hi, command.execute_at.epoch)
        covered = Ranges.EMPTY
        for e in range(lo, hi + 1):
            covered = covered.union(safe_store.ranges_at(e))
        return covered

    @staticmethod
    def infer_invalid_hint(safe_store, txn_id: TxnId, command) -> bool:
        """IfUndecided inference grounds (Infer.withInvalidIfNot,
        Infer.java:327-378): the store's majority-durability watermark covers
        txnId on every locally-owned participant — meaningless (False) once the
        command is decided locally."""
        from ..local.status import Status as S
        if command is not None and command.has_been(S.PRE_COMMITTED):
            return False
        local = safe_store.current_ranges()
        if not len(local):
            return False
        # an ABSENT command is ambiguous once the erase bound passed txnId:
        # GC physically deletes shard-redundant APPLIED commands
        # (command_store.run_gc), so a durably-applied txn would look exactly
        # like a never-committed one here — no hint below that bound.  (A
        # replica that erased it cannot claim the hint; one that still holds
        # it reports the applied status, which suppresses the inference.)
        bound = safe_store.redundant_before().min_shard_redundant_before(local)
        if bound is not None and txn_id < bound:
            return False
        from ..local.status import Durability as D
        return safe_store.durable_before().min_durability(
            txn_id, local) >= D.MAJORITY

    @staticmethod
    def empty(txn_id: TxnId) -> "CheckStatusOk":
        return CheckStatusOk(txn_id, SaveStatus.NOT_DEFINED, Ballot.ZERO, Ballot.ZERO,
                             None, Durability.NOT_DURABLE, None, None, None, None, None)

    def merge(self, other: "CheckStatusOk") -> "CheckStatusOk":
        """Field-wise knowledge merge (CheckStatus.CheckStatusOk.merge): the
        higher save status's decision fields win; routes union; txn/deps merge."""
        a, b = self, other
        if b.save_status.ordinal > a.save_status.ordinal:
            a, b = b, a
        route = a.route
        if route is None:
            route = b.route
        elif b.route is not None and b.route.home_key == route.home_key:
            route = route.union(b.route)
        partial_txn = a.partial_txn
        if partial_txn is None:
            partial_txn = b.partial_txn
        elif b.partial_txn is not None:
            partial_txn = partial_txn.with_merged(b.partial_txn)
        partial_deps = a.partial_deps
        if partial_deps is None:
            partial_deps = b.partial_deps
        elif b.partial_deps is not None and \
                ((a.save_status.has_been(Status.STABLE)
                  and b.save_status.has_been(Status.STABLE))
                 or a.save_status.ordinal == b.save_status.ordinal):
            # same knowledge tier (or both stable): deps slices from different
            # shards of the same decision merge
            partial_deps = partial_deps.with_merged(b.partial_deps)
        writes = a.writes
        if writes is None:
            writes = b.writes
        elif b.writes is not None:
            writes = writes.merge(b.writes)
        return CheckStatusOk(
            a.txn_id, a.save_status, a.promised.merge_max(b.promised),
            a.accepted.merge_max(b.accepted),
            a.execute_at if a.execute_at is not None else b.execute_at,
            max(a.durability, b.durability), route, partial_txn, partial_deps,
            writes,
            a.result if a.result is not None else b.result,
            stable_for=a.stable_for.union(b.stable_for),
            applied_for=a.applied_for.union(b.applied_for),
            # AND: the inference claim must hold at every contributor
            # (Infer.InvalidIfNot.reduce takes the weaker side)
            invalid_if_undecided=a.invalid_if_undecided and b.invalid_if_undecided)

    def full_txn(self) -> Optional[Txn]:
        """Reconstitute the complete txn if the merged partials cover the route."""
        if self.partial_txn is None or self.route is None:
            return None
        return self.partial_txn.reconstitute_or_none(self.route)

    def __repr__(self):
        return f"CheckStatusOk({self.txn_id!r}, {self.save_status.name}, dur={self.durability.name})"


class CheckStatus(TxnRequest):
    """Interrogate replicas' knowledge of ``txn_id`` (CheckStatus.java).  With
    ``include_info`` the reply carries the txn/deps/outcome payloads (the
    reference's IncludeInfo.All)."""

    __slots__ = ("include_info",)

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int,
                 include_info: bool = True):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.include_info = include_info

    @property
    def type(self):
        return MessageType.CHECK_STATUS_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id, include_info = self.txn_id, self.include_info

        def map_fn(safe_store: SafeCommandStore):
            command = safe_store.get_if_exists(txn_id)
            hint = CheckStatusOk.infer_invalid_hint(safe_store, txn_id, command)
            if command is None:
                ok = CheckStatusOk.empty(txn_id)
                ok.invalid_if_undecided = hint
                return ok
            ok = CheckStatusOk.of(
                txn_id, command,
                CheckStatusOk.payload_coverage(safe_store, txn_id, command))
            ok.invalid_if_undecided = hint
            if not include_info:
                from ..primitives.keys import Ranges
                ok.partial_txn = None
                ok.partial_deps = None
                ok.writes = None
                ok.result = None
                # coverage claims travel WITH the payloads they describe
                ok.stable_for = Ranges.EMPTY
                ok.applied_for = Ranges.EMPTY
            return ok

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node, reply_context, failure)
            else:
                node.reply(from_node, reply_context,
                           result if result is not None else CheckStatusOk.empty(txn_id))

        node.map_reduce_consume_local(self.scope, txn_id.epoch, txn_id.epoch,
                                      map_fn, lambda a, b: a.merge(b),
                                      preload=self.preload_ids()).begin(consume)

    def __repr__(self):
        return f"CheckStatus({self.txn_id!r})"


# ---------------------------------------------------------------------------
# local knowledge propagation (Propagate.java)
# ---------------------------------------------------------------------------

def propagate_knowledge(node: "Node", txn_id: TxnId, merged: CheckStatusOk):
    """Apply a merged knowledge view to the local stores, upgrading the local
    Known lattice: outcome -> apply; stable deps -> commit(STABLE); agreed
    executeAt -> precommit; definition -> preaccept; invalidation propagates.

    Returns the AsyncResult of the per-store application chain — with delayed
    stores the application defers, and callers (fetch_data) must not settle
    success over un-applied knowledge."""
    from ..utils import async_ as au
    route = merged.route
    if route is None:
        return au.success_result(None)
    # span through the node's CURRENT epoch, not just the execution epoch: a
    # store that adopted the footprint AFTER the txn's era (elastic joins,
    # churn re-adoptions) holds waiters on this txn but owns nothing at the
    # txn's own epochs — propagation targeted at [txn, exec] never visits
    # it and its waiters starve on knowledge every peer already has (the
    # seed-6 restart-matrix k428 hole).  Per-store slicing gates below keep
    # the application sound.
    max_epoch = merged.execute_at.epoch if merged.execute_at is not None else txn_id.epoch
    max_epoch = max(max_epoch, node.topology.current_epoch)

    def for_store(safe_store: SafeCommandStore) -> None:
        existing = safe_store.get_if_exists(txn_id)
        if (existing is None or not existing.listeners) \
                and C._is_shard_redundant(safe_store, txn_id, route):
            # GC physically erased this txn below the shard fence: late
            # knowledge propagation — including truncated-outcome adoption
            # onto a freshly-created stub — must not resurrect it (ballot
            # regression; the round-4 resurrection class).  EXCEPT when a
            # local waiter still lists it as a dependency (listeners): then
            # propagation is the HEAL that unblocks the waiter and lands
            # the write this lagging replica never applied — fending that
            # off wedged whole PRE_APPLIED chains behind one unwitnessed
            # dep (the seed-6 restart-matrix k428 hole).
            return
        status = merged.save_status
        if status is SaveStatus.INVALIDATED:
            C.commit_invalidate(safe_store, txn_id, scope=route)
            return
        if status.is_truncated:
            local_parts_t = route.participants().slice(safe_store.current_ranges())
            # the cluster truncated this txn after it applied; a lagging local
            # waiter would otherwise block forever (recovery nacks Truncated).
            # If the merged view still CARRIES the outcome
            # (TRUNCATE_WITH_OUTCOME), adopt it directly: writes land (the data
            # store is timestamp-ordered and idempotent) and the command becomes
            # a truncated tombstone (Propagate.java truncated handling / Infer)
            command = safe_store.get_if_exists(txn_id)
            if command is None or command.save_status.has_been(Status.PRE_APPLIED):
                return
            writes_free = not txn_id.is_write   # sync points / reads: applying
            if merged.execute_at is None:       # is a no-op
                # truncated with NO recoverable outcome (an ERASED tombstone —
                # e.g. every consulted peer quarantined the txn's corrupt
                # journal records): the cluster applied this write, this
                # replica never did, and the individual Apply will never
                # arrive.  The only remedy is the peer-snapshot heal (data
                # stores are timestamp-ordered and idempotent; at least one
                # replica past the durable fence holds the full set).
                # Returning silently left a permanent one-replica data hole
                # once GC erased the local stub below the shard watermark.
                if txn_id.is_write and len(local_parts_t):
                    _heal_store_gaps(node, safe_store, local_parts_t)
                return
            if writes_free or (merged.writes is not None
                               and merged.applied_for.contains_all(local_parts_t)):
                was_waiting = command.waiting_on is not None \
                    and command.waiting_on.is_waiting()
                never_initialised = command.waiting_on is None \
                    and not command.save_status.has_been(Status.STABLE)
                C.adopt_truncated_outcome(safe_store, command, route,
                                          merged.execute_at,
                                          None if writes_free else merged.writes,
                                          merged.result)
                if was_waiting or never_initialised:
                    # this replica adopted an outcome WITHOUT having applied
                    # the txn's (truncated-away) predecessors: their writes
                    # will never arrive individually — heal the data gap with
                    # a peer snapshot of the affected keys (timestamp-sorted,
                    # idempotent append: the union subsumes every missing
                    # predecessor; the hostile 1000-op burn caught replicas
                    # diverging with holes exactly here)
                    _heal_store_gaps(node, safe_store, local_parts_t)
            elif txn_id.is_write and len(local_parts_t):
                # truncated upstream with the WRITES STRIPPED (plain
                # TRUNCATE tier — executeAt still known): this replica can
                # neither adopt the outcome nor ever receive the individual
                # Apply — the same one-replica hole round 7 closed for the
                # executeAt-unknown case, found again on the seed-6 restart
                # trajectory (node 1's k428 epoch-9 cohort).  Heal the gap
                # from peer snapshots and collapse the local copy to an
                # ERASED tombstone so waiters stop waiting on an apply that
                # cannot happen (reads stay refused by the stale mark until
                # the heal lands).
                from ..local.durability import Cleanup
                if not command.has_been(Status.PRE_COMMITTED):
                    # pre-committed copies heal inside C.truncate's own
                    # data-gap guard; bare stubs need it launched here
                    _heal_store_gaps(node, safe_store, local_parts_t)
                C.truncate(safe_store, command, Cleanup.ERASE)
            return
        # gate each tier on the merged knowledge actually covering THIS store's
        # slice of the route (the reference's Known.sufficientFor per-store gate,
        # Propagate.java): deps/writes slices fetched from a subset of shards
        # must not be applied to stores they don't cover.
        local_parts = route.participants().slice(safe_store.current_ranges())
        if status.has_been(Status.PRE_APPLIED) and merged.writes is not None \
                and merged.partial_deps is not None and merged.partial_txn is not None \
                and merged.applied_for.contains_all(local_parts):
            C.apply_(safe_store, txn_id, route, merged.execute_at, merged.partial_deps,
                     merged.partial_txn, merged.writes, merged.result)
            return
        if status.has_been(Status.STABLE) and merged.partial_deps is not None \
                and merged.partial_txn is not None \
                and merged.stable_for.contains_all(local_parts):
            C.commit(safe_store, txn_id, SaveStatus.STABLE, merged.promised, route,
                     merged.partial_txn, merged.execute_at, merged.partial_deps)
            return
        if status.has_been(Status.PRE_COMMITTED) and merged.execute_at is not None:
            C.precommit(safe_store, txn_id, merged.execute_at)
            return
        if status.has_been(Status.PRE_ACCEPTED) and merged.partial_txn is not None:
            C.preaccept(safe_store, txn_id, merged.partial_txn, route)

    return node.for_each_local(route, txn_id.epoch, max_epoch, for_store,
                               preload=(txn_id,))


def _heal_store_gaps(node: "Node", safe_store: SafeCommandStore,
                     participants) -> None:
    """Snapshot-fetch ``participants``' data from peer replicas and merge
    (idempotent, timestamp-ordered).  Sources may themselves lag — merging
    every reply is safe, and at least one replica past the durable fence
    (the one whose truncated evidence triggered this) holds the full set."""
    from ..primitives.keys import Ranges as _Rs
    from .fetch_messages import FetchStoreData, FetchStoreDataOk
    rngs = participants if isinstance(participants, _Rs) \
        else participants.to_ranges()
    if not len(rngs):
        return
    store = node.data_store

    def current_plan(open_rngs):
        """PER-SHARD fetch plan against the CURRENT topology: the stale mark
        may only clear when EVERY shard slice of the footprint was healed by
        replicas of THAT shard (an Ok from a different shard's peer says
        nothing about this slice).  Recomputed each retry round — replicas
        replaced under topology churn must not leave the heal retrying a
        stale peer list forever.  Each entry carries the union-heal bound:
        enough responders (self included) that any apply quorum intersects
        them."""
        topology = node.config_service.current_topology()
        plan = []
        for shard in topology.shards:
            sub = open_rngs.intersection(_Rs.of(shard.range))
            if len(sub):
                peers = sorted(n for n in shard.nodes if n != node.id)
                if peers:
                    # UNION-HEAL soundness: every write below the durable
                    # fence applied at a slow-path quorum q of n; any
                    # responder set of size >= n - q + 1 intersects every
                    # such quorum, so the union of responders' snapshots
                    # (self included — its data is already local) contains
                    # every fenced write.  Stale/partial sources count:
                    # their entries are committed writes, merge-safe.
                    # Floor at one PEER response so a gapped replica never
                    # self-certifies.
                    need_peers = max(1, len(shard.nodes)
                                     - shard.slow_path_quorum_size + 1
                                     - 1)   # minus self
                    plan.append((sub, peers, min(need_peers, len(peers))))
        return plan

    if not current_plan(rngs):
        return   # no peer can heal (lone replica): marking stale would
                 # permanently refuse reads with nothing to redirect to
    token = store.mark_stale(rngs)   # reads redirect until the gap heals
    state = {"open": rngs, "rounds": 0}
    command_store = safe_store.store

    def escalate() -> None:
        """Bootstrap-grade catch-up (Bootstrap.java:83-494 re-run for stale
        ranges / RedundantBefore.staleUntilAtLeast): after the paced
        peer-snapshot heal has failed several rounds (sustained partition,
        vanished peers), stop pacing and re-enter the full bootstrap ladder —
        coordinate a fresh exclusive sync point over the open footprint,
        stream the data (complete up to that NEW fence, so writes committed
        DURING the outage are covered too), and advance bootstrapped_at.  The
        ladder retries with its own backoff until peers return; the stale
        mark clears only on completion.

        The LAUNCH itself is paced by the store's unapplied pressure
        (refence_backoff): a catch-up bootstrap re-fences the footprint with
        a fresh exclusive sync point, and firing it while decided txns sit
        unapplied (the seed-6 slo.unapplied condition) re-fences faster
        than the wedged reads can assemble coverage — the exact cadence the
        truncation/staleness ladder must back off."""
        from ..local.bootstrap import Bootstrap, refence_backoff

        def on_done(_v, failure) -> None:
            if failure is None:
                store.clear_stale(token)

        def launch() -> None:
            Bootstrap(node, command_store, state["open"], node.epoch(),
                      catch_up=True).start().add_listener(on_done)

        delay = refence_backoff(node, command_store, 0.0)
        if delay > 0.0:
            node.scheduler.once(delay, launch)
        else:
            launch()

    def attempt(delay: float) -> None:
        """One heal round over the still-open footprint; unhealed remainder
        retries with capped backoff — partitions re-roll and churn replaces
        replicas, so availability returns without re-exposing the hole.
        After several failed rounds the heal escalates to the bootstrap
        fetch ladder (see ``escalate``)."""
        state["rounds"] += 1
        if state["rounds"] > 5:
            escalate()
            return
        next_delay = min(delay * 2, 16.0)
        plan = current_plan(state["open"])
        if not plan:
            node.scheduler.once(delay, lambda: attempt(next_delay))
            return
        round_ = {"pending": len(plan)}

        def slice_done(sub, healed: bool) -> None:
            if healed:
                state["open"] = state["open"].without(sub)
            round_["pending"] -= 1
            if round_["pending"] == 0:
                if not len(state["open"]):
                    store.clear_stale(token)
                else:
                    node.scheduler.once(delay, lambda: attempt(next_delay))

        def slice_attempt(sub, peers, need: int) -> None:
            st = {"pending": len(peers), "got": 0}

            class HealCallback(Callback):
                def on_success(self, from_node: int, reply) -> None:
                    st["pending"] -= 1
                    if isinstance(reply, FetchStoreDataOk):
                        # a NON-partial snapshot (source past the fence with
                        # no gaps of its own) is authoritative alone; partial
                        # (gapped-source) snapshots count toward the
                        # quorum-intersection bound
                        st["got"] += need if not reply.partial else 1
                        for key, entries in reply.entries.items():
                            for ts, value in entries:
                                store.append(key, ts, value)
                    if st["pending"] == 0:
                        slice_done(sub, st["got"] >= need)

                def on_failure(self, from_node: int, failure: BaseException) -> None:
                    st["pending"] -= 1
                    if st["pending"] == 0:
                        slice_done(sub, st["got"] >= need)

            callback = HealCallback()
            for to in peers:
                node.send(to, FetchStoreData(sub, allow_stale=True), callback)

        for sub, peers, need in plan:
            slice_attempt(sub, peers, need)

    attempt(2.0)


# ---------------------------------------------------------------------------
# hint messages
# ---------------------------------------------------------------------------

class InformOfTxn(TxnRequest):
    """Tell the home shard a txn exists so its progress log starts monitoring it
    (InformOfTxnId.java)."""

    __slots__ = ()

    @property
    def type(self):
        return MessageType.INFORM_OF_TXN_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id, scope = self.txn_id, self.scope

        def for_store(safe_store: SafeCommandStore) -> None:
            command = safe_store.get_or_create(txn_id)
            if command.route is None:
                command.route = scope
            # only the store owning the home key takes on coordination-progress
            # monitoring (the reference's progress-shard discipline)
            progress_shard = safe_store.current_ranges().contains(scope.home_key)
            safe_store.progress_log().unwitnessed(txn_id, scope.home_key, progress_shard)

        node.for_each_local(scope, txn_id.epoch, txn_id.epoch, for_store,
                            preload=(txn_id,))

    def __repr__(self):
        return f"InformOfTxn({self.txn_id!r})"


class FindRoute(Request):
    """Route discovery for a txn known only by id (FindRoute.java /
    FindSomeRoute.java capability): ask a node whether ANY of its stores
    witnessed the txn, and reply with the route (and how much it knows).
    Unlike every Txn request this is NOT scope-sliced — the asker has no
    route to slice by; the whole point is to learn one."""

    __slots__ = ("txn_id",)

    def __init__(self, txn_id: TxnId):
        self.txn_id = txn_id

    @property
    def type(self):
        return MessageType.FIND_ROUTE_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        from ..utils import async_ as au
        txn_id = self.txn_id

        def map_fn(safe_store: SafeCommandStore):
            cmd = safe_store.get_if_exists(txn_id)
            if cmd is not None and cmd.route is not None:
                return (cmd.route, cmd.save_status.ordinal)
            return None

        def reduce(a, b):
            if a is None:
                return b
            if b is None:
                return a
            route = a[0] if _route_wider(a[0], b[0]) else b[0]
            return (route, max(a[1], b[1]))

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_node, reply_context, failure)
                return
            route, ordinal = result if result is not None else (None, 0)
            node.reply(from_node, reply_context,
                       FindRouteOk(txn_id, route, ordinal))

        chains = [s.submit(map_fn) for s in node.command_stores.all_stores()]

        def reduce_all(results):
            acc = None
            for r in results:
                acc = reduce(acc, r)
            return acc

        au.all_of(chains).map(reduce_all).begin(consume)

    def __repr__(self):
        return f"FindRoute({self.txn_id!r})"


def _route_wider(a: Route, b: Route) -> bool:
    """Prefer full routes, then more participants."""
    if a.full != b.full:
        return a.full
    return len(a.participants()) >= len(b.participants())


class FindRouteOk(Reply):
    __slots__ = ("txn_id", "route", "status_ordinal")

    def __init__(self, txn_id: TxnId, route: Optional[Route], status_ordinal: int):
        self.txn_id = txn_id
        self.route = route
        self.status_ordinal = status_ordinal

    @property
    def type(self):
        return MessageType.FIND_ROUTE_RSP

    def __repr__(self):
        return f"FindRouteOk({self.txn_id!r}, {self.route!r})"


def find_some_route(node: "Node", txn_id: TxnId) -> "au.AsyncResult":
    """Ask EVERY node in the current topology for the txn's route
    (FindSomeRoute semantics: any replica that witnessed it suffices).
    Resolves with the widest Route found, or None if nobody knows."""
    from ..utils import async_ as au
    result = au.settable()
    targets = sorted(node.config_service.current_topology().nodes())
    state = {"pending": len(targets), "route": None}

    class RouteCallback(Callback):
        def on_success(self, from_node: int, reply) -> None:
            if isinstance(reply, FindRouteOk) and reply.route is not None:
                if state["route"] is None \
                        or _route_wider(reply.route, state["route"]):
                    state["route"] = reply.route
            self._one()

        def on_failure(self, from_node: int, failure: BaseException) -> None:
            self._one()

        def _one(self) -> None:
            state["pending"] -= 1
            if state["pending"] == 0 and not result.is_done():
                result.set_success(state["route"])

    callback = RouteCallback()
    for to in targets:
        node.send(to, FindRoute(txn_id), callback)
    if not targets:
        result.set_success(None)
    return result


class InformDurable(TxnRequest):
    """Durability notice (InformDurable.java): mark the txn durable at the
    given level so progress logs stand down."""

    __slots__ = ("execute_at", "durability")

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int,
                 execute_at: Optional[Timestamp], durability: Durability):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.execute_at = execute_at
        self.durability = durability

    @property
    def type(self):
        return MessageType.INFORM_DURABLE_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id, scope, execute_at, durability = \
            self.txn_id, self.scope, self.execute_at, self.durability

        def for_store(safe_store: SafeCommandStore) -> None:
            C.set_durability(safe_store, txn_id, durability, scope, execute_at)

        node.for_each_local(scope, txn_id.epoch, txn_id.epoch, for_store,
                            preload=(txn_id,))

    def __repr__(self):
        return f"InformDurable({self.txn_id!r}, {self.durability.name})"


class InformHomeDurable(TxnRequest):
    """Durability notice to the HOME shard specifically
    (InformHomeDurable.java): the home shard owns global progress
    responsibility for the txn (MaybeRecover/home-shard progress state), so
    it learns durably-applied status even when it holds no data for the txn —
    standing its progress machinery down."""

    __slots__ = ("execute_at", "durability")

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int,
                 execute_at: Optional[Timestamp], durability: Durability):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.execute_at = execute_at
        self.durability = durability

    @property
    def type(self):
        return MessageType.INFORM_HOME_DURABLE_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id, scope, execute_at, durability = \
            self.txn_id, self.scope, self.execute_at, self.durability

        def for_store(safe_store: SafeCommandStore) -> None:
            # durability mark only: the progress log consults durability on
            # its own cadence.  An EXPLICIT stand-down here would kill local
            # progress driving on a home replica that has not itself applied
            # yet (quorum-durable elsewhere ≠ locally complete) — that
            # variant stalled hostile burns to the probe cap.
            C.set_durability(safe_store, txn_id, durability, scope, execute_at)

        node.for_each_local(scope, txn_id.epoch, txn_id.epoch, for_store,
                            preload=(txn_id,))

    def __repr__(self):
        return f"InformHomeDurable({self.txn_id!r}, {self.durability.name})"


class Propagate(Request):
    """Knowledge propagation as a FIRST-CLASS local request
    (Propagate.java:1-546): the merged CheckStatusOk a fetch produced, applied
    to the local stores by self-delivery through the normal receive path — so
    it is serializable, shows up in message traces with its own PROPAGATE_*
    type, and is replayable like any other request."""

    __slots__ = ("txn_id", "merged")

    MESSAGE_TYPES = (MessageType.PROPAGATE_PRE_ACCEPT_MSG,
                     MessageType.PROPAGATE_STABLE_MSG,
                     MessageType.PROPAGATE_APPLY_MSG,
                     MessageType.PROPAGATE_OTHER_MSG)

    def __init__(self, txn_id: TxnId, merged: CheckStatusOk):
        self.txn_id = txn_id
        self.merged = merged

    @property
    def type(self):
        ss = self.merged.save_status
        if ss.ordinal >= SaveStatus.PRE_APPLIED.ordinal and not ss.is_truncated:
            return MessageType.PROPAGATE_APPLY_MSG
        if ss.has_been(Status.STABLE) and not ss.is_truncated:
            return MessageType.PROPAGATE_STABLE_MSG
        if ss.has_been(Status.PRE_ACCEPTED):
            return MessageType.PROPAGATE_PRE_ACCEPT_MSG
        return MessageType.PROPAGATE_OTHER_MSG

    def process(self, node: "Node", from_node: int, reply_context):
        """Returns the propagation AsyncResult so a direct caller (fetch_data)
        can settle on actual application; the normal receive path ignores it."""
        return propagate_knowledge(node, self.txn_id, self.merged)

    def __repr__(self):
        return f"Propagate({self.txn_id!r}, {self.merged.save_status.name})"
