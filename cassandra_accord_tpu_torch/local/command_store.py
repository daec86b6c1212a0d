"""Command stores: single-logical-thread metadata shards and their manager.

Capability parity with ``accord.local.CommandStore/CommandStores/SafeCommandStore``
(CommandStore.java:1-788, CommandStores.java:79-737, SafeCommandStore.java:58-385):
each store owns a set of key ranges per epoch, all per-txn ``Command`` state and
per-key ``CommandsForKey`` indexes for those ranges, and executes every operation on
its own executor (one logical thread).  ``SafeCommandStore`` is the transactional view
handed to in-store operations, exposing the dependency-calculation queries
(``map_reduce_active``) and listener plumbing.  ``CommandStores`` routes operations to
the stores whose ranges intersect the operation's keys (``map_reduce_consume``
semantics) and swaps range assignments on topology change.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Set, Tuple

from ..api.interfaces import Agent, DataStore, ProgressLog
from ..primitives.deps import Deps
from ..protocol_batch.columns import ENGAGE_FLOOR
from ..primitives.keys import Range, Ranges, RoutingKey
from ..primitives.route import Route
from ..primitives.timestamp import Timestamp, TxnId, TxnKind
from ..utils import async_ as au
from ..utils.invariants import Invariants, check_state
from .cfk import CommandsForKey, InternalStatus, manages, manages_execution
from .command import Command
from .status import SaveStatus, Status

if TYPE_CHECKING:
    from .node import Node


class AgentExecutor:
    """Executor + agent pair (local/AgentExecutor.java). The default executes
    inline; the simulation harness substitutes a deterministic task queue."""

    def __init__(self, agent: Agent):
        self.agent = agent

    def execute(self, task: Callable[[], None]) -> None:
        try:
            task()
        except BaseException as e:  # noqa: BLE001
            self.agent.on_uncaught_exception(e)

    def submit(self, task: Callable[[], object]) -> au.AsyncChain:
        return au.of_callable(task, executor=self)


def command_footprint(cmd):
    """A command's key footprint: its partial txn's keys, else its route
    participants (may be Keys-like or Ranges).  Single definition shared by
    the live evidence scan and CommandSummary so the two can never drift."""
    if cmd.partial_txn is not None:
        return cmd.partial_txn.keys
    if cmd.route is not None:
        return cmd.route.participants()
    return None


class _SummaryDeps:
    """Minimal partial_deps stand-in for CommandSummary (contains only)."""
    __slots__ = ("ids",)

    def __init__(self, ids: frozenset):
        self.ids = ids

    def contains(self, txn_id) -> bool:
        return txn_id in self.ids


class CommandSummary:
    """Evidence-grade snapshot of a TERMINAL evicted command
    (impl/CommandsSummary.java): everything recovery_evidence reads —
    status lattice position, executeAt, deps membership, footprint — without
    a journal decode.  Terminal commands never change while cold, so the
    snapshot taken at evict time stays exact until fault-in discards it."""
    __slots__ = ("txn_id", "status", "save_status", "execute_at",
                 "partial_deps", "footprint", "applied_locally",
                 "elided_unapplied", "written_keys", "full_footprint")

    def __init__(self, cmd) -> None:
        self.txn_id = cmd.txn_id
        self.status = cmd.status
        self.save_status = cmd.save_status
        self.execute_at = cmd.execute_at
        self.partial_deps = None if cmd.partial_deps is None \
            else _SummaryDeps(frozenset(cmd.partial_deps.txn_ids()))
        self.footprint = command_footprint(cmd)
        # the grandfathered-serve plane reads these off evicted commands:
        # whether the dependency-ordered apply ran here, which write deps
        # were dropped without a local-apply proof (still unresolved at
        # evict time — terminal commands never resolve them later), and the
        # routing keys the local writes slice actually covered (evaluated
        # against all_ranges at QUERY time — ownership can grow after the
        # evict, so a cached verdict would over-claim)
        self.applied_locally = cmd.applied_locally
        self.elided_unapplied = frozenset(cmd.elided_unapplied) \
            if cmd.elided_unapplied else None
        self.written_keys = None if cmd.writes is None else frozenset(
            k.to_routing() if hasattr(k, "to_routing") else k
            for k in cmd.writes.keys)
        # full footprint for the writes-cover check (route travels whole;
        # the partial_txn is sliced and would certify slices never held)
        from ..local.commands import _dep_full_footprint
        self.full_footprint = _dep_full_footprint(cmd)


class CommandStore:
    """One metadata shard of one node."""

    _current: Optional["CommandStore"] = None   # logical-thread discipline check

    def __init__(self, store_id: int, node: "Node", executor: AgentExecutor):
        self.id = store_id
        self.node = node
        self.executor = executor
        # epoch -> Ranges this store covers (RangesForEpoch)
        self.ranges_by_epoch: Dict[int, Ranges] = {}
        self._all_ranges_cache: Optional[Ranges] = None
        self.commands: Dict[TxnId, Command] = {}
        self.cfks: Dict[RoutingKey, CommandsForKey] = {}
        # witnessed range-domain txns: TxnId -> (Ranges, status) for range deps calc
        # (InMemoryCommandStore.rangeCommands equivalent)
        self.range_txns: Dict[TxnId, Tuple[Ranges, InternalStatus]] = {}
        # transient listeners: txn_id -> callbacks fired on every status change
        self.transient_listeners: Dict[TxnId, List[Callable]] = {}
        self.progress_log: ProgressLog = ProgressLog.NOOP
        # GC bounds + durability watermarks + per-range max executeAt
        from .durability import DurableBefore, MaxConflicts, RedundantBefore
        self.redundant_before: RedundantBefore = RedundantBefore.EMPTY
        self.durable_before: DurableBefore = DurableBefore.EMPTY
        # MaxConflicts (MaxConflicts.java:32): per-range max executeAt of
        # RANGE-domain txns; key-domain maxima come precisely from each cfk
        self.max_conflicts: MaxConflicts = MaxConflicts()
        # ranges adopted but not yet bootstrapped: reads refused, writes apply
        self.pending_bootstrap: Ranges = Ranges.EMPTY
        # optional persistence hook (harness Journal; simulated durability)
        self.journal = None
        # bumped on every durability-watermark advance: the resolvers'
        # elision gates re-evaluate lazily against it
        self.durable_gen = 0
        # cache-miss plane (PreLoadContext.java / DelayedCommandStores
        # cache-miss injection): ids whose command state was EVICTED from
        # memory and lives only in the journal; faulted back in on access
        self.cold: set = set()
        # evidence-grade snapshots of evicted TERMINAL commands (the
        # reference's CommandsSummary): recovery evidence scans answer from
        # these instead of faulting the whole cold set through the journal
        # codec on every BeginRecovery (the seed-6 wall-clock storm: 125k+
        # fault-ins from repeated evidence scans at quiesce)
        self.cold_summaries: Dict[TxnId, "CommandSummary"] = {}
        # cold-GC memo: cold id -> the (redundant, majority, universal, shard)
        # max bounds it was last evaluated under; re-fault only on advance
        self.cold_gc_seen: dict = {}
        self.cache_miss_loads = 0
        # async pending-load plane: count of declared-cold ids loaded via the
        # PreLoadContext path (vs synchronous undeclared fault-ins)
        self.pending_loads = 0
        # diagnostic: local apply-order inversions recorded by the per-key
        # timestamp registers (legal under MVCC; see timestamps_for_key.py)
        self.tfk_inversions = 0
        # frontier-driven execution mode (burn harness): STABLE indexed txns
        # park here instead of firing ReadyToExecute inline; the device
        # kahn_frontier release task pops them (SURVEY §7 stage 8)
        self.frontier_exec = False
        self.exec_deferred: set = set()
        # per-key execution-timestamp registers (impl/TimestampsForKey.java):
        # last_write / last_executed / monotonic HLC, updated on the normal
        # execution path and merged on adoption/heal paths
        from .timestamps_for_key import TimestampsForKeys
        self.timestamps_for_key = TimestampsForKeys()
        # the conflict-index data plane (impl/resolver.py): answers the deps
        # and max-conflict queries; cpu = cfk walk, tpu = device GraphState
        from ..impl.resolver import make_resolver
        self.resolver = make_resolver(getattr(node, "resolver_kind", "cpu"),
                                      self, config=getattr(node, "config", None))
        # the columnar protocol engine (protocol_batch/): a struct-of-arrays
        # mirror of this store's hot command state + vectorized passes over
        # it (release fan-out, frontier classification, progress scans).
        # None when columnar=off: every legacy code path stays untouched.
        # Exact-skip contract: the engine never changes a protocol decision
        # (same-seed burns columnar on-vs-off are byte-identical, proven by
        # tests/test_protocol_batch.py).
        from ..protocol_batch import make_engine
        self.batch_engine = make_engine(self)

    def observer(self):
        """The run's flight recorder (observe.FlightRecorder), or None.
        Lives on the Node so every store of every incarnation reports into
        the same run-wide recorder."""
        return getattr(self.node, "observer", None)

    # -- ranges -------------------------------------------------------------
    def update_ranges(self, epoch: int, ranges: Ranges) -> None:
        self.ranges_by_epoch[epoch] = ranges
        self._all_ranges_cache = None   # the only mutation site

    def ranges_at(self, epoch: int) -> Ranges:
        """Ranges covered at ``epoch`` (latest known at-or-before epoch)."""
        best_e = None
        for e in self.ranges_by_epoch:
            if e <= epoch and (best_e is None or e > best_e):
                best_e = e
        return self.ranges_by_epoch.get(best_e, Ranges.EMPTY) if best_e is not None else Ranges.EMPTY

    def current_ranges(self) -> Ranges:
        if not self.ranges_by_epoch:
            return Ranges.EMPTY
        return self.ranges_by_epoch[max(self.ranges_by_epoch)]

    # -- cache-miss plane (PreLoadContext capability) ------------------------
    def lookup(self, txn_id: TxnId) -> Optional[Command]:
        """Fault-in-aware command read: EVERY reader (SafeCommandStore,
        progress log, barrier scans) must see evicted state as if resident."""
        cmd = self.commands.get(txn_id)
        if cmd is None and txn_id in self.cold:
            cmd = self._fault_in(txn_id)
        return cmd

    def _fault_in(self, txn_id: TxnId) -> Optional[Command]:
        """Reload an evicted command from the journal (the store of record) —
        the cache-miss path (PreLoadContext / AbstractSafeCommandStore async
        loads; reloads here are synchronous, with the interleaving dimension
        exercised by DelayedAgentExecutor's deferred store tasks)."""
        self.cold.discard(txn_id)
        summary = self.cold_summaries.pop(txn_id, None)
        cmd = self.journal.reconstruct_one(self, txn_id) \
            if self.journal is not None else None
        if cmd is not None:
            if summary is not None and summary.elided_unapplied:
                # restore the unresolved-elision set from the evict-time
                # summary: it is journaled too, but the summary is FRESHER
                # (serve-time prunes since the last journal save) — and
                # without either restore the fault-in LAUNDERS the command
                # into a falsely-clean floor dep and the grandfathered
                # serve certifies slices whose writes only the still-
                # outstanding bootstrap fetch can deliver (seed-6 k428
                # prefix loss rode exactly this wash cycle)
                cmd.elided_unapplied = set(summary.elided_unapplied)
            self.commands[txn_id] = cmd
            self.cache_miss_loads += 1
            if self.batch_engine is not None:
                # the reload made the command resident again: re-mirror it so
                # the columnar scans see it (absence would only cost speed —
                # unknown rows take the scalar path — but residency tracking
                # must never claim a row for an evicted command, so the
                # mirror follows residency in BOTH directions)
                self.batch_engine.note_fault_in(cmd)
        return cmd

    def all_ranges(self) -> Ranges:
        """Union of every epoch's owned ranges.  Memoized: this sits on the
        frontier-init / elision / apply hot paths (tens of thousands of
        calls per burn) and re-unioned the whole epoch map per call;
        ``update_ranges`` is the only mutation site and invalidates."""
        out = self._all_ranges_cache
        if out is None:
            out = Ranges.EMPTY
            for r in self.ranges_by_epoch.values():
                out = out.union(r)
            self._all_ranges_cache = out
        return out

    def unapplied_pressure(self, min_age_s: float = 10.0,
                           cap: int = 64) -> int:
        """Count of txns DECIDED (stable-or-later) at least ``min_age_s`` of
        sim-time ago that have not applied locally — the protocol-local
        signal behind the auditor's ``slo.unapplied`` flag plane, computed
        from store state only (never from the observer: zero observer
        effect).  The bootstrap retry ladder and the staleness catch-up
        escalation consult it to back off the re-fencing cadence while the
        execution plane is visibly behind — re-fencing faster than in-flight
        reads can assemble partial coverage is the seed-6 wedge."""
        from .status import SaveStatus as _SS, Status as _S
        horizon = self.node.now_micros() - int(min_age_s * 1_000_000)
        n = 0
        for cmd in self.commands.values():
            ss = cmd.save_status
            if not ss.has_been(_S.STABLE) or ss.is_truncated \
                    or ss is _SS.INVALIDATED \
                    or ss.ordinal >= _SS.APPLIED.ordinal:
                continue
            ts = cmd.execute_at if cmd.execute_at is not None else cmd.txn_id
            if ts.hlc <= horizon:
                n += 1
                if n >= cap:
                    # the consumers scale a delay that saturates long before
                    # this; don't finish an O(commands) scan per retry rung
                    # just to refine a number past its use
                    return n
        return n

    # -- execution ----------------------------------------------------------
    def execute(self, task: Callable[["SafeCommandStore"], None]) -> None:
        def run():
            prev, CommandStore._current = CommandStore._current, self
            try:
                task(SafeCommandStore(self))
            finally:
                CommandStore._current = prev
        self.executor.execute(run)

    def submit(self, task: Callable[["SafeCommandStore"], object],
               preload=None) -> au.AsyncChain:
        def run():
            prev, CommandStore._current = CommandStore._current, self
            try:
                return task(SafeCommandStore(self))
            finally:
                CommandStore._current = prev
        pending = self._cold_among(preload)
        if not pending:
            return self.executor.submit(run)
        result = au.settable()

        def start():
            self.executor.submit(run).begin(
                lambda v, f: result.set_failure(f) if f is not None
                else result.set_success(v))
        self._load_then(pending, start)
        return result.to_chain()

    def _cold_among(self, preload) -> list:
        """The declared ids whose state is evicted (PreLoadContext: the
        operation cannot run until these are loaded)."""
        if preload is None or not self.cold:
            return []
        return [tid for tid in preload if tid in self.cold]

    def _load_then(self, pending: list, start: Callable[[], None]) -> None:
        """The pending-load path (PreLoadContext.java /
        AbstractSafeCommandStore's load machinery): the declared-cold ids are
        faulted in by ONE separate executor task before the operation task is
        scheduled — the operation observes an async load boundary (under
        DelayedAgentExecutor both hops get random delays, so other store
        tasks interleave with the load: the interleaving the reference's
        cache-miss injection exists to stress,
        DelayedCommandStores.java:138-195).  One task for ALL of an
        operation's loads, not one per id: per-id hops serialized a
        delayed-store chain per cold dependency and ground hostile burns to
        a crawl."""
        self.pending_loads += len(pending)

        def run_loads():
            prev, CommandStore._current = CommandStore._current, self
            try:
                for tid in pending:
                    if tid in self.cold:
                        try:
                            self._fault_in(tid)
                        except BaseException as e:  # noqa: BLE001
                            # a failed load must not strand the operation
                            # (the chain would never settle): report and
                            # continue — the op sees the id as absent
                            self.agent().on_uncaught_exception(e)
            finally:
                CommandStore._current = prev
                start()
        self.executor.execute(run_loads)

    def check_in_store(self) -> None:
        Invariants.check_state(CommandStore._current is self,
                               "operation invoked outside its CommandStore")

    def agent(self) -> Agent:
        return self.executor.agent

    def __repr__(self) -> str:
        return f"CommandStore({self.id}@{self.node.id}, {self.current_ranges()!r})"


class SafeCommandStore:
    """Transactional view passed to every in-store operation."""

    __slots__ = ("store",)

    def __init__(self, store: CommandStore):
        self.store = store

    # -- commands -----------------------------------------------------------
    def get_or_create(self, txn_id: TxnId) -> Command:
        cmd = self.store.lookup(txn_id)
        if cmd is None:
            cmd = Command(txn_id)
            self.store.commands[txn_id] = cmd
        return cmd

    def get_if_exists(self, txn_id: TxnId) -> Optional[Command]:
        return self.store.lookup(txn_id)

    def _fault_in(self, txn_id: TxnId) -> Optional["Command"]:
        return self.store._fault_in(txn_id)

    def evict(self, txn_id: TxnId) -> bool:
        """Drop a TERMINAL command's in-memory state (journal keeps the
        record).  Terminal = applied/invalidated/truncated: no further
        transitions, so its listener registrations are historical and every
        waiter was already notified at the transition."""
        store = self.store
        cmd = store.commands.get(txn_id)
        if cmd is None or store.journal is None:
            return False
        from .status import SaveStatus as _SS
        terminal = cmd.save_status in (_SS.APPLIED, _SS.INVALIDATED) \
            or cmd.save_status.is_truncated
        if not terminal:
            return False
        del store.commands[txn_id]
        store.cold.add(txn_id)
        store.cold_summaries[txn_id] = CommandSummary(cmd)
        if store.batch_engine is not None:
            # residency left: the columnar mirror must forget the row, or a
            # vectorized scan would skip the fault-in the scalar path takes
            store.batch_engine.drop(txn_id)
        store.journal.on_evict(store, txn_id)
        obs = store.observer()
        if obs is not None:
            obs.registry.counter("store.evictions", node=store.node.id,
                                 store=store.id).inc()
        return True

    # -- cfk ----------------------------------------------------------------
    def cfk(self, key: RoutingKey) -> CommandsForKey:
        c = self.store.cfks.get(key)
        if c is None:
            c = CommandsForKey(key)
            self.store.cfks[key] = c
        return c

    def cfk_if_exists(self, key: RoutingKey) -> Optional[CommandsForKey]:
        return self.store.cfks.get(key)

    # -- deps queries (SafeCommandStore.mapReduceActive, :292) ---------------
    def map_reduce_active(self, keys, ranges, before: Timestamp, by: TxnId,
                          visit: Callable[[object, TxnId], None]) -> None:
        """Visit (key_or_range, dep_txn_id) for every active txn with txnId < before
        that conflicts with the given keys/ranges and is witnessed by ``by``'s kind.

        - key footprint: the resolver's per-key conflict index (cfk walk on CPU,
          one batched device join on TPU — impl/resolver.py);
        - plus range txns whose ranges intersect the keys;
        - range footprint: resolver query over indexed keys within the ranges +
          intersecting range txns (InMemoryCommandStore range scan :814-900).
        """
        local = self.store.current_ranges()
        rb = self.store.redundant_before
        resolver = self.store.resolver
        witnesses = by.witnesses
        if keys is not None:
            by_rk = {}
            for key in keys:
                rk = key.to_routing() if hasattr(key, "to_routing") else key
                if local.contains(rk):
                    by_rk[rk] = key
            for rk, dep in resolver.key_conflicts(by, list(by_rk), before):
                visit(by_rk[rk], dep)
            for rk, key in by_rk.items():
                fence = rb.fence_before(rk)
                for tid, (rngs, status) in self.store.range_txns.items():
                    if tid < before and status is not InternalStatus.INVALIDATED \
                            and (fence is None or not tid < fence) \
                            and witnesses(tid) and rngs.contains(rk):
                        visit(key, tid)
        if ranges is not None:
            for rng in ranges:
                # elide only below the MIN fence over the whole range (a txn may
                # intersect a sub-interval with a lower fence)
                fence = rb.min_fence_over(rng)
                for rk, dep in resolver.range_conflicts(by, rng, before):
                    if local.contains(rk):
                        visit(rk, dep)
                for tid, (rngs, status) in self.store.range_txns.items():
                    if tid < before and status is not InternalStatus.INVALIDATED \
                            and (fence is None or not tid < fence) \
                            and witnesses(tid):
                        # record the dep against the OVERLAP with its own
                        # footprint, not the querier's whole range: deps sliced
                        # to another store must not carry txns that never touch
                        # it (they would wait forever for an apply that cannot
                        # happen there) — RangeDeps participant semantics
                        for piece in rngs:
                            x = piece.intersection(rng)
                            if x is not None:
                                visit(x, tid)

    def max_conflict(self, keys, ranges) -> Optional[Timestamp]:
        """Max txnId/executeAt witnessed intersecting the footprint (MaxConflicts)."""
        out: Optional[Timestamp] = None
        resolver = self.store.resolver

        def bump(ts: Optional[Timestamp]):
            nonlocal out
            if ts is not None and (out is None or ts > out):
                out = ts

        if keys is not None:
            rks = [key.to_routing() if hasattr(key, "to_routing") else key
                   for key in keys]
            bump(resolver.max_conflict_keys(rks))
            # range txns covering these keys (per-range MaxConflicts map)
            bump(self.store.max_conflicts.get(keys))
        if ranges is not None:
            for rng in ranges:
                bump(resolver.max_conflict_range(rng))
            bump(self.store.max_conflicts.get(ranges))
        return out

    # -- registration -------------------------------------------------------
    def register_witness(self, command: Command, status: InternalStatus) -> None:
        """Index a txn in the per-key / range structures for deps calculation."""
        from .status import Status as _S, SaveStatus as _SS
        if status is InternalStatus.INVALIDATED \
                and command.has_been(_S.PRE_COMMITTED) \
                and command.save_status is not _SS.INVALIDATED:
            # a committed txn can never be invalidated: a late/erroneous
            # invalidation must not touch ANY index plane (cfk, resolver,
            # range table) — one choke point keeps the planes in lockstep
            return
        scope = command.route.participants() if command.route is not None else None
        if scope is None:
            return
        local = self.store.current_ranges()
        if isinstance(scope, Ranges):
            prev = self.store.range_txns.get(command.txn_id)
            rngs = scope.intersection(local)
            # keep the max status seen
            if prev is None or status > prev[1]:
                self.store.range_txns[command.txn_id] = (rngs, status)
            ts = command.execute_at if command.execute_at is not None else command.txn_id
            self.store.max_conflicts = self.store.max_conflicts.update(rngs, ts)
        else:
            ea = command.execute_at
            # feed the resolver exactly the keys the cfk indexed (it refuses
            # unmanaged txns and pruned-entry resurrection) so both data
            # planes stay in lockstep
            indexed = tuple(
                rk for rk in scope
                if local.contains(rk)
                and self.cfk(rk).update(command.txn_id, status, ea))
            if indexed:
                self.store.resolver.register(command.txn_id, status, ea, indexed)
                engine = self.store.batch_engine
                if engine is not None:
                    # the key-set offsets plane of the columnar layout (the
                    # ConsultBatch ingress bridge reads these CSR rows)
                    engine.note_keys(command.txn_id,
                                     [engine.key_slot(rk) for rk in indexed])

    def mark_txn_durable(self, command: Command) -> None:
        """Per-txn majority durability (InformDurable after the coordinator's
        apply quorum, Commands.setDurability → cfk): widen the per-key elision
        gate for this txn immediately and let terminal entries demote out of
        the hot walk (cfk.mark_durable)."""
        if command.route is None:
            return
        scope = command.route.participants()
        if isinstance(scope, Ranges):
            return    # range txns are indexed in range_txns, not cfk
        local = self.store.current_ranges()
        for key in scope:
            rk = key.to_routing() if hasattr(key, "to_routing") else key
            if not local.contains(rk):
                continue
            cfk = self.store.cfks.get(rk)
            if cfk is not None:
                cfk.mark_durable(command.txn_id)
        self.store.resolver.mark_durable(command.txn_id)

    def journal_save(self, command: Command) -> None:
        """Record the command's durable state in the attached journal (no-op
        without one) — the persistence contract hook (impl/basic/Journal)."""
        if self.store.journal is not None:
            self.store.journal.save(self.store, command)

    # -- listeners -----------------------------------------------------------
    def add_transient_listener(self, txn_id: TxnId, callback: Callable) -> None:
        self.store.transient_listeners.setdefault(txn_id, []).append(callback)

    def notify_listeners(self, command: Command) -> None:
        """Fire command-listeners (dependent txns) and transient listeners.

        With the columnar engine, the per-waiter release checks run as ONE
        batched pass over the listener set first (the vectorized
        ``remove_waiting`` fan-out): waiters the mirror PROVES still-blocked
        skip their scalar visit — the visit would read state and return
        without any mutation, observation, or fault-in (the skip proof is in
        BatchEngine.release_skip_mask).  A cascade that advances this
        command mid-fan-out invalidates the proof, so the dep snapshot is
        re-validated between visits; on any change the remaining waiters
        take the scalar path."""
        from . import commands as C
        listener_ids = list(command.listeners)
        engine = self.store.batch_engine
        skip = None
        if engine is not None and len(listener_ids) >= ENGAGE_FLOOR:
            skip = engine.release_skip_mask(command, listener_ids)
        if skip is None:
            for waiter_id in listener_ids:
                waiter = self.get_if_exists(waiter_id)
                if waiter is not None:
                    C.update_dependency_and_maybe_execute(self, waiter, command)
        else:
            snap = engine.release_snapshot(command)
            valid = True
            for i, waiter_id in enumerate(listener_ids):
                if valid and skip[i]:
                    if engine.release_snapshot(command) == snap:
                        continue
                    valid = False   # dep advanced mid-fan-out: proof void
                waiter = self.get_if_exists(waiter_id)
                if waiter is not None:
                    C.update_dependency_and_maybe_execute(self, waiter, command)
        for cb in list(self.store.transient_listeners.get(command.txn_id, ())):
            cb(self, command)

    def remove_transient_listener(self, txn_id: TxnId, callback: Callable) -> None:
        lst = self.store.transient_listeners.get(txn_id)
        if lst and callback in lst:
            lst.remove(callback)
            if not lst:
                del self.store.transient_listeners[txn_id]

    # -- durability / GC (RedundantBefore, DurableBefore, Cleanup) ------------
    def redundant_before(self):
        return self.store.redundant_before

    def durable_before(self):
        return self.store.durable_before

    def mark_locally_applied_before(self, txn_id: TxnId, ranges: Ranges) -> None:
        """Everything on ``ranges`` before ``txn_id`` has locally applied (fired
        when an exclusive sync point applies here: it waited on all of it).
        Advancing the fence also prunes the conflict indexes below it — the
        fence txn stands in for the pruned entries in future deps calcs."""
        from .durability import RedundantBefore
        local = ranges.intersection(self.store.all_ranges())
        if local:
            self.store.redundant_before = self.store.redundant_before.merge(
                RedundantBefore.of(local, locally_applied_before=txn_id))
            self._prune_below_fences()

    def _prune_below_fences(self) -> None:
        """Drop applied/invalidated index entries wholly below their fence."""
        from .cfk import InternalStatus as IS
        store = self.store
        rb = store.redundant_before
        for txn_id in list(store.range_txns):
            rngs, status = store.range_txns[txn_id]
            if status not in (IS.APPLIED, IS.INVALIDATED) or not rngs:
                continue
            fences = [rb.min_fence_over(r) for r in rngs]
            if all(f is not None and txn_id < f for f in fences):
                del store.range_txns[txn_id]
        for rk, cfk in store.cfks.items():
            fence = rb.fence_before(rk)
            if fence is not None:
                store.resolver.on_pruned(rk, cfk.prune_applied_before(fence))

    def mark_shard_durable(self, txn_id: TxnId, ranges: Ranges) -> None:
        """SetShardDurable: the durability round proved (via an all-replica
        WaitUntilApplied, CoordinateShardDurable.java) that everything on
        ``ranges`` before ``txn_id`` has applied at EVERY replica — advance
        both the majority and universal watermarks (matching
        CommandStore.markShardDurable, CommandStore.java:520-528) and the
        shard-applied redundancy bound."""
        from .durability import DurableBefore, RedundantBefore
        local = ranges.intersection(self.store.all_ranges())
        if local:
            self.store.durable_before = self.store.durable_before.merge(
                DurableBefore.of(local, majority_before=txn_id,
                                 universal_before=txn_id))
            self.store.redundant_before = self.store.redundant_before.merge(
                RedundantBefore.of(local, shard_applied_before=txn_id))
            self.store.durable_gen += 1   # elision gate may have widened
        self.run_gc()

    def merge_durable_before(self, durable_before) -> None:
        """SetGloballyDurable: adopt a cluster-wide durability watermark map."""
        self.store.durable_before = self.store.durable_before.merge(durable_before)
        self.store.durable_gen += 1       # elision gate may have widened
        self.run_gc()

    def run_gc(self) -> None:
        """Truncate/erase commands per the Cleanup lattice; prune per-key and
        range indexes below the shard-redundant bound (Cleanup.java, cfk pruning)."""
        from .durability import Cleanup, should_cleanup
        from . import commands as C
        store = self.store
        # evicted commands are still subject to GC — but only ids below the
        # highest locally-redundant bound can possibly be cleanable
        # (should_cleanup gates on is_locally_redundant), so only those fault
        # in; the rest stay cold.  A cold id is re-evaluated only when a bound
        # that could RAISE its cleanup tier has advanced since it was last
        # evaluated (cold_gc_seen memo): run_gc fires on every durability
        # message, and unconditionally re-faulting the whole cold set decoded
        # every journal entry each time — the hostile churn matrix spent most
        # of its wall-clock in exactly that codec thrash.
        footprint = store.all_ranges()
        gc_bound = store.redundant_before.max_locally_redundant_over(footprint)
        if gc_bound is not None:
            maj, uni = store.durable_before.max_bounds_over(footprint)
            shard = store.redundant_before.max_shard_redundant_over(footprint)
            sig = (gc_bound, maj, uni, shard)
            seen = store.cold_gc_seen
            # the store-wide maxes can miss a PER-RANGE bound advance (another
            # range's entries dominate every max): clear the memo on a slow
            # cadence so such cold commands are still eventually re-evaluated
            store.gc_runs = getattr(store, "gc_runs", 0) + 1
            if store.gc_runs % 32 == 0:
                seen = store.cold_gc_seen = {}
            for cold_id in list(store.cold):
                if cold_id < gc_bound and seen.get(cold_id) != sig:
                    seen[cold_id] = sig
                    self.get_if_exists(cold_id)
            if len(seen) > 2 * len(store.cold):
                store.cold_gc_seen = {
                    k: v for k, v in seen.items() if k in store.cold}
        for txn_id, cmd in list(store.commands.items()):
            cleanup = should_cleanup(cmd, store.redundant_before, store.durable_before)
            if cleanup is Cleanup.NO:
                continue
            if cleanup is Cleanup.ERASE:
                parts = cmd.route.participants() if cmd.route is not None else None
                if parts is not None \
                        and store.redundant_before.is_shard_redundant(txn_id, parts):
                    # physically drop: late messages are fended off by the
                    # shard-redundant guard in commands (_is_shard_redundant).
                    # INVALIDATED tombstones must ALSO wait for the shard
                    # fence: deleting one destroys the ballot promise and the
                    # decision evidence, so a later recovery re-creates the
                    # txn fresh, adopts stale ACCEPTED evidence from a replica
                    # the invalidation quorum never touched, and COMMITS a
                    # txn that was already invalidated at a quorum (seed-4
                    # fence trace: invalidate@[139] at {n1,n2,n4} erased,
                    # then recover@[146] committed via n5's old accept).
                    del store.commands[txn_id]
                    store.transient_listeners.pop(txn_id, None)
                    if store.batch_engine is not None:
                        store.batch_engine.drop(txn_id)
                    # the physical drop bypasses every transition choke point:
                    # tell the frontier mirror directly, or its slot keeps the
                    # last-registered status (STABLE rows then sit in the
                    # kernel frontier as ready forever — the mirror leak)
                    store.resolver.note_terminal(txn_id)
                    if store.journal is not None:
                        store.journal.erase(store, txn_id)
                    continue
                if cmd.save_status is SaveStatus.INVALIDATED:
                    # NOT yet shard-redundant: the tombstone must persist AS
                    # INVALIDATED until the shard fence (downgrading it to
                    # ERASED weakens "decided invalid" to "unknowable" and
                    # re-opens the round-4 resurrection class; the auditor's
                    # edge table forbids INVALIDATED -> ERASED for the same
                    # reason)
                    continue
            C.truncate(self, cmd, cleanup)
        # prune conflict indexes below the shard-applied bound per key, and
        # flag/demote entries below the majority-durable watermark (entries
        # that never saw a per-txn InformDurable still leave the hot walk)
        for rk, cfk in store.cfks.items():
            e = store.durable_before.entry(rk)
            if e is not None and e.majority_before is not None:
                cfk.mark_durable_below(e.majority_before)
            bound = store.redundant_before.shard_redundant_before(rk)
            if bound is not None:
                store.resolver.on_pruned(rk, cfk.prune_applied_before(bound))
        # trim the per-key execution registers below the same bound
        # (TimestampsForKey.withoutRedundant)
        store.timestamps_for_key.remove_redundant_by(
            lambda key: store.redundant_before.shard_redundant_before(
                key.to_routing() if hasattr(key, "to_routing") else key))
        for txn_id in list(store.range_txns):
            rngs, _status = store.range_txns[txn_id]
            if store.redundant_before.is_locally_redundant(txn_id, rngs) \
                    and store.redundant_before.min_shard_redundant_before(rngs) is not None \
                    and txn_id < store.redundant_before.min_shard_redundant_before(rngs):
                del store.range_txns[txn_id]

    # -- context ------------------------------------------------------------
    def data_store(self) -> DataStore:
        return self.store.node.data_store

    def agent(self) -> Agent:
        return self.store.agent()

    def progress_log(self) -> ProgressLog:
        return self.store.progress_log

    def time(self):
        return self.store.node

    def ranges_at(self, epoch: int) -> Ranges:
        return self.store.ranges_at(epoch)

    def current_ranges(self) -> Ranges:
        return self.store.current_ranges()

    def node(self) -> "Node":
        return self.store.node


class CommandStores:
    """Shard manager: routes operations to intersecting stores
    (CommandStores.java mapReduceConsume :580-620, updateTopology :402-482)."""

    def __init__(self, node: "Node", num_shards: int = 1,
                 executor_factory: Optional[Callable[[int], AgentExecutor]] = None):
        self.node = node
        self.num_shards = num_shards
        factory = executor_factory or (lambda i: AgentExecutor(node.agent))
        self.stores: List[CommandStore] = [
            CommandStore(i, node, factory(i)) for i in range(num_shards)
        ]
        # sticky range -> store assignment: a range must stay with the store that
        # holds its Command/cfk history across topology changes
        self._assignment: Dict[Range, int] = {}

    # -- topology -----------------------------------------------------------
    def update_topology(self, topology) -> None:
        """Distribute this node's ranges across stores. Previously-assigned ranges
        keep their store (their command/cfk state lives there); new ranges go to the
        least-loaded store (ShardDistributor.EvenSplit semantics)."""
        my_ranges = topology.ranges_for_node(self.node.id)
        buckets: List[List[Range]] = [[] for _ in self.stores]
        unassigned: List[Range] = []
        for rng in my_ranges:
            sid = self._assignment.get(rng)
            if sid is not None:
                buckets[sid].append(rng)
            else:
                unassigned.append(rng)
        for rng in unassigned:
            sid = min(range(len(buckets)), key=lambda i: len(buckets[i]))
            self._assignment[rng] = sid
            buckets[sid].append(rng)
        for store, bucket in zip(self.stores, buckets):
            store.update_ranges(topology.epoch, Ranges.of(*bucket))

    # -- routing ------------------------------------------------------------
    def intersecting_stores(self, unseekables, min_epoch: int, max_epoch: int) -> List[CommandStore]:
        if isinstance(unseekables, Route):
            unseekables = unseekables.participants()
        out = []
        for store in self.stores:
            for e in range(min_epoch, max_epoch + 1):
                ranges = store.ranges_at(e)
                if ranges and unseekables is not None and ranges.intersects(unseekables):
                    out.append(store)
                    break
                if ranges and unseekables is None:
                    out.append(store)
                    break
        return out

    def map_reduce(self, unseekables, min_epoch: int, max_epoch: int,
                   map_fn: Callable[[SafeCommandStore], object],
                   reduce_fn: Callable[[object, object], object],
                   preload=None) -> au.AsyncChain:
        """Run map_fn in every intersecting store (on its executor), reduce
        results.  ``preload`` declares the txn ids the operation touches
        (PreLoadContext): evicted ones are loaded asynchronously first."""
        stores = self.intersecting_stores(unseekables, min_epoch, max_epoch)
        if not stores:
            return au.done(None)
        if len(stores) == 1:
            # fast path (the PR-8 loop-is-the-wall finding): the common
            # single-shard routing built three AsyncChain layers per message
            # (all_of + map + reduce of one element) just to return the lone
            # store's result unchanged.  Submitting directly is value- and
            # timing-identical — all_of/map add no scheduling, only
            # callback wrapping — so this is pure event-loop relief.
            return stores[0].submit(map_fn, preload=preload)
        chains = [s.submit(map_fn, preload=preload) for s in stores]

        def reduce_all(results):
            acc = None
            first = True
            for r in results:
                if first:
                    acc, first = r, False
                else:
                    acc = reduce_fn(acc, r)
            return acc

        return au.all_of(chains).map(reduce_all)

    def for_each(self, unseekables, min_epoch: int, max_epoch: int,
                 fn: Callable[[SafeCommandStore], None],
                 preload=None) -> au.AsyncChain:
        return self.map_reduce(unseekables, min_epoch, max_epoch,
                               lambda s: (fn(s), None)[1], lambda a, b: None,
                               preload=preload)

    def all_stores(self) -> List[CommandStore]:
        return list(self.stores)
