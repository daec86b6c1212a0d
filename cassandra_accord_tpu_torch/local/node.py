"""The per-process facade: clock, coordination entry, message dispatch.

Capability parity with ``accord.local.Node`` (Node.java:100-775): owns the node id,
the CAS hybrid-logical clock (``unique_now``), the TopologyManager, the CommandStores,
and the send/receive plumbing.  ``coordinate(txn)`` is the client entry point
(Node.java:573); ``receive(request, from, reply_ctx)`` the server entry point
(Node.java:705) with its wait-for-epoch gate.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, List, Optional

from ..api.interfaces import (Agent, ConfigurationService, DataStore, MessageSink,
                              ProgressLog, Scheduler)
from ..primitives.keys import Keys, Ranges, RoutingKey
from ..primitives.route import Route
from ..primitives.timestamp import Ballot, Domain, Timestamp, TxnId, TxnKind
from ..primitives.txn import Txn
from ..utils import async_ as au
from ..utils.invariants import check_state
from ..utils.random import RandomSource
from ..topology.manager import EpochReady, TopologyManager
from .command_store import AgentExecutor, CommandStores, SafeCommandStore

if TYPE_CHECKING:
    from ..messages.base import Callback, Reply, Request
    from ..topology.topology import Topologies, Topology


class Node(ConfigurationService.Listener):
    def __init__(self, node_id: int, message_sink: MessageSink,
                 config_service: ConfigurationService, agent: Agent,
                 scheduler: Scheduler, data_store: DataStore,
                 random: RandomSource, now_micros: Callable[[], int],
                 num_shards: int = 1,
                 executor_factory: Optional[Callable[[int], AgentExecutor]] = None,
                 progress_log_factory: Optional[Callable[[object], ProgressLog]] = None,
                 resolver: Optional[str] = None,
                 config=None):
        from ..config import LocalConfig
        self.id = node_id
        self.message_sink = message_sink
        self.config_service = config_service
        self.agent = agent
        self.scheduler = scheduler
        self.data_store = data_store
        self.random = random
        self._now_micros = now_micros
        # one injected config object (config/LocalConfig.java); env vars are
        # the default source, the object is the override surface
        self.config: LocalConfig = config if config is not None \
            else LocalConfig.from_env()
        # deps-resolver data plane selection (impl/resolver.py): cpu|tpu|verify
        from ..impl.resolver import check_resolver_kind
        self.resolver_kind = check_resolver_kind(
            resolver if resolver is not None else self.config.resolver_kind)
        # flight recorder (observe.FlightRecorder) — assigned by the harness
        # cluster after construction; None outside instrumented runs.  Hooks
        # must stay passive (zero observer effect): they may read sim state
        # but never touch RNG, wall clock, or scheduling.
        self.observer = None
        # wall-clock profiler (observe.WallProfiler) — assigned by the
        # harness cluster like the observer; explicitly OUTSIDE the
        # determinism contract (it reads wall clocks) but still forbidden
        # from perturbing the sim (no RNG, no scheduling, no message path)
        self.profiler = None
        # overload plane (local/overload.py): the admission controller exists
        # only when its knob is on — the default-off path allocates nothing
        # and every trajectory stays byte-identical.  The counters dict is
        # plain state the retry budgets increment (budget denials) so the
        # burn harness can sum them without an observer attached.
        self.admission = None
        if self.config.admission_enabled:
            from .overload import AdmissionController
            self.admission = AdmissionController(self)
        self.overload_counters: Dict[str, int] = {"nacks": 0,
                                                  "budget_denied": 0}
        self.topology = TopologyManager(node_id)
        self._epoch_watchdogs: set = set()
        self.command_stores = CommandStores(self, num_shards, executor_factory)
        self._progress_log_factory = progress_log_factory
        self._exclusive_sync_point_listeners: List[Callable] = []
        self._last_hlc = 0
        config_service.register_listener(self)
        topo = config_service.current_topology()
        if topo is not None and topo.size > 0:
            self.on_topology_update(topo, start_sync=True)

    def slow_peers(self) -> frozenset:
        """Peers the sink's gray-failure tracker currently marks slow
        (reply-latency EWMA over threshold, or inside the post-timeout
        penalty window).  Coordinators route per-shard data reads around
        them; empty when the sink has no tracker (maelstrom, mocks)."""
        tracker = getattr(self.message_sink, "slow_replicas", None)
        if tracker is None:
            return frozenset()
        return tracker.slow_peers()

    # -- time (Node.java:335-360) -------------------------------------------
    def now_micros(self) -> int:
        return self._now_micros()

    def unique_now(self) -> Timestamp:
        hlc = max(self._now_micros(), self._last_hlc + 1)
        self._last_hlc = hlc
        return Timestamp(self.epoch(), hlc, self.id)

    def unique_now_at_least(self, at_least: Timestamp) -> Timestamp:
        hlc = max(self._now_micros(), self._last_hlc + 1, at_least.hlc + 1)
        self._last_hlc = hlc
        epoch = max(self.epoch(), at_least.epoch)
        return Timestamp(epoch, hlc, self.id)

    def epoch(self) -> int:
        return self.topology.current_epoch

    def next_txn_id(self, kind: TxnKind, domain: Domain) -> TxnId:
        ts = self.unique_now()
        return TxnId(ts.epoch, ts.hlc, self.id, kind, domain)

    def ballot_after(self, after: Optional[Ballot]) -> Ballot:
        ts = self.unique_now() if after is None else self.unique_now_at_least(after)
        return Ballot.from_timestamp(ts)

    # -- topology (Node.java:249, ConfigurationService.Listener) --------------
    def on_topology_update(self, topology: "Topology", start_sync: bool) -> au.AsyncResult:
        if self.topology.current_epoch >= topology.epoch and self.topology.current_epoch > 0:
            return au.success_result()
        first_epoch = self.topology.current_epoch == 0
        # diff against the PREVIOUS epoch only: a range this node replicated in
        # some older epoch but not the last one was written without us — it
        # must re-bootstrap like any fresh adoption
        prev_epoch = topology.epoch - 1
        prev_ranges = {store.id: store.ranges_at(prev_epoch)
                       for store in self.command_stores.all_stores()}
        self.command_stores.update_topology(topology)
        if self._progress_log_factory is not None:
            for store in self.command_stores.all_stores():
                if isinstance(store.progress_log, type(ProgressLog.NOOP)):
                    store.progress_log = self._progress_log_factory(store)

        # which stores adopted new ranges? (CommandStores.java:402-482)
        added_per_store = []
        if not first_epoch:
            for store in self.command_stores.all_stores():
                added = store.ranges_at(topology.epoch).without(
                    prev_ranges.get(store.id, Ranges.EMPTY))
                # dedup: ranges already being bootstrapped (an earlier epoch's
                # in-flight attempt) need no second concurrent attempt — under
                # rapid churn duplicates otherwise stack up unboundedly
                added = added.without(store.pending_bootstrap)
                if added:
                    added_per_store.append((store, added))

        data_ready = au.settable() if added_per_store else None

        def ready_factory(topo):
            if data_ready is None:
                return EpochReady.done(topo.epoch)
            return EpochReady(topo.epoch, data=data_ready, reads=data_ready)

        # register the epoch FIRST: bootstrap coordination needs it
        ready = self.topology.on_topology_update(topology, ready_factory)

        if added_per_store:
            from .bootstrap import Bootstrap
            bootstraps = [Bootstrap(self, store, added, topology.epoch).start()
                          for store, added in added_per_store]
            au.all_of([b.to_chain() for b in bootstraps]).begin(
                lambda _v, f: data_ready.set_failure(f) if f is not None
                else data_ready.set_success(None))

        self.config_service.acknowledge_epoch(ready, start_sync)
        return au.success_result()

    def on_remote_sync_complete(self, node_id: int, epoch: int) -> None:
        self.topology.on_remote_sync_complete(node_id, epoch)

    def on_epoch_closed(self, ranges: Ranges, epoch: int) -> None:
        self.topology.on_epoch_closed(ranges, epoch)

    def on_epoch_redundant(self, ranges: Ranges, epoch: int) -> None:
        self.topology.on_epoch_redundant(ranges, epoch)

    def truncate_topology_until(self, epoch: int) -> None:
        self.topology.truncate_until(epoch)

    # epoch-fetch watchdog: re-request an awaited epoch on this cadence, and
    # give up (failing the waiters) after this many attempts — an unreachable
    # configuration service must not stall epoch-gated work forever
    # (TopologyManager.java fetch watchdog / LocalConfig epoch timeouts)

    def with_epoch(self, epoch: int) -> au.AsyncChain:
        """Await local knowledge of ``epoch`` (Node.java:289-322)."""
        if self.topology.has_epoch(epoch):
            return au.done(None)
        self.config_service.fetch_topology_for_epoch(epoch)
        if epoch not in self._epoch_watchdogs:
            self._epoch_watchdogs.add(epoch)
            self._arm_epoch_watchdog(epoch, 0)
        return self.topology.await_epoch(epoch).to_chain()

    def _arm_epoch_watchdog(self, epoch: int, attempts: int) -> None:
        def check():
            if self.topology.has_epoch(epoch):
                self._epoch_watchdogs.discard(epoch)
                return
            if attempts + 1 >= self.config.epoch_fetch_attempts:
                self._epoch_watchdogs.discard(epoch)
                from ..coordinate.errors import Timeout
                self.topology.fail_epoch_waiters(
                    epoch, Timeout(None, f"epoch {epoch} unobtainable "
                                   f"after {attempts + 1} fetch attempts"))
                return
            self.config_service.fetch_topology_for_epoch(epoch)
            self._arm_epoch_watchdog(epoch, attempts + 1)
        self.scheduler.once(self.config.epoch_fetch_retry_s, check)

    # -- coordination entry points (Node.java:573+) ---------------------------
    def coordinate(self, txn: Txn, txn_id: Optional[TxnId] = None) -> au.AsyncResult:
        from ..coordinate.coordinate_transaction import coordinate_transaction
        from ..coordinate.ephemeral_read import coordinate_ephemeral_read
        if txn_id is None:
            txn_id = self.next_txn_id(txn.kind, txn.domain)
        start = coordinate_ephemeral_read if txn.kind is TxnKind.EPHEMERAL_READ \
            else coordinate_transaction
        result = au.settable()
        self.with_epoch(txn_id.epoch).begin(
            lambda _v, f: result.set_failure(f) if f is not None
            else start(self, txn_id, txn, result))
        return result

    def recover(self, txn_id: TxnId, txn: Txn, route: Route) -> au.AsyncResult:
        """Recover (complete or invalidate) a txn whose coordinator may have died
        (Node.java:675)."""
        from ..coordinate.recover import recover as do_recover
        result = au.settable()
        self.with_epoch(txn_id.epoch).begin(
            lambda _v, f: result.set_failure(f) if f is not None
            else do_recover(self, txn_id, txn, route, result))
        return result

    def barrier(self, seekables, min_epoch: Optional[int] = None,
                barrier_type=None) -> au.AsyncResult:
        """Coordinate a barrier over keys/ranges (Barrier.java)."""
        from ..api.interfaces import BarrierType
        from ..coordinate.barrier import barrier as do_barrier
        if barrier_type is None:
            barrier_type = BarrierType.GLOBAL_SYNC
        epoch = min_epoch if min_epoch is not None else self.epoch()
        return do_barrier(self, seekables, epoch, barrier_type)

    def sync_point(self, seekables, exclusive: bool = False,
                   blocking: bool = True, txn_id: Optional[TxnId] = None) -> au.AsyncResult:
        """Coordinate a sync point (CoordinateSyncPoint.java)."""
        from ..coordinate import sync_point as sp
        if exclusive:
            return sp.coordinate_exclusive(self, seekables, blocking=blocking,
                                           txn_id=txn_id)
        return sp.coordinate_inclusive(self, seekables, blocking=blocking)

    def on_exclusive_sync_point_applied(self, txn_id: TxnId, ranges: Ranges) -> None:
        """Hook fired when an exclusive sync point this node coordinated reaches
        quorum-applied: everything before it on ``ranges`` is shard-durable.
        Wired into the durability/GC machinery (RedundantBefore/DurableBefore)."""
        for listener in list(self._exclusive_sync_point_listeners):
            listener(txn_id, ranges)

    def add_exclusive_sync_point_listener(self, listener) -> None:
        self._exclusive_sync_point_listeners.append(listener)

    def overloaded(self) -> bool:
        """Admission verdict for NEW work (False when admission is off).
        Harness clients consult this before dispatching a coordination —
        a shed there is provably sound (no txn id was ever allocated)."""
        return self.admission is not None and self.admission.overloaded()

    # -- message dispatch (Node.java:705, :425-527) ---------------------------
    def receive(self, request: "Request", from_node: int, reply_context) -> None:
        if self.admission is not None and self._admission_nack(
                request, from_node, reply_context):
            return
        wait_for = request.wait_for_epoch()
        if wait_for > 0 and not self.topology.has_epoch(wait_for):
            self.with_epoch(wait_for).begin(
                lambda _v, f: self._process_or_fail(request, from_node, reply_context, f))
            return
        self._process_or_fail(request, from_node, reply_context, None)

    def _admission_nack(self, request: "Request", from_node: int,
                        reply_context) -> bool:
        """Shed work-INITIATING requests with a fast explicit Overloaded nack
        while over the watermark.  Only PreAccept is ever shed: it is the
        sole request class that ADDS a txn to this replica — nacking
        mid-protocol traffic (Commit/Apply/recovery/reads) would block the
        very draining that lets load fall, and a shed there would leave the
        txn's fate indeterminate.  A nacked PreAccept is safe: the
        coordinator treats it like any replica failure (quorum from the
        rest, or a CoordinationFailed the harness probes to a sound
        resolution)."""
        from ..messages.base import FailureReply, MessageType
        if request.type is not MessageType.PRE_ACCEPT_REQ:
            return False
        if not self.admission.overloaded():
            return False
        self.admission.nacks += 1
        self.overload_counters["nacks"] += 1
        obs = self.observer
        if obs is not None:
            obs.registry.counter("overload.nacks", node=self.id).inc()
        from ..coordinate.errors import Overloaded
        self.message_sink.reply(from_node, reply_context, FailureReply(
            Overloaded(getattr(request, "txn_id", None),
                       f"node {self.id} shed by admission control")))
        return True

    def _process_or_fail(self, request: "Request", from_node: int, reply_context,
                         failure: Optional[BaseException]) -> None:
        if failure is not None:
            self.agent.on_handled_exception(failure)
            self.message_sink.reply_with_unknown_failure(from_node, reply_context, failure)
            return
        profiler = self.profiler
        t_start = profiler.now() if profiler is not None else 0.0
        prov = getattr(self.observer, "provenance", None) \
            if self.observer is not None else None
        if prov is not None:
            # causal bracket: sends/transitions this handler makes become
            # children of the handler event, itself a child of the delivery
            # (RECV) that triggered it — pure bookkeeping, zero observer
            # effect like the profiler bracket below
            prov.begin_handler(self.id, type(request).__name__,
                               getattr(request, "txn_id", None),
                               self._now_micros())
        try:
            request.process(self, from_node, reply_context)
        except BaseException as e:  # noqa: BLE001 — must reply so the caller unblocks
            self.agent.on_handled_exception(e)
            self.message_sink.reply_with_unknown_failure(from_node, reply_context, e)
        finally:
            if prov is not None:
                prov.end()
            if profiler is not None:
                # per-message-type handler CPU (wall plane): measured around
                # the replica-side state machine, attributed to the txn so
                # the Perfetto export can flow-link sim spans to host slices
                profiler.on_handler(self.id, type(request).__name__,
                                    getattr(request, "txn_id", None),
                                    t_start, self._now_micros())

    def send(self, to: int, request: "Request", callback: Optional["Callback"] = None) -> None:
        if callback is None:
            self.message_sink.send(to, request)
        else:
            self.message_sink.send_with_callback(to, request, callback)

    def send_to_each(self, nodes, request_factory: Callable[[int], Optional["Request"]],
                     callback: Optional["Callback"] = None) -> None:
        skipped = []
        for to in nodes:
            request = request_factory(to)
            if request is not None:
                self.send(to, request, callback)
            elif callback is not None:
                skipped.append(to)
        if skipped:
            # a factory returning None means the node has NO slice of the
            # route in the contacted epochs (compute_scope under topology
            # churn): the tracker still counts it, and silently skipping
            # leaves that slot pending FOREVER — coordinations (most
            # visibly bootstrap fence sync points) then hang un-settled and
            # their store's pending_bootstrap never clears (seed-7 replica
            # divergence).  Report each as an immediate failure so quorum
            # accounting completes; scheduled async to keep callback
            # re-entrancy out of the send loop.
            def fail_skipped():
                for to in skipped:
                    try:
                        callback.on_failure(to, RuntimeError(
                            "no route scope for node in contacted epochs"))
                    except BaseException as e:  # noqa: BLE001
                        callback.on_callback_failure(to, e)
            self.scheduler.once(0.0, fail_skipped)

    def reply(self, to: int, reply_context, reply: "Reply") -> None:
        self.message_sink.reply(to, reply_context, reply)

    # -- local map/reduce over stores (Node.java:384-422) ---------------------
    def map_reduce_consume_local(self, unseekables, min_epoch: int, max_epoch: int,
                                 map_fn: Callable[[SafeCommandStore], object],
                                 reduce_fn: Callable[[object, object], object],
                                 preload=None) -> au.AsyncChain:
        return self.command_stores.map_reduce(unseekables, min_epoch, max_epoch,
                                              map_fn, reduce_fn, preload=preload)

    def for_each_local(self, unseekables, min_epoch: int, max_epoch: int,
                       fn: Callable[[SafeCommandStore], None],
                       preload=None) -> au.AsyncResult:
        """Run ``fn`` in every intersecting store.  EAGER (unlike map_reduce_
        consume_local): the chain is begun here — fire-and-forget callers
        (CommitInvalidate, Propagate, Inform*) must not silently no-op."""
        chain = self.command_stores.for_each(unseekables, min_epoch, max_epoch,
                                             fn, preload=preload)
        result = au.settable()

        def on_done(_value, failure):
            if failure is not None:
                self.agent.on_uncaught_exception(failure)
                result.set_failure(failure)
            else:
                result.set_success(None)

        chain.begin(on_done)
        return result

    # -- route computation (Node.java:604-624) --------------------------------
    def compute_route(self, txn: Txn) -> Route:
        """Pick a homeKey from the txn's footprint in the current epoch and build
        the full route."""
        return txn.to_route()

    def __repr__(self) -> str:
        return f"Node({self.id})"
