"""Deterministic simulated cluster: one seed => one fully reproducible multi-node run.

Capability parity with ``accord.impl.basic.Cluster`` + ``NodeSink`` +
``RandomDelayQueue`` (Cluster.java:121-903, NodeSink.java:45, RandomDelayQueue):
a single-threaded event loop over a priority queue of (virtual-micros, seq, task);
all network sends, scheduler callbacks and store tasks go through the queue; per-link
behavior (latency, drop, failure) is pluggable for fault injection.  Simulated time
advances to each task's deadline — wall-clock independence is what makes every run
replayable from its seed.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Tuple

from ..api.interfaces import Agent, ConfigurationService, DataStore, EventsListener, MessageSink, Scheduler
from ..impl.list_store import ListStore
from ..local.node import Node
from ..messages.base import Callback, FailureReply, Reply, Request
from ..primitives.timestamp import Timestamp
from ..topology.topology import Shard, Topology
from ..utils import async_ as au
from ..utils.random import RandomSource
from ..coordinate.errors import Overloaded, Timeout


class PendingQueue:
    """Priority queue keyed by virtual micros; seq breaks ties deterministically.

    Recurring tasks (periodic progress-log polls, durability cycles) are marked so
    ``run_until_idle`` can stop when only recurring work remains — the reference's
    ``processPending`` drains "until only recurring tasks remain"
    (Cluster.java:215-228)."""

    def __init__(self):
        self._heap: List[Tuple[int, int, Callable]] = []
        self._seq = 0
        self.now_micros = 0
        self._live_nonrecurring = 0

    def add(self, at_micros: int, task: Callable[[], None],
            recurring: bool = False) -> "PendingQueue._Entry":
        entry = PendingQueue._Entry(max(at_micros, self.now_micros), self._seq, task,
                                    recurring, self)
        self._seq += 1
        if not recurring:
            self._live_nonrecurring += 1
        heapq.heappush(self._heap, entry)
        return entry

    def add_after(self, delay_micros: int, task: Callable[[], None],
                  recurring: bool = False):
        return self.add(self.now_micros + delay_micros, task, recurring)

    def pop(self) -> Optional[Callable]:
        while self._heap:
            entry = heapq.heappop(self._heap)
            if entry.cancelled:
                continue
            entry.popped = True
            if not entry.recurring:
                self._live_nonrecurring -= 1
                assert self._live_nonrecurring >= 0, \
                    "PendingQueue idle accounting went negative (double decrement)"
            self.now_micros = max(self.now_micros, entry.at)
            return entry.task
        return None

    def has_nonrecurring(self) -> bool:
        return self._live_nonrecurring > 0

    def __len__(self):
        return sum(1 for e in self._heap if not e.cancelled)

    class _Entry:
        __slots__ = ("at", "seq", "task", "cancelled", "recurring", "popped",
                     "_queue")

        def __init__(self, at: int, seq: int, task: Callable, recurring: bool = False,
                     queue: "PendingQueue" = None):
            self.at = at
            self.seq = seq
            self.task = task
            self.cancelled = False
            self.recurring = recurring
            # set when pop() hands the task out: cancel() after that must NOT
            # decrement the live counter again — cancelling an already-run
            # one-shot (e.g. CoordinateDurabilityScheduling.stop() sweeping
            # its fired entries) double-decremented _live_nonrecurring, the
            # queue then claimed idle while real timeouts still pended,
            # run_until_idle exited early, hung bootstrap fences never timed
            # out, and pending_bootstrap never cleared (seed-7 replica
            # divergence at the final-agreement check)
            self.popped = False
            self._queue = queue

        def cancel(self):
            if not self.cancelled and not self.popped:
                self.cancelled = True
                if not self.recurring and self._queue is not None:
                    self._queue._live_nonrecurring -= 1
                    assert self._queue._live_nonrecurring >= 0, \
                        "PendingQueue idle accounting went negative (double decrement)"

        def __lt__(self, other):
            return (self.at, self.seq) < (other.at, other.seq)


def backoff_timeout_us(base_s: float, attempt: int, factor: float, max_s: float,
                       jitter_frac: float, salt: int) -> int:
    """Exponential reply-timeout backoff with DETERMINISTIC jitter: the jitter
    comes from a golden-ratio hash of (salt=msg_id, attempt), not from any
    rng — no seeded stream is consumed, so every trajectory stays replayable
    while re-arms across nodes never phase-lock."""
    t = min(base_s * (factor ** attempt), max_s)
    h = (salt * 0x9E3779B97F4A7C15 + (attempt + 1) * 0xD1B54A32D192ED03) \
        & 0xFFFFFFFFFFFFFFFF
    t *= 1.0 + jitter_frac * ((h >> 40) / float(1 << 24))
    return int(t * 1_000_000)


class SlowReplicaTracker:
    """Per-node gray-failure detector: reply-latency EWMA plus a penalty
    window after each reply timeout.  Coordinators consult ``slow_peers`` to
    route per-shard data reads around paused-but-alive peers instead of
    burning whole reply-timeout rounds on them (ReadTracker.java's slow
    ladder, fed by observed behavior instead of a static preference)."""

    __slots__ = ("cluster", "alpha", "threshold_us", "penalty_us", "ewma",
                 "slow_until")

    def __init__(self, cluster: "Cluster", alpha: float, threshold_s: float,
                 penalty_s: float):
        self.cluster = cluster
        self.alpha = alpha
        self.threshold_us = threshold_s * 1_000_000
        self.penalty_us = int(penalty_s * 1_000_000)
        self.ewma: Dict[int, float] = {}
        self.slow_until: Dict[int, int] = {}

    def record_reply(self, peer: int, latency_us: int) -> None:
        prev = self.ewma.get(peer)
        self.ewma[peer] = latency_us if prev is None \
            else prev + self.alpha * (latency_us - prev)

    def record_timeout(self, peer: int) -> None:
        self.slow_until[peer] = self.cluster.queue.now_micros + self.penalty_us

    def record_overloaded(self, peer: int) -> None:
        """An Overloaded nack (or a piggybacked load bit) from ``peer``: treat
        it like a slow peer for the overload penalty window, so coordinators
        route reads around it instead of feeding the hot node more work.
        Never shortens an existing penalty (a timeout's window stands)."""
        until = self.cluster.queue.now_micros + self.cluster.overload_penalty_us
        if until > self.slow_until.get(peer, -1):
            self.slow_until[peer] = until

    def is_slow(self, peer: int) -> bool:
        if self.ewma.get(peer, 0.0) > self.threshold_us:
            return True
        return self.cluster.queue.now_micros < self.slow_until.get(peer, -1)

    def slow_peers(self) -> frozenset:
        return frozenset(p for p in set(self.ewma) | set(self.slow_until)
                         if self.is_slow(p))


class SimScheduler(Scheduler):
    def __init__(self, queue: PendingQueue):
        self.queue = queue

    def once(self, delay_s: float, run: Callable[[], None]):
        entry = self.queue.add_after(int(delay_s * 1_000_000), run)

        class _S(Scheduler.Scheduled):
            def cancel(self_inner):
                entry.cancel()
        return _S()

    def recurring(self, interval_s, run: Callable[[], None]):
        """``interval_s`` may be a float or a zero-arg callable resampled every
        cycle (jittered cadences — breaks cross-node poll alignment that would
        otherwise make concurrent recovery attempts perpetually preempt each
        other; the reference randomizes its progress-log requeue delays)."""
        state = {"cancelled": False, "entry": None}
        next_us = (lambda: int(interval_s() * 1_000_000)) if callable(interval_s) \
            else (lambda: int(interval_s * 1_000_000))

        def fire():
            if state["cancelled"]:
                return
            run()
            state["entry"] = self.queue.add_after(next_us(), fire, recurring=True)

        state["entry"] = self.queue.add_after(next_us(), fire, recurring=True)

        class _S(Scheduler.Scheduled):
            def cancel(self_inner):
                state["cancelled"] = True
                if state["entry"] is not None:
                    state["entry"].cancel()
        return _S()


class NodeScheduler(Scheduler):
    """Per-node-incarnation scheduler facade over the cluster queue.

    Every task is gated on the node's incarnation still being live — a crashed
    node's timers, progress-log polls, epoch watchdogs and read-speculation
    beats must never fire against torn-down state.  Live one-shot entries are
    tracked so ``Cluster.crash`` can cancel them outright (keeping the queue's
    idle accounting exact: a wrapped no-op would otherwise pin
    ``has_nonrecurring`` until the dead timer's deadline).  Recurring tasks
    stop re-arming at the first post-crash fire."""

    def __init__(self, cluster: "Cluster", node_id: int, incarnation: int):
        self.cluster = cluster
        self.node_id = node_id
        self.incarnation = incarnation
        self._sim = SimScheduler(cluster.queue)
        self._entries: set = set()

    def is_live(self) -> bool:
        return (self.cluster.incarnations.get(self.node_id, 0) == self.incarnation
                and self.node_id not in self.cluster.down)

    def teardown(self) -> None:
        """Cancel every live one-shot this node scheduled (crash path)."""
        for entry in list(self._entries):
            entry.cancel()
        self._entries.clear()

    def once(self, delay_s: float, run: Callable[[], None]):
        holder = {"cancelled": False}
        prov = self.cluster._prov
        # causal provenance: the timer's parent is the activity ARMING it;
        # at fire time the bracket makes its sends/transitions children
        armed_by = prov.current() if prov is not None else None

        def guarded():
            # stop-the-world pause: the timer is DUE but the process is not
            # scheduling — park it; it late-fires (in order) at resume.  The
            # cancelled flag must be re-checked then: cancel() after the park
            # can no longer reach the popped queue entry
            if self.cluster._gate(self.node_id, guarded):
                return
            entry = holder.get("e")
            if entry is not None:
                self._entries.discard(entry)
            if not holder["cancelled"] and self.is_live():
                if prov is not None:
                    prov.begin_timer(self.node_id, armed_by,
                                     self.cluster.queue.now_micros)
                    try:
                        run()
                    finally:
                        prov.end()
                else:
                    run()

        entry = self.cluster.queue.add_after(int(delay_s * 1_000_000), guarded)
        holder["e"] = entry
        self._entries.add(entry)
        entries = self._entries

        class _S(Scheduler.Scheduled):
            def cancel(self_inner):
                holder["cancelled"] = True
                entries.discard(entry)
                entry.cancel()
        return _S()

    def recurring(self, interval_s, run: Callable[[], None]):
        """SimScheduler's resample/fire/re-arm machinery, plus the incarnation
        gate: a dead node's cadence no-ops and cancels itself at its first
        post-crash fire (one orphan re-arm, then the queue forgets it).
        While the node is PAUSED, fires coalesce: at most one parked instance
        late-fires at resume (a frozen process's periodic timer doesn't burst
        one fire per missed period)."""
        holder = {"parked": False}
        prov = self.cluster._prov
        armed_by = prov.current() if prov is not None else None

        def late_fire():
            holder["parked"] = False
            guarded()

        def guarded():
            if self.node_id in self.cluster.paused:
                if not holder["parked"]:
                    holder["parked"] = True
                    self.cluster._gate(self.node_id, late_fire)
                return
            if self.is_live():
                if prov is not None:
                    prov.begin_timer(self.node_id, armed_by,
                                     self.cluster.queue.now_micros)
                    try:
                        run()
                    finally:
                        prov.end()
                else:
                    run()
            elif holder.get("s") is not None:
                holder["s"].cancel()

        holder["s"] = self._sim.recurring(interval_s, guarded)
        return holder["s"]


class LinkConfig:
    """Per-link delivery behavior (NodeSink.Action): deliver with latency, drop,
    or deliver-then-report-failure."""

    DELIVER = "deliver"
    DROP = "drop"
    FAILURE = "failure"                  # drop AND report failure to the sender
    DELIVER_WITH_FAILURE = "deliver_with_failure"  # deliver AND report failure

    def __init__(self, rng: RandomSource, min_latency_us: int = 500,
                 max_latency_us: int = 20_000):
        self.rng = rng
        self.min_latency_us = min_latency_us
        self.max_latency_us = max_latency_us

    def action(self, from_node: int, to_node: int, message=None) -> str:
        return LinkConfig.DELIVER

    def latency_us(self, from_node: int, to_node: int) -> int:
        return self.rng.next_int(self.min_latency_us, self.max_latency_us)


class SimMessageSink(MessageSink):
    """Routes messages through the cluster queue with link behavior + reply
    correlation + caller-side timeouts (SafeCallback semantics)."""

    def __init__(self, node_id: int, cluster: "Cluster"):
        self.node_id = node_id
        self.cluster = cluster
        # msg_id -> (callback, timeout_entry, to_node, rearm_attempt, sent_at,
        #            txn_id) — txn_id attributes timeout/backoff observability
        # to the transaction's flight-recorder span (None for txn-less rounds)
        self.callbacks: Dict[int, Tuple[Callback, object, int, int, int,
                                        object]] = {}
        # gray-failure detector feeding read-speculation routing
        alpha, threshold_s, penalty_s = cluster.slow_peer_params
        self.slow_replicas = SlowReplicaTracker(cluster, alpha, threshold_s,
                                                penalty_s)

    def is_live(self) -> bool:
        """A sink belonging to a crashed (or replaced-by-restart) incarnation
        must neither send nor arm timeouts."""
        return (self.cluster.sinks.get(self.node_id) is self
                and self.node_id not in self.cluster.down)

    def teardown(self) -> None:
        """Crash path: drop every registered callback and cancel its timeout
        entry (exact idle accounting — the timers must not pin the queue)."""
        for _callback, timeout_entry, _to, _attempt, _sent, _tid in \
                self.callbacks.values():
            timeout_entry.cancel()
        self.callbacks.clear()

    def _arm_timeout(self, msg_id: int, attempt: int):
        """Arm (or re-arm) the reply timeout for ``msg_id``.  attempt 0 is the
        flat base timeout; every non-final-reply re-arm backs off
        exponentially with deterministic jitter (adaptive patience: a node
        that keeps proving liveness earns longer — but bounded — waits)."""
        cluster = self.cluster
        timeout_us = backoff_timeout_us(
            cluster.reply_timeout_s, attempt, cluster.reply_backoff_factor,
            cluster.reply_backoff_max_s, cluster.reply_backoff_jitter, msg_id)
        return cluster.queue.add_after(timeout_us, lambda: self._timeout(msg_id))

    # -- outbound -----------------------------------------------------------
    def send(self, to: int, request: Request) -> None:
        self._send(to, request, None)

    def send_with_callback(self, to: int, request: Request, callback: Callback) -> None:
        self._send(to, request, callback)

    def _send(self, to: int, request: Request, callback: Optional[Callback]) -> None:
        if not self.is_live():
            return   # a dead incarnation cannot put packets on the wire
        # cluster-global msg ids: ids stay unique across a node's crash-restart
        # boundary, so a stale reply can never correlate with a NEW callback
        msg_id = self.cluster.alloc_msg_id()
        cluster = self.cluster
        if callback is not None:
            entry = self._arm_timeout(msg_id, 0)
            self.callbacks[msg_id] = (callback, entry, to, 0,
                                      cluster.queue.now_micros,
                                      getattr(request, "txn_id", None))

        def emit():
            cluster.route(self.node_id, to, request, msg_id,
                          callback is not None)
        # journal-append stall = fsync-before-reply: a node whose durable
        # write path is stalled cannot put NEW packets on the wire (its own
        # timers above still run — the process believes it sent).  Held
        # packets drain at unstall; a crash mid-stall loses them with the
        # unsynced journal tail, so no peer ever observed non-durable state
        if to != self.node_id and cluster.journal is not None \
                and cluster.journal.is_stalled(self.node_id):
            cluster.hold_send(self.node_id, emit)
        else:
            emit()

    def reply(self, to: int, reply_context, reply: Reply) -> None:
        from ..messages.base import LOCAL_NO_REPLY
        if reply_context is LOCAL_NO_REPLY:
            return   # self-delivered local request: nothing to answer
        if not self.is_live():
            return   # dead incarnation: replies die with the process
        cluster = self.cluster
        # backpressure piggyback: stamp the reply's wire journey with this
        # replica's CURRENT overload bit (send-time state — deterministic),
        # so coordinators learn of pressure from every reply, not only from
        # the sheds.  Reply objects stay untouched (no schema change); the
        # bit rides the routing call.
        hot = False
        if cluster.backpressure_piggyback:
            node = cluster.nodes.get(self.node_id)
            adm = getattr(node, "admission", None)
            hot = adm is not None and adm.overloaded()

        def emit():
            cluster.route_reply(self.node_id, to, reply_context, reply,
                                overloaded=hot)
        if to != self.node_id and cluster.journal is not None \
                and cluster.journal.is_stalled(self.node_id):
            cluster.hold_send(self.node_id, emit)
        else:
            emit()

    # -- inbound correlation -------------------------------------------------
    def deliver_reply(self, from_node: int, msg_id: int, reply: Reply,
                      overloaded: bool = False) -> None:
        entry = self.callbacks.get(msg_id)
        if entry is None:
            return
        callback, timeout_entry, to, attempt, sent_at, tid = entry
        now = self.cluster.queue.now_micros
        # per-LEG latency (send→first reply, reply→reply): measuring from the
        # original send would fold a txn's whole dependency wait into the
        # peer's "latency" and mark healthy-but-working replicas slow
        self.slow_replicas.record_reply(from_node, now - sent_at)
        if overloaded or (isinstance(reply, FailureReply)
                          and isinstance(reply.failure, Overloaded)):
            # an explicit admission nack, or the piggybacked load bit:
            # route around this peer like a slow one for the penalty window
            self.slow_replicas.record_overloaded(from_node)
        if reply.is_final:
            timeout_entry.cancel()
            del self.callbacks[msg_id]
        elif attempt + 1 < self.cluster.reply_rearm_budget:
            # non-final reply (e.g. StableAck before a long dependency wait):
            # keep the callback registered and re-arm the timeout — backed
            # off, so a long-but-live dependency wait isn't hammered — and a
            # lost final reply still triggers the failure/retry path
            timeout_entry.cancel()
            new_entry = self._arm_timeout(msg_id, attempt + 1)
            self.callbacks[msg_id] = (callback, new_entry, to, attempt + 1,
                                      now, tid)
            if self.cluster.observer is not None:
                self.cluster.observer.on_backoff(self.node_id, tid,
                                                 attempt + 1)
        else:
            # re-arm budget exhausted — deliver the reply below but leave the
            # LAST armed timer standing; when it fires, the normal timeout
            # path reports failure and the coordinator's retry machinery
            # takes over from fresher information (bounded patience, never a
            # hang)
            self.callbacks[msg_id] = (callback, timeout_entry, to, attempt,
                                      now, tid)
        prov = self.cluster._prov
        if prov is not None:
            # causal bracket: sends the callback makes are children of this
            # reply delivery (which chains back to the original request)
            prov.begin_callback(self.node_id, msg_id, tid, now)
        try:
            if isinstance(reply, FailureReply):
                callback.on_failure(from_node, reply.failure)
            else:
                callback.on_success(from_node, reply)
        except BaseException as e:  # noqa: BLE001
            callback.on_callback_failure(from_node, e)
        finally:
            if prov is not None:
                prov.end()

    def report_failure(self, msg_id: int, to_node: int, failure: BaseException) -> None:
        if self.cluster._gate(self.node_id, lambda: self.report_failure(
                msg_id, to_node, failure)):
            return   # paused process: the failure surfaces at resume
        entry = self.callbacks.pop(msg_id, None)
        if entry is None:
            return
        callback, timeout_entry, _, _attempt, _sent, _tid = entry
        timeout_entry.cancel()
        try:
            callback.on_failure(to_node, failure)
        except BaseException as e:  # noqa: BLE001
            callback.on_callback_failure(to_node, e)

    def _timeout(self, msg_id: int) -> None:
        # a PAUSED process's timers are frozen: the timeout parks and
        # late-fires at resume (where the reply may by then have raced it in
        # — the park list preserves order, so the reply wins if it arrived
        # first, exactly like a real post-pause timer storm)
        if self.cluster._gate(self.node_id, lambda: self._timeout(msg_id)):
            return
        entry = self.callbacks.pop(msg_id, None)
        if entry is None:
            return
        callback, _timeout_entry, to, _attempt, _sent, tid = entry
        self.slow_replicas.record_timeout(to)
        if self.cluster.observer is not None:
            self.cluster.observer.on_reply_timeout(
                self.node_id, to, tid, self.cluster.queue.now_micros)
        prov = self.cluster._prov
        if prov is not None:
            # causal bracket: retries/failure handling this timeout launches
            # chain back (via msg_id) to the send that went unanswered
            prov.begin_timeout(self.node_id, msg_id, tid,
                               self.cluster.queue.now_micros)
        try:
            callback.on_failure(to, Timeout(None, f"no reply from {to}"))
        except BaseException as e:  # noqa: BLE001
            callback.on_callback_failure(to, e)
        finally:
            if prov is not None:
                prov.end()


class ReplyContext:
    __slots__ = ("reply_to", "msg_id")

    def __init__(self, reply_to: int, msg_id: int):
        self.reply_to = reply_to
        self.msg_id = msg_id


class SimConfigService(ConfigurationService):
    """Static/global epoch feed shared by all nodes (BurnTestConfigurationService
    simplified): the cluster appends topologies; every node learns them through the
    queue."""

    def __init__(self, cluster: "Cluster", node_id: int):
        self.cluster = cluster
        self.node_id = node_id
        self.listeners: List[ConfigurationService.Listener] = []
        # restart support: while set, current_topology() reports the epoch the
        # node had durably reached at crash — the restarted Node initialises
        # there and re-learns every later epoch through deliver_pending, so
        # ranges adopted while it was down go through the normal bootstrap
        # diff instead of being silently treated as first-epoch fresh space
        self.boot_cap: Optional[int] = None

    def register_listener(self, listener) -> None:
        self.listeners.append(listener)

    def current_topology(self) -> Topology:
        if self.boot_cap is not None:
            capped = self.get_topology_for_epoch(self.boot_cap)
            if capped is not None:
                return capped
        return self.cluster.topologies[-1]

    def get_topology_for_epoch(self, epoch: int) -> Optional[Topology]:
        for t in self.cluster.topologies:
            if t.epoch == epoch:
                return t
        return None

    def fetch_topology_for_epoch(self, epoch: int) -> None:
        if self.get_topology_for_epoch(epoch) is not None:
            self.cluster.queue.add_after(0, self.deliver_pending)

    def deliver_pending(self) -> None:
        """Deliver every not-yet-delivered epoch, in order (TopologyManager
        requires consecutive epochs)."""
        if self.cluster._gate(self.node_id, self.deliver_pending):
            return   # paused process: epoch learning resumes with it
        node = self.cluster.nodes.get(self.node_id)
        if node is None or node.config_service is not self:
            return   # node crashed (or this service belongs to a dead incarnation)
        while True:
            current = node.topology.current_epoch
            nxt = self.get_topology_for_epoch(current + 1) if current > 0 \
                else self.cluster.topologies[0]
            if nxt is None or (current > 0 and nxt.epoch <= current):
                return
            self.notify(nxt)
            if node.topology.current_epoch == current:
                return  # listener refused (shouldn't happen); avoid spinning

    def notify(self, topology: Topology) -> None:
        for listener in self.listeners:
            listener.on_topology_update(topology, start_sync=True)

    def acknowledge_epoch(self, ready, start_sync: bool) -> None:
        # report sync completion to all peers once the epoch is locally ready
        epoch = ready.epoch
        me = self.node_id

        def broadcast():
            cluster = self.cluster
            # ledger: a node restarting later re-learns completions it missed
            # while down (gossip-on-rejoin; the live broadcast below only
            # reaches nodes that are up right now)
            cluster.sync_ledger.setdefault(epoch, set()).add(me)
            for other in cluster.nodes.values():
                other.on_remote_sync_complete(me, epoch)
        ready.reads.add_listener(lambda v, f: broadcast())


class DelayedAgentExecutor:
    """Store executor adding a random queue delay to every task, simulating
    storage/executor latency and forcing interleavings
    (DelayedCommandStores.DelayedCommandStore, DelayedCommandStores.java:138-195)."""

    def __init__(self, agent: Agent, queue: PendingQueue, rng: RandomSource,
                 max_delay_us: int = 1_000, is_live: Optional[Callable[[], bool]] = None,
                 pause_gate: Optional[Callable[[Callable], bool]] = None):
        self.agent = agent
        self.queue = queue
        self.rng = rng
        self.max_delay_us = max_delay_us
        # crash gate: a queued store task belonging to a crashed node
        # incarnation must not run against the torn-down store
        self.is_live = is_live
        # pause gate: a queued store task of a PAUSED node parks and
        # late-fires at resume (Cluster._gate)
        self.pause_gate = pause_gate

    def execute(self, task: Callable[[], None]) -> None:
        def run():
            if self.pause_gate is not None and self.pause_gate(run):
                return
            if self.is_live is not None and not self.is_live():
                return
            try:
                task()
            except BaseException as e:  # noqa: BLE001
                self.agent.on_uncaught_exception(e)

        self.queue.add_after(self.rng.next_int(self.max_delay_us + 1), run)

    def submit(self, task: Callable[[], object]):
        from ..utils import async_ as au
        return au.of_callable(task, executor=self)


class SimAgent(Agent):
    def __init__(self, cluster: "Cluster"):
        self.cluster = cluster

    def on_uncaught_exception(self, failure: BaseException) -> None:
        self.cluster.failures.append(failure)
        raise failure

    def on_handled_exception(self, failure: BaseException) -> None:
        pass

    def pre_accept_timeout(self) -> float:
        return 1.0


class Cluster:
    """In-process multi-node Accord cluster on simulated time."""

    def __init__(self, topology: Topology, seed: int = 1, num_shards: int = 1,
                 link_config: Optional[LinkConfig] = None,
                 reply_timeout_s: float = 2.0,
                 progress_log: bool = False,
                 progress_poll_s: float = 0.5,
                 extra_nodes: Optional[List[int]] = None,
                 delayed_stores: bool = False,
                 clock_drift: bool = False,
                 journal: bool = False,
                 resolver: Optional[str] = None,
                 batch_window_us: int = 0,
                 node_config=None,
                 observer=None,
                 profiler=None):
        self.rng = RandomSource(seed)
        self.queue = PendingQueue()
        self.scheduler = SimScheduler(self.queue)
        self.topologies: List[Topology] = [topology]
        # message trace hook: fn(event, from, to, msg_id, message, now_micros)
        # where event is the link action taken or "REPLY"/"REPLY_<action>"
        # (the reference's accord.impl.basic.Trace logger, Cluster.java:237-264)
        self.tracer: Optional[Callable] = None
        # flight recorder (observe.FlightRecorder): passive metrics/span hooks
        # fed from the same sites as the tracer plus the lifecycle planes;
        # MUST have zero observer effect (no RNG, no wall clock, no scheduling)
        self.observer = observer
        # causal provenance recorder (observe/provenance.py), riding the
        # observer: the execution-context brackets below (reply callbacks,
        # timeouts, node timers, crash/restart) feed it directly — pure
        # bookkeeping, same zero-observer-effect contract as the observer
        self._prov = getattr(observer, "provenance", None) \
            if observer is not None else None
        # wall-clock profiler (observe.WallProfiler): times handler CPU and
        # event-loop occupancy.  Reads wall clocks ONLY — it must never
        # touch RNG, sim scheduling, or the message path, so the recorder
        # trace stays byte-identical with it on vs off (tests/test_profiler)
        self.profiler = profiler
        if observer is not None and hasattr(observer, "attach_cluster"):
            # the InvariantAuditor reads cluster state (node epochs, the
            # epoch-sync ledger) passively for its monotonicity rules
            observer.attach_cluster(self)
        # controllable-delivery hook (MockCluster/Network capability,
        # impl/mock/MockCluster.java): fn(from, to, request, msg_id,
        # has_callback) -> True to swallow (the hook owns delivery/reply)
        self.request_filter: Optional[Callable] = None
        self.link = link_config or LinkConfig(self.rng.fork())
        self.reply_timeout_s = reply_timeout_s
        # request-delivery coalescing: requests arriving at a node within
        # ``batch_window_us`` sim-time are processed as one batch, letting the
        # device resolver answer the whole window's deps queries in ONE fused
        # launch (TpuDepsResolver.prefetch).  0 = deliver individually.  This
        # models a real accelerator-serving node's request coalescing; it only shifts
        # delivery times by <= the window, which is legal network behavior.
        self.batch_window_us = batch_window_us
        self._inboxes: Dict[int, List] = {}
        self._inbox_drain_at: Dict[int, Optional[int]] = {}
        self._inbox_seq = 0
        self._next_msg_id = 0
        self.failures: List[BaseException] = []
        self.stats: Dict[str, int] = {}
        self.nodes: Dict[int, Node] = {}
        self.sinks: Dict[int, SimMessageSink] = {}
        self.stores: Dict[int, ListStore] = {}
        self.journal = None
        # crash-restart lifecycle: currently-down node ids, per-node
        # incarnation counters (bumped at crash, so every queued delivery /
        # timer belonging to the dead incarnation is invalidated), durable
        # restart metadata captured at crash, and the epoch-sync ledger a
        # restarted node replays on rejoin
        self.down: set = set()
        self.incarnations: Dict[int, int] = {}
        self._crash_info: Dict[int, dict] = {}
        # gray-failure lifecycle: stop-the-world paused node ids, their parked
        # (popped-but-frozen) tasks that late-fire in order at resume, a
        # per-node pause generation (a stale resume timer must not end a
        # NEWER pause), and outbound packets held by a journal-append stall
        # (fsync-before-reply: a stalled disk mutes the node's sends)
        self.paused: set = set()
        self._parked: Dict[int, List[Callable]] = {}
        self._pause_epochs: Dict[int, int] = {}
        self._held_sends: Dict[int, List[Callable]] = {}
        self._stall_epochs: Dict[int, int] = {}
        # adaptive-timeout + gray-failure knobs (LocalConfig; env-overridable)
        from ..config import LocalConfig
        _cfg = node_config if node_config is not None else LocalConfig.from_env()
        self.reply_backoff_factor = _cfg.reply_backoff_factor
        self.reply_backoff_max_s = _cfg.reply_backoff_max_s
        self.reply_backoff_jitter = _cfg.reply_backoff_jitter
        self.reply_rearm_budget = _cfg.reply_rearm_budget
        self.slow_peer_params = (_cfg.slow_peer_ewma_alpha,
                                 _cfg.slow_peer_latency_threshold_s,
                                 _cfg.slow_peer_penalty_s)
        self.journal_corruption_policy = _cfg.journal_corruption_policy
        # overload plane (local/overload.py): how long an Overloaded nack (or
        # a piggybacked load bit) marks the peer slow, and whether replies
        # carry the bit at all — piggyback only matters when admission is on
        # (off by default: the reply path stays bit-for-bit untouched)
        self.overload_penalty_us = int(_cfg.overload_penalty_s * 1_000_000)
        self.backpressure_piggyback = (_cfg.backpressure_piggyback
                                       and _cfg.admission_enabled)
        # catch-up ranges a restart has accepted but not yet handed to
        # Bootstrap (the +1us relaunch task): a second crash inside that
        # window must re-inherit them, not forget the data holes
        self._pending_catchup: Dict[int, object] = {}
        self.sync_ledger: Dict[int, set] = {}
        # fired with the freshly-rebuilt Node after every restart (the burn
        # re-applies per-node wiring: durability scheduling, store flags)
        self.on_restart_hooks: List[Callable] = []
        self._plf = None
        if progress_log:
            from ..impl.progress_log import progress_log_factory
            self._plf = progress_log_factory(progress_poll_s)
        self.agent = SimAgent(self)
        self._num_shards = num_shards
        self._delayed_stores = delayed_stores
        self._clock_drift = clock_drift
        self._resolver = resolver
        self._node_config = node_config
        # elastic-membership lifecycle: nodes drained out of every shard by
        # ``decommission`` (still live, serving prior epochs until they
        # retire) and hooks fired with each freshly-added Node (the burn
        # re-applies per-node wiring, like on_restart_hooks)
        self.decommissioned: set = set()
        self.on_add_hooks: List[Callable] = []
        # per-node clock drift (FrequentLargeRange nowSupplier, BurnTest:329-339)
        self.clock_offsets: Dict[int, int] = {}
        for node_id in sorted(set(topology.nodes()) | set(extra_nodes or ())):
            self.stores[node_id] = ListStore(node_id)
            self.nodes[node_id] = self._make_node(node_id)
            if clock_drift:
                self._start_drift(node_id)
        if journal:
            from .journal import Journal
            self.journal = Journal()
            # append-time clock: the torn-write injector's acked-record
            # soundness gate needs to know how old the tail append is
            self.journal.now_us = lambda: self.queue.now_micros
            for node in self.nodes.values():
                for store in node.command_stores.all_stores():
                    self.journal.attach(store)
        # chaos link configs re-randomize themselves off the cluster queue
        if hasattr(self.link, "attach"):
            self.link.attach(self)

    def alloc_msg_id(self) -> int:
        self._next_msg_id += 1
        return self._next_msg_id

    def _trace(self, event: str, frm: int, to: int, msg_id, message) -> None:
        """Report one message-plane event to the trace hook and the flight
        recorder (both passive; the sim's behavior must not depend on them)."""
        if self.tracer is not None:
            self.tracer(event, frm, to, msg_id, message, self.queue.now_micros)
        if self.observer is not None:
            self.observer.on_message_event(event, frm, to, msg_id, message,
                                           self.queue.now_micros)

    def _make_node(self, node_id: int, boot_epoch: Optional[int] = None) -> Node:
        """Construct one Node (initial boot or restart).  ``boot_epoch`` caps
        the topology the node initialises with (the epoch it had durably
        reached at crash); later epochs stream in via deliver_pending."""
        incarnation = self.incarnations.get(node_id, 0)
        sink = SimMessageSink(node_id, self)
        self.sinks[node_id] = sink
        store = self.stores[node_id]
        svc = SimConfigService(self, node_id)
        scheduler = NodeScheduler(self, node_id, incarnation)
        executor_factory = None
        if self._delayed_stores:
            exec_rng = self.rng.fork()
            is_live = scheduler.is_live
            pause_gate = (lambda nid: (lambda task: self._gate(nid, task)))(node_id)
            executor_factory = (lambda rng: (lambda i: DelayedAgentExecutor(
                self.agent, self.queue, rng.fork(), is_live=is_live,
                pause_gate=pause_gate)))(exec_rng)
        svc.boot_cap = boot_epoch
        try:
            node = Node(
                node_id, sink, svc, self.agent,
                scheduler, store, self.rng.fork(),
                now_micros=(lambda nid: (lambda: self.queue.now_micros
                                         + self.clock_offsets.get(nid, 0)))(node_id),
                num_shards=self._num_shards,
                executor_factory=executor_factory,
                progress_log_factory=self._plf,
                resolver=self._resolver,
                config=self._node_config)
        finally:
            svc.boot_cap = None
        # flight-recorder wiring (survives restarts: every rebuilt incarnation
        # reports into the same run-wide recorder); the wall profiler rides
        # the same lifecycle
        node.observer = self.observer
        node.profiler = self.profiler
        return node

    # -- pause lifecycle (the pause nemesis substrate) ------------------------
    def _gate(self, node_id: int, task: Callable[[], None]) -> bool:
        """Park ``task`` if ``node_id`` is stop-the-world paused.  Returns
        True when parked (the caller must NOT run); parked tasks late-fire in
        park order at ``resume``.  Idle-accounting note: a parked task was
        already popped (counter decremented) and resume re-adds it as a fresh
        entry (counter incremented) — the queue's live accounting stays exact
        across the pause, the PR-1 cancel() bug class's pause analog."""
        if node_id in self.paused:
            self._parked.setdefault(node_id, []).append(task)
            return True
        return False

    def pause(self, node_id: int) -> int:
        """Stop the node's world: scheduler, sinks, store executors and
        timers freeze (tasks park as they come due); inbound messages queue.
        Peers observe only silence — the node is slow, not dead.  Returns a
        pause generation token for ``resume``."""
        assert node_id in self.nodes and node_id not in self.down, \
            f"node {node_id} is not live"
        assert node_id not in self.paused, f"node {node_id} is already paused"
        self.paused.add(node_id)
        epoch = self._pause_epochs.get(node_id, 0) + 1
        self._pause_epochs[node_id] = epoch
        self._count("node_pauses")
        return epoch

    def resume(self, node_id: int, token: Optional[int] = None) -> None:
        """End a pause: every parked task re-enqueues at NOW, in park order —
        all frozen timers late-fire, violating every timeout assumption at
        once (the post-GC-pause timer storm).  ``token`` guards a stale
        resume timer against ending a newer pause."""
        if node_id not in self.paused:
            return
        if token is not None and self._pause_epochs.get(node_id) != token:
            return
        self.paused.discard(node_id)
        for task in self._parked.pop(node_id, []):
            self.queue.add_after(0, task)
        self._count("node_resumes")

    # -- journal-append stalls (the disk-stall nemesis substrate) -------------
    def hold_send(self, node_id: int, emit: Callable[[], None]) -> None:
        """Buffer an outbound packet of a journal-stalled node (the send path
        blocks on fsync).  Drains at ``unstall_journal``; dies with the
        process at ``crash`` — alongside the unsynced journal tail, so no
        peer ever observed state the crash un-persisted."""
        self._held_sends.setdefault(node_id, []).append(emit)

    def stall_journal(self, node_id: int) -> int:
        """Start a journal-append stall: durability (and every outbound
        packet — fsync-before-reply) lags execution until unstall.  Returns a
        stall generation token."""
        assert self.journal is not None, "disk stalls require the journal"
        assert node_id in self.nodes and node_id not in self.down, \
            f"node {node_id} is not live"
        self.journal.stall(node_id)
        epoch = self._stall_epochs.get(node_id, 0) + 1
        self._stall_epochs[node_id] = epoch
        self._count("journal_stalls")
        return epoch

    def unstall_journal(self, node_id: int, token: Optional[int] = None) -> None:
        """The append path caught up: buffered records become durable and the
        held outbound packets hit the wire (in order)."""
        if self.journal is None or not self.journal.is_stalled(node_id):
            return
        if token is not None and self._stall_epochs.get(node_id) != token:
            return
        self.journal.unstall(node_id)
        for emit in self._held_sends.pop(node_id, []):
            self.queue.add_after(0, emit)

    # -- crash-restart lifecycle (the crash-restart nemesis substrate) --------
    def crash(self, node_id: int) -> None:
        """Kill a node mid-flight: its in-memory command stores, per-key
        indexes, device mirrors, message callbacks and timers are destroyed
        and messages in flight to it are dropped.  The durable stores — the
        journal and the data files (ListStore) — survive for ``restart``."""
        assert node_id in self.nodes and node_id not in self.down, \
            f"node {node_id} is not live"
        assert self.journal is not None, \
            "crash-restart requires the journal (the restart store of record)"
        assert self._num_shards == 1, \
            "restart replay keys journal logs by store id; multi-store range " \
            "assignment is not stable across a restart boundary"
        node = self.nodes.pop(node_id)
        self.down.add(node_id)
        # a paused process dies parked: its frozen timers/deliveries die with
        # it (they were already popped, so accounting stays exact)
        self.paused.discard(node_id)
        self._parked.pop(node_id, None)
        # crash during a journal-append stall: the unsynced tail is gone, and
        # so are the outbound packets fsync was holding — no peer ever saw
        # the state those records carried
        self._held_sends.pop(node_id, None)
        lost = self.journal.lose_unsynced(node_id)
        if lost:
            self.stats["journal_unsynced_lost"] = \
                self.stats.get("journal_unsynced_lost", 0) + lost
        # invalidate every queued delivery/timer addressed to this incarnation
        self.incarnations[node_id] = self.incarnations.get(node_id, 0) + 1
        # durable restart metadata (real nodes persist bootstrap progress
        # markers: losing them would let a half-bootstrapped replica serve
        # reads over ranges it never fetched).  Data-store stale marks are
        # held by VOLATILE heal machinery that dies with the process, so the
        # marked ranges re-enter the catch-up ladder at restart instead.
        data = self.stores[node_id]
        pending = data.stale_ranges
        for cs in node.command_stores.all_stores():
            pending = pending.union(cs.pending_bootstrap)
        # debt the previous restart never got to hand to Bootstrap (crashed
        # again before its relaunch task fired): still owed after this crash
        leftover = self._pending_catchup.pop(node_id, None)
        if leftover is not None:
            pending = pending.union(leftover)
        self._crash_info[node_id] = {
            "epoch": node.topology.current_epoch,
            "pending": pending,
        }
        data._stale_marks.clear()
        # tear down volatile machinery without corrupting idle accounting:
        # progress-log polls, node timers, reply callbacks + their timeouts
        for cs in node.command_stores.all_stores():
            close = getattr(cs.progress_log, "close", None)
            if close is not None:
                close()
        if isinstance(node.scheduler, NodeScheduler):
            node.scheduler.teardown()
        self.sinks[node_id].teardown()
        # purge the request-coalescing inbox (those messages were in RAM)
        self._inboxes.pop(node_id, None)
        self._inbox_drain_at.pop(node_id, None)
        if self._prov is not None:
            # fault-ins are first-class causal events: an injected crash is
            # often the true origin of a divergence yet emits no trace byte
            self._prov.on_crash(node_id, self.queue.now_micros)
        if self.observer is not None:
            # the auditor re-baselines the node's lifecycle state here: the
            # journal replay at restart legitimately re-observes commands at
            # their durable tier, below whatever the volatile state reached
            self.observer.on_crash(node_id)
        self._count("node_crashes")

    def restart(self, node_id: int, lose_tail: int = 0) -> Node:
        """Bring a crashed node back: reconstruct every command store from its
        journal (volatile execution state is lost — commands resume from
        their durable tier, STABLE / PRE_APPLIED), re-register with the
        topology service, replay the epoch-sync ledger, and re-enter the
        bootstrap catch-up ladder for ranges whose fetch the crash killed.
        ``lose_tail`` optionally drops the last N journal records per store
        first (unsynced-tail loss experiments; NOT sound for promises)."""
        assert node_id in self.down, f"node {node_id} is not down"
        info = self._crash_info.pop(node_id)
        if lose_tail:
            for sid in range(self._num_shards):
                self.journal.drop_tail(node_id, sid, lose_tail)
        self.down.discard(node_id)
        node = self._make_node(node_id, boot_epoch=info["epoch"])
        self.nodes[node_id] = node
        # topology metadata is durable on a real node: re-install every epoch
        # below the boot epoch BEFORE journal replay — replay's waiting_on
        # re-derivation judges each dep's participation against the ranges the
        # store owned AT THE DEP'S EPOCH (ranges_at), and an unknown old epoch
        # reads as "never owned", silently dropping the dep from the execution
        # frontier (seed-0 replica divergence: a later write applied over an
        # unapplied earlier one).  Also keeps precise_epochs answerable for
        # old transactions (client probes, recovery).
        for topo in sorted(self.topologies, key=lambda t: t.epoch, reverse=True):
            if topo.epoch < node.topology.min_epoch:
                node.topology.reload_prior_epoch(
                    topo, self.sync_ledger.get(topo.epoch))
                node.command_stores.update_topology(topo)
        from ..local import commands as C
        from ..local.command_store import CommandStore, SafeCommandStore
        from ..primitives.keys import Ranges as _Ranges
        quarantine = _Ranges.EMPTY
        for cs in node.command_stores.all_stores():
            self.journal.attach(cs)
            # verified replay: every record re-checked against its CRC32; a
            # torn tail truncates to the last whole record; mid-log
            # corruption halts loudly or quarantines per the configured
            # policy (LocalConfig.journal_corruption_policy)
            replay = self.journal.restart_replay(
                node_id, cs.id, policy=self.journal_corruption_policy)
            if replay.torn_tail_dropped:
                self.stats["journal_torn_records"] = \
                    self.stats.get("journal_torn_records", 0) \
                    + replay.torn_tail_dropped
            damaged = dict(replay.quarantined)

            def on_damaged(txn_id, command, problem, cs=cs, damaged=damaged):
                # a record that PASSED checksum but decoded to inconsistent
                # state (replay-side damage): quarantine it like a corrupt
                # record — drop its journal entries, bootstrap its footprint
                self.journal.erase_key(node_id, cs.id, txn_id)
                damaged[txn_id] = command.route

            # synchronous replay (process start blocks on journal replay),
            # under the store's logical-thread discipline
            prev, CommandStore._current = CommandStore._current, cs
            try:
                safe = SafeCommandStore(cs)
                C.replay_journal(safe, replay.commands, on_damaged=on_damaged)
                for txn_id in replay.quarantined:
                    # knowledge LOST, not absent: the tombstone answers
                    # "truncated/unknowable" — a quarantined replica that
                    # answers "never witnessed" hands recovery/inference a
                    # false proof (an applied txn was invalidated with it)
                    C.install_quarantine_tombstone(safe, txn_id)
            finally:
                CommandStore._current = prev
            if damaged:
                self.stats["journal_quarantined_txns"] = \
                    self.stats.get("journal_quarantined_txns", 0) + len(damaged)
                for txn_id, route in damaged.items():
                    if route is None:
                        # no surviving record names a route: route is set at
                        # the FIRST transition (preaccept), so a route-less
                        # txn never progressed past a stub — no writes can
                        # have landed, the tombstone alone suffices.  (A
                        # whole-store fallback here bootstrapped [k0,k1000)
                        # mid-churn and recreated the seed-6 refencing stall.)
                        continue
                    parts = route.participants()
                    if not isinstance(parts, _Ranges):
                        parts = parts.to_ranges()
                    quarantine = quarantine.union(parts)
            resume = getattr(cs.progress_log, "resume_after_restart", None)
            if resume is not None:
                resume()
        # stream the epochs the node missed while down (adoption diffs fire
        # normal bootstraps), then replay sync completions peers broadcast
        self.queue.add_after(0, node.config_service.deliver_pending)
        for epoch in sorted(self.sync_ledger):
            for n in sorted(self.sync_ledger[epoch]):
                if n != node_id:
                    node.on_remote_sync_complete(n, epoch)
        pending = info["pending"]
        if len(quarantine):
            # quarantined footprints re-enter the bootstrap catch-up ladder:
            # the replica treats the affected ranges as never-fetched and
            # streams them fresh from peers (quarantine-and-bootstrap)
            pending = pending.union(quarantine)
        if pending:
            self._pending_catchup[node_id] = pending

            def relaunch():
                from ..local.bootstrap import Bootstrap
                cur = self.nodes.get(node_id)
                if cur is not node:
                    return   # crashed again: crash() re-inherited the debt
                self._pending_catchup.pop(node_id, None)
                for cs in node.command_stores.all_stores():
                    mine = pending.intersection(cs.all_ranges()) \
                        .without(cs.pending_bootstrap)
                    if mine:
                        Bootstrap(node, cs, mine, node.epoch(),
                                  catch_up=True).start()
            # after deliver_pending so ownership reflects the live topology
            self.queue.add_after(1, relaunch)
        for hook in list(self.on_restart_hooks):
            hook(node)
        if self._prov is not None:
            self._prov.on_restart(node_id, self.queue.now_micros)
        if self.observer is not None:
            # replay is complete: the auditor resumes normal edge checking
            # for this node (post-restart traffic takes live paths again)
            self.observer.on_restart(node_id)
        self._count("node_restarts")
        return node

    def _start_drift(self, node_id: int) -> None:
        """Random-walk clock drift: small 50µs-5ms jumps, occasional 1-10ms
        large jumps (BurnTest.java:329-339 FrequentLargeRange)."""
        rng = self.rng.fork()

        def jump():
            if rng.next_float() < 0.1:
                delta = rng.next_int(1_000, 10_000)
            else:
                delta = rng.next_int(50, 5_000)
            # drift forward or back, but never behind real sim time
            off = self.clock_offsets.get(node_id, 0)
            off += delta if rng.next_boolean() else -delta
            self.clock_offsets[node_id] = max(0, off)

        self.scheduler.recurring(0.05, jump)

    # -- elastic membership (join / decommission) -----------------------------
    def add_node(self, node_id: int) -> Node:
        """Spin up a brand-new process mid-run: fresh (empty) data store,
        fresh Node initialised at the CURRENT epoch.  The node owns nothing
        until a topology change gives it shards — its adoption diff then
        runs the normal bootstrap ladder (fence sync point + data fetch)
        against the live peers, exactly like any freshly-adopted range.
        Joining is therefore ``add_node`` + a join epoch (TopologyRandomizer
        ``join`` / MembershipNemesis), never a special data path."""
        assert node_id not in self.nodes and node_id not in self.down, \
            f"node {node_id} already exists"
        self.stores[node_id] = ListStore(node_id)
        node = self._make_node(node_id)
        self.nodes[node_id] = node
        if self._clock_drift:
            self._start_drift(node_id)
        if self.journal is not None:
            for store in node.command_stores.all_stores():
                self.journal.attach(store)
        self.decommissioned.discard(node_id)
        for hook in list(self.on_add_hooks):
            hook(node)
        self._count("node_joins")
        return node

    def decommission(self, node_id: int,
                     choose_replacement: Optional[Callable] = None) -> Optional[Topology]:
        """Remove ``node_id`` from EVERY shard of the latest topology in one
        new epoch (the hand-off): each vacated slot is filled by a live
        member (``choose_replacement(shard, candidates) -> node`` overrides
        the default least-loaded pick).  NOTE: this manual API applies NO
        clean-readable-quorum floor — the seeded schedules
        (TopologyRandomizer._leave / MembershipNemesis) layer that check on
        top; a direct caller draining a node whose shards are already
        mid-bootstrap elsewhere is asking for expected unavailability.
        The process stays LIVE — it keeps
        serving prior-epoch reads, recovery evidence and bootstrap fetches
        until those epochs retire; the new replicas bootstrap their adopted
        ranges from it and its peers through the normal ladder.  Returns the
        new topology, or None when some shard has no replacement candidate
        (every live node already replicates it)."""
        current = self.topologies[-1]
        if not current.contains_node(node_id):
            self.decommissioned.add(node_id)
            return None   # already out of every shard: just mark drained
        new_shards = self.plan_handoff(
            list(current.shards), node_id,
            candidate_pool=[n for n in sorted(self.nodes)
                            if n != node_id and n not in self.down
                            and n not in self.decommissioned],
            choose_replacement=choose_replacement)
        if new_shards is None:
            return None
        topology = Topology(current.epoch + 1, new_shards)
        self.update_topology(topology)
        self.decommissioned.add(node_id)
        self._count("node_decommissions")
        return topology

    def plan_handoff(self, shards: List[Shard], leaver: int,
                     candidate_pool: List[int],
                     choose_replacement: Optional[Callable] = None,
                     shard_ok: Optional[Callable] = None) -> Optional[List[Shard]]:
        """The shared hand-off planner behind ``decommission`` and the
        randomizer's ``leave`` mutation: replace ``leaver`` in every shard
        with a candidate (``choose_replacement(shard, candidates)``
        overrides the default least-loaded pick), optionally vetoing each
        substituted shard via ``shard_ok(new_shard, pick)`` (the
        randomizer's clean-readable-quorum floor).  Returns the full new
        shard list, or None when any shard has no acceptable candidate —
        the plan is all-or-nothing."""
        load: Dict[int, int] = {}
        for shard in shards:
            for n in shard.nodes:
                load[n] = load.get(n, 0) + 1
        out: List[Shard] = []
        for shard in shards:
            if leaver not in shard.nodes:
                out.append(shard)
                continue
            candidates = [n for n in candidate_pool if n not in shard.nodes]
            if not candidates:
                return None
            if choose_replacement is not None:
                pick = choose_replacement(shard, candidates)
            else:
                pick = min(candidates, key=lambda n: (load.get(n, 0), n))
            new_shard = Shard(shard.range,
                              [pick if n == leaver else n for n in shard.nodes])
            if shard_ok is not None and not shard_ok(new_shard, pick):
                return None
            load[pick] = load.get(pick, 0) + 1
            out.append(new_shard)
        return out

    # -- topology change -----------------------------------------------------
    def update_topology(self, new_topology: Topology) -> None:
        """Advance the cluster to a new epoch: every node learns it after a
        random delay (epoch propagation skew), in epoch order."""
        assert new_topology.epoch == self.topologies[-1].epoch + 1, \
            f"epoch must advance by 1: {self.topologies[-1].epoch} -> {new_topology.epoch}"
        self.topologies.append(new_topology)
        for node_id in sorted(self.nodes):
            delay = self.rng.next_int(200, 5000)
            svc = self.nodes[node_id].config_service
            self.queue.add_after(delay, svc.deliver_pending)

    # -- message routing ----------------------------------------------------
    def route(self, from_node: int, to_node: int, request: Request, msg_id: int,
              has_callback: bool) -> None:
        self._count(f"{type(request).__name__}")
        if self.request_filter is not None and \
                self.request_filter(from_node, to_node, request, msg_id,
                                    has_callback):
            return
        if to_node in self.down:
            # connection refused: the sender observes it as a link failure
            self._trace("DOWN", from_node, to_node, msg_id, request)
            if has_callback:
                self.queue.add_after(
                    self.link.latency_us(from_node, to_node),
                    lambda: self.sinks[from_node].report_failure(
                        msg_id, to_node,
                        ConnectionError(f"node {to_node} is down")))
            return
        action = self.link.action(from_node, to_node, request) if from_node != to_node \
            else LinkConfig.DELIVER
        self._trace(action.upper(), from_node, to_node, msg_id, request)
        if action in (LinkConfig.DROP, LinkConfig.FAILURE):
            if action == LinkConfig.FAILURE and has_callback:
                self.queue.add_after(
                    self.link.latency_us(from_node, to_node),
                    lambda: self.sinks[from_node].report_failure(
                        msg_id, to_node, ConnectionError(f"link {from_node}->{to_node}")))
            return
        latency = 0 if from_node == to_node else self.link.latency_us(from_node, to_node)
        ctx = ReplyContext(from_node, msg_id)
        if self.batch_window_us > 0:
            self._inbox_deliver(to_node, request, from_node, ctx, latency)
        else:
            inc = self.incarnations.get(to_node, 0)
            self.queue.add_after(latency, lambda: self._deliver(
                to_node, request, from_node, ctx, inc))
        if action == LinkConfig.DELIVER_WITH_FAILURE and has_callback:
            self.queue.add_after(
                self.link.latency_us(from_node, to_node),
                lambda: self.sinks[from_node].report_failure(
                    msg_id, to_node, ConnectionError(f"link {from_node}->{to_node}")))

    def _deliver(self, to_node: int, request: Request, from_node: int,
                 ctx: "ReplyContext", incarnation: Optional[int] = None) -> None:
        if to_node in self.down or (
                incarnation is not None
                and incarnation != self.incarnations.get(to_node, 0)):
            return   # the TCP connection died with the target's process
        if self._gate(to_node, lambda: self._deliver(
                to_node, request, from_node, ctx, incarnation)):
            return   # paused process: the packet queues in its socket buffer
        node = self.nodes.get(to_node)
        if node is None:
            return
        self._trace("RECV", from_node, to_node, ctx.msg_id, request)
        node.receive(request, from_node, ctx)

    def route_reply(self, from_node: int, to_node: int, reply_context: ReplyContext,
                    reply: Reply, overloaded: bool = False) -> None:
        self._count(f"{type(reply).__name__}")
        action = self.link.action(from_node, to_node, reply) if from_node != to_node \
            else LinkConfig.DELIVER
        self._trace(f"RPLY_{action.upper()}", from_node, to_node,
                    reply_context.msg_id, reply)
        if action in (LinkConfig.DROP, LinkConfig.FAILURE):
            return
        if to_node in self.down:
            return   # replies to a down node vanish with its connections
        latency = 0 if from_node == to_node else self.link.latency_us(from_node, to_node)
        inc = self.incarnations.get(to_node, 0)

        def deliver():
            if to_node in self.down or inc != self.incarnations.get(to_node, 0):
                return  # the recipient crashed while the reply was in flight
            if self._gate(to_node, deliver):
                return  # paused recipient: the reply queues until resume
            self._trace("RECV_RPLY", from_node, to_node,
                        reply_context.msg_id, reply)
            self.sinks[to_node].deliver_reply(from_node, reply_context.msg_id,
                                              reply, overloaded=overloaded)
        self.queue.add_after(latency, deliver)

    def _count(self, key: str) -> None:
        self.stats[key] = self.stats.get(key, 0) + 1

    # -- request-delivery coalescing (batch_window_us) ------------------------
    def _inbox_deliver(self, to_node: int, request: Request, from_node: int,
                       ctx: "ReplyContext", latency: int) -> None:
        arrival = self.queue.now_micros + latency
        self._inboxes.setdefault(to_node, []).append(
            (arrival, self._inbox_seq, request, from_node, ctx))
        self._inbox_seq += 1
        due = arrival + self.batch_window_us
        scheduled = self._inbox_drain_at.get(to_node)
        # also RE-schedule when this arrival precedes the pending drain: a
        # fast link's message must never wait out a slow link's window (no
        # message is held longer than its own arrival + window; the stale
        # later drain fires harmlessly on whatever remains)
        if scheduled is None or due < scheduled:
            self._inbox_drain_at[to_node] = due
            self.queue.add_after(due - self.queue.now_micros,
                                 lambda: self._drain_inbox(to_node))

    def _drain_inbox(self, to_node: int) -> None:
        """Process every request that has arrived at ``to_node`` by now, as one
        batch: prefetch the batch's declared deps queries per store (one fused
        device launch each), then run the handlers sequentially in arrival
        order — exact sequential semantics, batched device traffic."""
        if self._gate(to_node, lambda: self._drain_inbox(to_node)):
            return   # paused process: the batch drains at resume
        box = self._inboxes.get(to_node, [])
        now = self.queue.now_micros
        ready = sorted(e for e in box if e[0] <= now)
        rest = [e for e in box if e[0] > now]
        self._inboxes[to_node] = rest
        self._inbox_drain_at[to_node] = None
        if rest:
            due = min(e[0] for e in rest) + self.batch_window_us
            self._inbox_drain_at[to_node] = due
            self.queue.add_after(due - now, lambda: self._drain_inbox(to_node))
        if not ready:
            return
        node = self.nodes.get(to_node)
        if node is None:
            return
        # even a batch of one PreAccept gains: its deps + max-conflict consults
        # fuse into a single launch instead of two
        per_store: Dict[object, List] = {}
        with_specs = []
        for entry in ready:
            specs = entry[2].prefetch_specs(node)
            with_specs.append((entry, bool(specs)))
            for store, spec in specs or ():
                per_store.setdefault(store, []).append(spec)
        # deps-query-bearing requests drain FIRST: a Commit/Apply processed
        # mid-window moves the covering bounds and invalidates the window's
        # prefetched answers, so serve the queries before advancing state.
        # Reordering within the window is legal network behavior (it is
        # indistinguishable from jitter below the coalescing latency), and
        # the (priority, arrival, seq) key keeps it deterministic.
        with_specs.sort(key=lambda p: (not p[1], p[0][0], p[0][1]))
        for store, specs in per_store.items():
            engine = getattr(store, "batch_engine", None)
            if engine is not None:
                # columnar ingress accounting: the delivery window IS the
                # per-tick batch the engine's ConsultBatch bridge packs
                # (protocol_batch/engine.consult_ingress); counted here so
                # the ramp bench can report rows-per-window amortization
                engine.stats["ingress_windows"] += 1
                engine.stats["ingress_rows"] += len(specs)
            store.resolver.prefetch(specs)
        try:
            for (_at, _seq, request, frm, ctx), _h in with_specs:
                self._trace("RECV", frm, to_node, ctx.msg_id, request)
                node.receive(request, frm, ctx)
        finally:
            for store in per_store:
                store.resolver.end_batch()

    # -- execution ----------------------------------------------------------
    def run_until_idle(self, max_tasks: int = 1_000_000) -> int:
        """Drain the queue until only recurring tasks remain; returns tasks
        executed. Raises any node failure."""
        n = 0
        profiler = self.profiler
        while n < max_tasks and self.queue.has_nonrecurring():
            task = self.queue.pop()
            if task is None:
                break
            if profiler is not None:
                t0 = profiler.now()
                task()
                profiler.on_task(profiler.now() - t0, len(self.queue._heap))
            else:
                task()
            n += 1
            if self.failures:
                raise self.failures[0]
        return n

    def run_until(self, predicate: Callable[[], bool], max_tasks: int = 1_000_000) -> bool:
        n = 0
        profiler = self.profiler
        while n < max_tasks:
            if predicate():
                return True
            task = self.queue.pop()
            if task is None:
                return predicate()
            if profiler is not None:
                # event-loop occupancy plane: per-task wall cost + pending-
                # queue depth (len of the raw heap is O(1); the cancelled-
                # entry overcount is fine for a depth distribution)
                t0 = profiler.now()
                task()
                profiler.on_task(profiler.now() - t0, len(self.queue._heap))
            else:
                task()
            n += 1
            if self.failures:
                raise self.failures[0]
        return predicate()

    def run_for(self, sim_seconds: float, max_tasks: int = 1_000_000) -> None:
        """Advance simulated time by ``sim_seconds``, executing everything due."""
        deadline = self.queue.now_micros + int(sim_seconds * 1_000_000)
        self.run_until(lambda: self.queue.now_micros >= deadline, max_tasks)

    @property
    def now_micros(self) -> int:
        return self.queue.now_micros
