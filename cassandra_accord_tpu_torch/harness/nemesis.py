"""The gray-failure nemeses: kill, pause and disk-stall nodes mid-burn.

Capability parity with the reference burn's node-restart axis (BurnTest's
journal-backed restarts) plus the in-between regimes its
``SimulatedDelayedExecutorService`` and journal machinery exercise — the
failures that are NOT fail-stop:

- ``RestartNemesis``: seeded kills + journal-replay rebuilds
  (``Cluster.crash``/``restart``), now with crash-time journal damage
  injection — torn tail records and bit flips the restart replay must
  detect (checksums) and absorb (truncate / quarantine-and-bootstrap).
- ``PauseNemesis``: stop-the-world process pauses (GC pause, VM migration,
  SIGSTOP): the victim's scheduler, sinks, executors and timers freeze, then
  resume with every frozen timer late-firing — peers observe silence from a
  node that is slow, NOT dead, violating every timeout assumption.
- ``DiskStallNemesis``: journal-append stalls (fsync latency spikes):
  durability — and with it every outbound packet, fsync-before-reply —
  lags execution; a crash mid-stall loses the whole unsynced tail.

Safety rails (LocalConfig knobs): at most ``restart_max_down`` nodes down
(and ``pause_max_paused`` paused) at once, and a victim is only eligible if
every shard it replicates keeps a live slow-path quorum counting every
MUTED node — down, paused, or journal-stalled — as unavailable (see
``muted_nodes``); without that shared floor, stalls are expected rather
than bugs.  The default cadences (20s / 15s / 17s) are deliberately
de-aligned AND sized so the three axes COMBINED inject roughly the fault
rate the single-axis restart matrix ran at: fault rate has to stay below
the bootstrap/recovery heal rate, or the burn degenerates into a
perpetually-bootstrapping cluster and the watchdog reports the (expected)
unavailability as a stall.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..topology.topology import Topology
from ..utils.random import RandomSource
from .cluster import Cluster


def muted_nodes(cluster: Cluster) -> set:
    """Every node currently unable to answer its peers: down, stop-the-world
    paused, or journal-stalled (fsync-before-reply holds its packets).  The
    quorum floor of EVERY nemesis counts all three — the fault axes are
    independent, and without a shared floor their overlap mutes whole
    quorums, producing *expected* stalls the watchdog reports as bugs."""
    muted = cluster.down | cluster.paused
    if cluster.journal is not None:
        muted |= {n for n in cluster.nodes if cluster.journal.is_stalled(n)}
    return muted


def quorum_safe(cluster: Cluster, node_id: int, unavailable) -> bool:
    """Would making ``node_id`` unavailable leave every shard it replicates —
    in EVERY installed epoch, not only the latest — with a live slow-path
    quorum?  Old epochs matter: a txn coordinated or recovered against a
    pre-churn shard still needs that shard's quorum until the epoch retires,
    so checking only ``topologies[-1]`` would let two fault axes take out two
    members of an old shard and produce an *expected* stall the watchdog then
    reports as a bug.  (Conservative: epochs whose txns have all settled are
    still counted.)"""
    would_down = set(unavailable) | {node_id}
    for topology in cluster.topologies:
        for shard in topology.shards:
            if node_id in shard.nodes:
                live = sum(1 for n in shard.nodes if n not in would_down)
                if live < shard.slow_path_quorum_size:
                    return False
    return True


class RestartNemesis:
    """One per burn; schedule driven by the cluster's deterministic queue."""

    def __init__(self, cluster: Cluster, rng: RandomSource,
                 interval_s: float = 20.0,
                 downtime_min_s: float = 2.0, downtime_max_s: float = 12.0,
                 max_down: int = 1, keep_quorum: bool = True,
                 torn_tail_chance: float = 0.0,
                 corrupt_chance: float = 0.0,
                 on_crash: Optional[Callable[[int], None]] = None,
                 on_restart: Optional[Callable[[object], None]] = None):
        self.cluster = cluster
        self.rng = rng
        self.interval_s = interval_s
        self.downtime_min_s = downtime_min_s
        self.downtime_max_s = max(downtime_max_s, downtime_min_s)
        self.max_down = max_down
        self.keep_quorum = keep_quorum
        # crash-time journal damage: probability the crash tears the tail
        # record (partial append) / bit-flips a random record (bit rot)
        self.torn_tail_chance = torn_tail_chance
        self.corrupt_chance = corrupt_chance
        self.on_crash = on_crash
        self.on_restart = on_restart
        self.stopped = False
        self._task = None

    def attach(self) -> None:
        """Register the jittered crash cadence (never aligned with the chaos
        re-roll interval: each gap is resampled in [0.5, 1.5) x interval)."""
        rng = self.rng

        def gap():
            return self.interval_s * (0.5 + rng.next_float())

        self._task = self.cluster.scheduler.recurring(gap, self._tick)

    # -- the schedule --------------------------------------------------------
    def _tick(self) -> None:
        if self.stopped or len(self.cluster.down) >= self.max_down:
            return
        victim = self._pick_victim()
        if victim is None:
            return
        self.cluster.crash(victim)
        self._inject_journal_damage(victim)
        if self.on_crash is not None:
            self.on_crash(victim)
        downtime = self.downtime_min_s + self.rng.next_float() * (
            self.downtime_max_s - self.downtime_min_s)
        self.cluster.scheduler.once(downtime, lambda: self._restart(victim))

    def _inject_journal_damage(self, victim: int) -> None:
        """Seeded post-crash damage to the victim's durable log — what the
        restart replay's checksum verification must catch."""
        journal = self.cluster.journal
        if journal is None:
            return
        if self.torn_tail_chance and self.rng.next_float() < self.torn_tail_chance:
            # age gate = the minimum link latency: a record older than that
            # may have been ACKED to a peer (fsync-before-reply) and tearing
            # it would roll back a promise the protocol assumes stable —
            # injection unsoundness, not a fault model
            torn = journal.tear_tail_record(
                victim, self.rng,
                max_age_us=self.cluster.link.min_latency_us)
            if torn:
                self.cluster.stats["journal_injected_tears"] = \
                    self.cluster.stats.get("journal_injected_tears", 0) + torn
        if self.corrupt_chance and self.rng.next_float() < self.corrupt_chance:
            if journal.corrupt_random_record(victim, self.rng) is not None:
                self.cluster.stats["journal_injected_bitflips"] = \
                    self.cluster.stats.get("journal_injected_bitflips", 0) + 1

    def _pick_victim(self) -> Optional[int]:
        candidates = []
        unavailable = muted_nodes(self.cluster)
        for node_id in sorted(self.cluster.nodes):
            if node_id in self.cluster.down:
                continue
            if self.keep_quorum and not quorum_safe(self.cluster, node_id,
                                                    unavailable):
                continue
            candidates.append(node_id)
        return self.rng.pick(candidates) if candidates else None

    def _restart(self, node_id: int) -> None:
        if node_id not in self.cluster.down:
            return   # already restored (stop_and_restore raced the timer)
        node = self.cluster.restart(node_id)
        if self.on_restart is not None:
            self.on_restart(node)

    # -- quiesce -------------------------------------------------------------
    def stop_and_restore(self) -> None:
        """Stop crashing and bring every down node back (burn quiesce: the
        final agreement checks need the full replica set live and caught up)."""
        self.stopped = True
        if self._task is not None:
            self._task.cancel()
        for node_id in sorted(self.cluster.down):
            self._restart(node_id)


class MembershipNemesis:
    """Elastic membership under load: seeded join (``Cluster.add_node`` + a
    join epoch through the randomizer's elastic mutations) and decommission
    (``Cluster.decommission`` — hand-off + removal from every shard in one
    epoch) cycles, holding the member count inside
    [``min_members``, ``max_members``].

    Floors shared with every other nemesis: joins/leaves respect the
    randomizer's clean-readable-quorum-per-range check (a newcomer counts
    unavailable until its bootstrap fetch lands), leaves additionally
    require every affected shard to keep a live slow-path quorum counting
    MUTED nodes (down / paused / journal-stalled) unavailable, and the whole
    schedule is gated on outstanding bootstraps like topology churn — a
    membership change is a bootstrap storm by construction, and stacking
    them outruns the heal rate into expected (reported-as-stall)
    unavailability."""

    def __init__(self, cluster: Cluster, rng: RandomSource,
                 randomizer, interval_s: float = 25.0,
                 min_members: Optional[int] = None,
                 max_members: Optional[int] = None,
                 spawn_pool: Optional[list] = None,
                 on_join: Optional[Callable[[int], None]] = None,
                 on_leave: Optional[Callable[[int], None]] = None):
        self.cluster = cluster
        self.rng = rng
        self.randomizer = randomizer
        self.interval_s = interval_s
        initial = len(cluster.topologies[-1].nodes())
        self.min_members = min_members if min_members is not None \
            else max(3, initial - 1)
        self.max_members = max_members if max_members is not None \
            else initial + max(2, initial // 2)
        if spawn_pool:
            self.randomizer.spawn_pool = sorted(
                set(self.randomizer.spawn_pool) | set(spawn_pool))
        # both membership planes honor the same bounds: the churn-mix
        # join/leave actions otherwise bypass membership_{min,max}_members
        self.randomizer.min_members = self.min_members
        self.randomizer.max_members = self.max_members
        self.on_join = on_join
        self.on_leave = on_leave
        self.joins = 0
        self.leaves = 0
        self.stopped = False
        self._task = None

    def attach(self) -> None:
        rng = self.rng

        def gap():
            return self.interval_s * (0.5 + rng.next_float())

        self._task = self.cluster.scheduler.recurring(gap, self._tick)

    def _tick(self) -> None:
        cluster = self.cluster
        if self.stopped:
            return
        # same bootstrap gate as topology churn: a membership change while
        # many ranges are mid-bootstrap stacks fetch load the cluster is
        # already struggling to drain
        pending = {rng for node in cluster.nodes.values()
                   for cs in node.command_stores.all_stores()
                   for rng in (cs.pending_bootstrap or ())}
        if len(pending) > 3:
            return
        current = cluster.topologies[-1]
        members = sorted(current.nodes())
        want_join = len(members) <= self.min_members or (
            len(members) < self.max_members and self.rng.next_boolean())
        shards = list(current.shards)
        if want_join:
            new_shards = self.randomizer._join(shards, current)
            if new_shards is None:
                return
            topo = Topology(current.epoch + 1, new_shards)
            cluster.update_topology(topo)
            self.joins += 1
            joined = sorted(topo.nodes() - current.nodes())
            if self.on_join is not None and joined:
                self.on_join(joined[0])
        else:
            new_shards = self.randomizer._leave(shards, current)
            if new_shards is None:
                return
            topo = Topology(current.epoch + 1, new_shards)
            cluster.update_topology(topo)
            self.leaves += 1
            left = sorted(current.nodes() - topo.nodes())
            if self.on_leave is not None and left:
                self.on_leave(left[0])

    def stop(self) -> None:
        """Stop scheduling membership changes (burn quiesce).  Drained nodes
        stay live — the final agreement checks judge the LAST topology's
        replica sets, and prior epochs still need their members."""
        self.stopped = True
        if self._task is not None:
            self._task.cancel()


class PauseNemesis:
    """Stop-the-world process pauses at seeded, jittered points: the victim's
    scheduler, sinks, store executors and timers freeze (``Cluster.pause``);
    at resume every frozen timer and buffered delivery late-fires in order —
    the post-GC-pause timer storm.  Peers observe only silence: the node is
    slow, NOT dead, which is exactly the regime flat timeouts misclassify."""

    def __init__(self, cluster: Cluster, rng: RandomSource,
                 interval_s: float = 15.0,
                 pause_min_s: float = 0.5, pause_max_s: float = 4.0,
                 max_paused: int = 1, keep_quorum: bool = True,
                 on_pause: Optional[Callable[[int], None]] = None,
                 on_resume: Optional[Callable[[int], None]] = None):
        self.cluster = cluster
        self.rng = rng
        self.interval_s = interval_s
        self.pause_min_s = pause_min_s
        self.pause_max_s = max(pause_max_s, pause_min_s)
        self.max_paused = max_paused
        self.keep_quorum = keep_quorum
        self.on_pause = on_pause
        self.on_resume = on_resume
        self.stopped = False
        self._task = None

    def attach(self) -> None:
        rng = self.rng

        def gap():
            return self.interval_s * (0.5 + rng.next_float())

        self._task = self.cluster.scheduler.recurring(gap, self._tick)

    def _tick(self) -> None:
        cluster = self.cluster
        if self.stopped or len(cluster.paused) >= self.max_paused:
            return
        unavailable = muted_nodes(cluster)
        candidates = []
        for node_id in sorted(cluster.nodes):
            if node_id in unavailable:
                continue
            if self.keep_quorum and not quorum_safe(cluster, node_id,
                                                    unavailable):
                continue
            candidates.append(node_id)
        if not candidates:
            return
        victim = self.rng.pick(candidates)
        token = cluster.pause(victim)
        if self.on_pause is not None:
            self.on_pause(victim)
        duration = self.pause_min_s + self.rng.next_float() * (
            self.pause_max_s - self.pause_min_s)
        cluster.scheduler.once(duration, lambda: self._resume(victim, token))

    def _resume(self, node_id: int, token: int) -> None:
        # token-guarded: if the node crashed (clearing the pause) and was
        # paused AGAIN since, this stale timer must not cut the new pause short
        if node_id in self.cluster.paused:
            self.cluster.resume(node_id, token)
            if node_id not in self.cluster.paused and self.on_resume is not None:
                self.on_resume(node_id)

    def stop_and_restore(self) -> None:
        """Resume every paused node (burn quiesce)."""
        self.stopped = True
        if self._task is not None:
            self._task.cancel()
        for node_id in sorted(self.cluster.paused):
            self.cluster.resume(node_id)


class LoadSpikeNemesis:
    """Deterministic offered-load schedule for open-loop burns: a list of
    ``(start_s, rate_mult)`` phases, each armed as ONE absolute sim-time
    timer that sets the workload's ``rate_mult``.  Unlike the gray-failure
    nemeses this one is fully deterministic — no RNG, no jitter — because
    the overload oracle compares goodput ACROSS multipliers, and a jittered
    phase boundary would smear the measurement windows.

    ``phase_of(now_s)`` reports which phase a given sim-instant falls in, so
    the burn can bucket per-op outcomes by phase (the burst-recovery check
    needs pre/burst/post goodput separately)."""

    def __init__(self, cluster: Cluster, workload, phases):
        # phases: iterable of (start_s, rate_mult), start_s ascending
        self.cluster = cluster
        self.workload = workload
        self.phases = sorted((float(s), float(m)) for s, m in phases)
        assert all(m > 0.0 for _, m in self.phases), \
            "rate multipliers must be positive"
        self.transitions = 0
        self.stopped = False
        self._tasks = []

    def attach(self) -> None:
        now_s = self.cluster.queue.now_micros / 1e6
        for start_s, mult in self.phases:
            delay = start_s - now_s
            if delay <= 0.0:
                self._enter(mult)
                continue
            self._tasks.append(self.cluster.scheduler.once(
                delay, lambda m=mult: self._enter(m)))

    def _enter(self, mult: float) -> None:
        if self.stopped:
            return
        self.workload.rate_mult = mult
        self.transitions += 1
        self.cluster.stats["load_phase_transitions"] = \
            self.cluster.stats.get("load_phase_transitions", 0) + 1

    def phase_of(self, now_s: float) -> int:
        """Index of the phase containing ``now_s`` (-1 before the first)."""
        idx = -1
        for i, (start_s, _mult) in enumerate(self.phases):
            if now_s >= start_s:
                idx = i
        return idx

    def stop(self) -> None:
        """Freeze the schedule (burn quiesce): pending phase timers no-op."""
        self.stopped = True
        for task in self._tasks:
            cancel = getattr(task, "cancel", None)
            if cancel is not None:
                cancel()


class DiskStallNemesis:
    """Journal-append stalls at seeded, jittered points
    (``Cluster.stall_journal``): the victim keeps executing but nothing it
    writes becomes durable — and nothing it SENDS leaves the box
    (fsync-before-reply) — until the stall ends.  A crash landing inside the
    stall window (the restart nemesis runs independently) loses the whole
    unsynced journal tail, strictly more than ``drop_tail`` ever simulated,
    and the held packets with it — so peers never witnessed the lost state."""

    def __init__(self, cluster: Cluster, rng: RandomSource,
                 interval_s: float = 17.0,
                 stall_min_s: float = 1.0, stall_max_s: float = 6.0,
                 keep_quorum: bool = True,
                 on_stall: Optional[Callable[[int], None]] = None):
        assert cluster.journal is not None, \
            "disk stalls require the journal (the stalled device)"
        self.cluster = cluster
        self.rng = rng
        self.interval_s = interval_s
        self.stall_min_s = stall_min_s
        self.stall_max_s = max(stall_max_s, stall_min_s)
        # a stalled journal MUTES the node (fsync-before-reply): it needs the
        # same quorum floor as crashes and pauses, or overlapping fault axes
        # mute whole quorums (measured: seed 1 x 250 ops with all three axes
        # re-created the seed-6 bootstrap-refencing stall)
        self.keep_quorum = keep_quorum
        self.on_stall = on_stall
        self.stopped = False
        self._task = None

    def attach(self) -> None:
        rng = self.rng

        def gap():
            return self.interval_s * (0.5 + rng.next_float())

        self._task = self.cluster.scheduler.recurring(gap, self._tick)

    def _tick(self) -> None:
        cluster = self.cluster
        if self.stopped:
            return
        unavailable = muted_nodes(cluster)
        candidates = [n for n in sorted(cluster.nodes)
                      if n not in unavailable
                      and (not self.keep_quorum
                           or quorum_safe(cluster, n, unavailable))]
        if not candidates:
            return
        victim = self.rng.pick(candidates)
        token = cluster.stall_journal(victim)
        if self.on_stall is not None:
            self.on_stall(victim)
        duration = self.stall_min_s + self.rng.next_float() * (
            self.stall_max_s - self.stall_min_s)
        cluster.scheduler.once(duration,
                               lambda: cluster.unstall_journal(victim, token))

    def stop_and_restore(self) -> None:
        """Unstall every journal (burn quiesce: everything becomes durable
        and the held packets drain)."""
        self.stopped = True
        if self._task is not None:
            self._task.cancel()
        for node_id in sorted(self.cluster.nodes):
            if self.cluster.journal.is_stalled(node_id):
                self.cluster.unstall_journal(node_id)
