"""The burn test: randomized workloads on the deterministic cluster, verified for
strict serializability.

Capability parity with ``accord.burn.BurnTest`` (BurnTest.java:123-622): one seed
fully determines topology (rf, node count, key count), the randomized client workload
(read/write/read-write txns over 1-3 keys, zipf-or-uniform key choice), concurrency
window, link latencies and faults; every client op feeds the verifier; any violation
or unresolved op fails the run with its seed.

Hostile mode (``chaos=True``) adds the reference's full fault model: per-link
behavior (drop / failure / latency spikes) and minority partitions re-randomized
every 5s of sim-time (impl/basic/Cluster.java:455-459), with the progress log
driving recovery and the client resolving lost responses through home-shard
CheckStatus probes classified Applied/Invalidated/Truncated/Lost
(impl/list/ListRequest.java:61-150).  Every op must still resolve; the verifier
constrains acked ops fully, requires invalidated writes to never surface, and
leaves lost ops unconstrained.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..coordinate.errors import CoordinationFailed, Invalidated, Overloaded
from ..impl.list_store import ListResult, list_txn, range_read_txn
from ..local.status import SaveStatus, Status
from ..primitives.keys import IntKey, Range, Ranges
from ..topology.topology import Shard, Topology
from ..utils.random import RandomSource
from .cluster import Cluster, LinkConfig
from .verifier import HistoryViolation, Observation, StrictSerializabilityVerifier


class BurnResult:
    def __init__(self, seed: int):
        self.seed = seed
        self.ops_submitted = 0
        self.ops_ok = 0          # acked with result
        self.ops_recovered = 0   # resolved Applied via client CheckStatus probe
        self.ops_nacked = 0      # durably invalidated
        self.ops_lost = 0        # resolved Lost/Truncated (outcome unknown)
        self.ops_failed = 0      # unexpected failure
        self.crashes = 0         # nemesis node kills
        self.restarts = 0        # journal-replay rebuilds
        self.pauses = 0          # stop-the-world process pauses
        self.disk_stalls = 0     # journal-append stalls
        self.joins = 0           # elastic membership: nodes joined mid-burn
        self.leaves = 0          # elastic membership: decommissions mid-burn
        # overload plane (PR-17): sheds count into ops_failed too (they ARE
        # client-visible fast failures) — this is the attribution split
        self.ops_shed = 0        # client-entry admission sheds (subset of failed)
        self.overload_nacks = 0  # replica-side Overloaded nacks sent
        self.budget_denied = 0   # retry-budget token denials
        self.paced_arrivals = 0  # open-loop arrivals drawn while AIMD-paced
        self.pace_downs = 0      # AIMD pace-down events
        self.sim_micros = 0
        self.stats: Dict[str, int] = {}
        self.audit: Optional[dict] = None   # InvariantAuditor verdict, if on
        self.history: Optional[dict] = None  # history-checker report, if on

    @property
    def resolved(self) -> int:
        return (self.ops_ok + self.ops_recovered + self.ops_nacked
                + self.ops_lost + self.ops_failed)

    def __repr__(self):
        restarts = f", restarts={self.restarts}" if self.restarts else ""
        pauses = f", pauses={self.pauses}" if self.pauses else ""
        stalls = f", disk_stalls={self.disk_stalls}" if self.disk_stalls else ""
        joins = f", joins={self.joins}" if self.joins else ""
        leaves = f", leaves={self.leaves}" if self.leaves else ""
        shed = f", shed={self.ops_shed}" if self.ops_shed else ""
        return (f"BurnResult(seed={self.seed}, ok={self.ops_ok}, "
                f"recovered={self.ops_recovered}, nacked={self.ops_nacked}, "
                f"lost={self.ops_lost}, failed={self.ops_failed}{shed}"
                f"{restarts}{pauses}{stalls}{joins}{leaves}, "
                f"sim_ms={self.sim_micros // 1000})")


class SimulationException(Exception):
    """Wraps any failure with its seed so the run can be replayed
    (BurnTest.java:588)."""

    def __init__(self, seed: int, cause: BaseException):
        super().__init__(f"burn seed={seed} failed: {cause}")
        self.seed = seed
        self.cause = cause
        self.audit = None   # InvariantAuditor verdict at failure, if audited


MAX_PROBE_ATTEMPTS = 1000   # ListRequest.java:204 "arbitrarily large limit"


def last_cluster():
    """The most recent run's Cluster while it is still alive (debug/forensics)."""
    ref = getattr(run_burn, "last_cluster_ref", None)
    return ref() if ref is not None else None


def verify_frontiers(cluster) -> int:
    """Frontier parity (SURVEY §7 stage 8): the kernel-computed execution
    frontier (kahn_frontier over the resolver's mirrored wait graph) must
    equal the event-driven WaitingOn state on every store.  Valid at
    quiescent points (between tasks, no deferred store executors).  Returns
    stores checked."""
    from ..impl.resolver import VerifyDepsResolver
    from ..local.cfk import InternalStatus
    from ..utils.invariants import check_state
    stable_i = int(InternalStatus.STABLE)
    checked = 0
    for node in cluster.nodes.values():
        for store in node.command_stores.all_stores():
            r = store.resolver
            if not isinstance(r, VerifyDepsResolver):
                continue
            tpu = r.tpu
            dev = tpu.frontier_ready()
            host = set()
            for tid, cmd in store.commands.items():
                m = tpu.txns.get(tid)
                if m is None or m.status != stable_i \
                        or cmd.save_status.is_truncated:
                    continue
                if cmd.waiting_on is not None and not cmd.waiting_on.is_waiting():
                    host.add(tid)
            check_state(dev == host,
                        "frontier parity violation on node %s store %s: "
                        "device-only=%s host-only=%s", node.id, store.id,
                        sorted(dev - host), sorted(host - dev))
            checked += 1
    return checked


def run_burn(seed: int, ops: int = 200, concurrency: int = 10,
             link_config: Optional[LinkConfig] = None,
             nodes: Optional[int] = None, rf: Optional[int] = None,
             key_count: Optional[int] = None, num_shards: int = 1,
             allow_failures: bool = False,
             topology_churn: bool = False,
             churn_interval_s: float = 1.0,
             elastic_membership: bool = False,
             delayed_stores: bool = False,
             clock_drift: bool = False,
             journal: bool = False,
             resolver: Optional[str] = None,
             chaos: bool = False,
             chaos_interval_s: float = 5.0,
             progress_log: Optional[bool] = None,
             progress_poll_s: float = 0.5,
             durability: bool = False,
             batch_window_us: int = 0,
             cache_miss: bool = False,
             frontier_exec: bool = False,
             restart_nodes: bool = False,
             pause_nodes: bool = False,
             disk_stall: bool = False,
             stall_watchdog_s: Optional[float] = None,
             columnar: Optional[str] = None,
             node_config=None,
             max_tasks: int = 20_000_000,
             tracer=None, on_submit=None, consult_recorder=None,
             observer=None,
             profiler=None,
             provenance=None,
             perturb=None,
             audit: str = "off",
             audit_slo_s: Optional[float] = None,
             check: str = "off",
             history_recorder=None,
             workload=None,
             rate_txn_s: float = 25.0,
             load_phases=None,
             control_timeout_s: float = 60.0,
             progress_every_s: Optional[float] = None,
             progress_label: str = "") -> BurnResult:
    """Run one seeded burn; raises SimulationException on any violation.

    ``chaos=True`` turns on the hostile network (randomized drops, failures,
    latency spikes, minority partitions) + client retry; the progress log is
    then mandatory for liveness and defaults on.

    ``restart_nodes=True`` adds the crash-restart nemesis (harness/nemesis.py):
    seeded node kills + journal-replay rebuilds, cadence/downtime/concurrency
    from LocalConfig (``node_config`` or env) — including crash-time journal
    damage injection (torn tails, bit flips) the restart replay must detect
    and absorb.  Requires ``journal=True``.

    ``elastic_membership=True`` adds the membership nemesis
    (harness/nemesis.py MembershipNemesis): seeded join (a fresh process
    spawned mid-run bootstraps its ranges from live peers) and decommission
    (hand-off: removed from every shard in one epoch; the drained process
    stays live for prior epochs) cycles, plus join/leave actions in the
    topology-churn mutation mix — all respecting the muted-quorum floor and
    the randomizer's per-range clean-readable-quorum floor.

    ``pause_nodes=True`` adds the pause nemesis: seeded stop-the-world
    process pauses; every frozen timer late-fires at resume.

    ``disk_stall=True`` adds the disk-stall nemesis: journal-append stalls
    (durability + outbound packets lag execution); a crash mid-stall loses
    the unsynced tail.  Requires ``journal=True``.

    ``stall_watchdog_s``: raise StallError with a full wait-graph dump after
    this much sim-time without a resolved op (None disables).

    ``observer``: an ``observe.FlightRecorder`` — records the metrics
    registry, per-txn lifecycle spans (submit/resolve, fast/slow path,
    recovery attribution, per-node status timelines) and message events for
    Chrome-trace export.  ZERO observer effect: a same-seed run with and
    without one yields byte-identical message traces (proven by
    tests/test_observe.py).

    ``profiler``: an ``observe.WallProfiler`` — the WALL-CLOCK plane
    (per-message-type handler CPU, event-loop occupancy + queue depth,
    device-service launch breakdown).  Explicitly outside the determinism
    contract (its numbers differ run to run) but equally forbidden from
    perturbing the sim: the recorder trace stays byte-identical with it on
    vs off (tests/test_profiler.py).

    ``progress_every_s``: heartbeat — print one progress line (ops resolved,
    in-flight, fast-path share) per this many SIM-seconds, so long seed
    sweeps aren't silent until the watchdog fires.

    ``audit``: ``"strict"`` / ``"warn"`` / ``"off"`` — run the online
    protocol-invariant auditor (observe/audit.py) over the same hooks the
    flight recorder uses.  ``strict`` raises AuditViolation (wrapped in
    SimulationException) at the first violated invariant; ``warn`` records
    violations into ``result.audit``.  Either way ``result.audit`` carries
    the per-run verdict (violations, SLO flags).  ``audit_slo_s`` overrides
    the unattended-txn liveness budget (sim-seconds).  The auditor IS a
    FlightRecorder, so ``observer`` must be left None (one is created) or
    already be an InvariantAuditor.

    ``check``: ``"history"`` records the client-visible operation history
    (observe/history.py — invoke/ok/fail/info per op, observed version lists
    per key) and runs the protocol-blind Elle-style checker
    (observe/checker.py) over it after final state is judged.  Any named
    anomaly (G0/G1c/G-single/G2/lost-update/non-repeatable-read/...) raises
    through SimulationException with the offending sub-history; a clean run
    stores the report on ``result.history``.  Composes with ``audit``
    (independent oracles).  Recording is a passive sink — zero observer
    effect, proven by tests/test_history_checker.py.

    ``workload``: None keeps the classic inline generator (byte-identical
    trajectories for every existing seed); a preset name
    (``multirange``/``zipf``/``openloop``) or a ``harness.workload.Workload``
    instance switches generation to that shape.  ``rate_txn_s`` sets the
    openloop Poisson arrival rate (sim txn/s); openloop ignores the
    ``concurrency`` window.  ``control_timeout_s``: barrier/sync-point ops
    (multirange) have no txn id the client could probe, so an unresolved
    control op resolves as lost after this much sim-time.

    ``load_phases``: open-loop offered-load schedule — a list of
    ``(start_sim_s, rate_mult)`` phases driven by the deterministic
    LoadSpikeNemesis (the overload ramp/burst presets).  Requires an
    open-loop workload.  Per-phase goodput lands in
    ``result.stats["load_phase{i}_ok"]``.

    ``provenance``: an ``observe.ProvenanceRecorder`` — records the per-run
    causal event DAG (observe/provenance.py) for divergence forensics and
    violation slicing.  Attached to the observer (one is created if needed);
    zero observer effect like every other attachment.

    ``perturb``: a callable ``(cluster) -> None`` invoked once after cluster
    construction — the mutation-test injection point (schedule an extra
    fault-in, delay a timer).  It must not consume cluster RNG at call time,
    so the trajectory stays byte-identical until the scheduled perturbation
    fires.
    """
    from ..config import LocalConfig
    if audit not in ("off", "strict", "warn"):
        raise ValueError(f"audit must be off/strict/warn, got {audit!r}")
    if check not in ("off", "history"):
        raise ValueError(f"check must be off/history, got {check!r}")
    history_rec = history_recorder
    if check == "history" and history_rec is None:
        from ..observe.history import HistoryRecorder
        history_rec = HistoryRecorder()
    if audit != "off":
        from ..observe.audit import InvariantAuditor
        if observer is None:
            observer = InvariantAuditor(mode=audit,
                                        slo_unattended_s=audit_slo_s,
                                        provenance=provenance)
        elif isinstance(observer, InvariantAuditor):
            observer.mode = audit
        else:
            raise ValueError("audit requires the observer to be an "
                             "InvariantAuditor (or None — one is created); "
                             "got a plain FlightRecorder")
    if provenance is not None:
        if observer is None:
            from ..observe import FlightRecorder
            observer = FlightRecorder(record_messages=False,
                                      provenance=provenance)
        else:
            # attach (idempotent for the auto-created auditor above): the
            # cluster reads observer.provenance at construction
            observer.provenance = provenance
    rng = RandomSource(seed)
    rf = rf if rf is not None else rng.pick([3, 3, 5])
    n_nodes = nodes if nodes is not None else rng.next_int(rf, 2 * rf)
    key_count = key_count if key_count is not None else rng.next_int(5, 21)
    node_ids = list(range(1, n_nodes + 1))
    if restart_nodes:
        assert journal, "restart_nodes requires journal=True (the restart " \
                        "store of record)"
        assert num_shards == 1, \
            "restart_nodes requires num_shards=1: restart replay keys " \
            "journal logs by store id, and multi-store range assignment " \
            "is not stable across a restart boundary"
    cfg = node_config if node_config is not None else LocalConfig.from_env()
    if progress_log is None:
        # recovery must be live whenever coordinators can die mid-flight —
        # and whenever admission control can NACK a PreAccept: the nack is a
        # partial failure (some replicas witnessed the txn), and only the
        # progress log settles the orphan the rest of the deps graph
        # blocks behind
        progress_log = chaos or restart_nodes or cfg.admission_enabled
    if columnar is not None:
        # the columnar protocol engine knob (protocol_batch/): auto|on|off.
        # By the exact-skip contract the knob NEVER changes a trajectory —
        # same-seed runs on-vs-off are byte-identical (tests/
        # test_protocol_batch.py) — so overriding it here is always safe
        from dataclasses import replace as _dc_replace
        cfg = _dc_replace(cfg, columnar=columnar)
        node_config = cfg

    # shard the key space into rf-replicated ranges over the nodes
    n_ranges = max(1, n_nodes // max(1, rf // 2))
    bound = 1000
    step = bound // n_ranges
    shards = []
    for i in range(n_ranges):
        start, end = i * step, bound if i == n_ranges - 1 else (i + 1) * step
        replicas = [node_ids[(i + j) % n_nodes] for j in range(rf)]
        shards.append(Shard(Range(IntKey(start), IntKey(end)), replicas))
    topology = Topology(1, shards)

    if chaos and link_config is None:
        from .chaos import RandomizedLinkConfig
        link_config = RandomizedLinkConfig(rng.fork(), rf,
                                           interval_s=chaos_interval_s)
    cluster = Cluster(topology, seed=rng.next_long(), num_shards=num_shards,
                      link_config=link_config, delayed_stores=delayed_stores,
                      clock_drift=clock_drift, journal=journal,
                      resolver=resolver, progress_log=progress_log,
                      progress_poll_s=progress_poll_s,
                      batch_window_us=batch_window_us,
                      node_config=node_config,
                      observer=observer, profiler=profiler)
    cluster.tracer = tracer
    if perturb is not None:
        # mutation-test injection: the callable may only SCHEDULE work (an
        # extra crash, a delayed timer) — the extra queue entry shifts later
        # seq numbers uniformly, so the trajectory is untouched until the
        # perturbation actually fires
        perturb(cluster)
    if consult_recorder is not None:
        # trace-driven data-plane bench (harness/consult_trace.py): wrap every
        # store's resolver so the full mutation+query stream is captured
        for node in cluster.nodes.values():
            for cs in node.command_stores.all_stores():
                consult_recorder.wrap_store(cs)
    # debugging handle (stall forensics): weak, so finished runs don't pin the
    # whole cluster graph in a module global
    import weakref
    run_burn.last_cluster_ref = weakref.ref(cluster)
    member_ids = sorted(cluster.nodes)  # nodes actually replicating some shard
    churn_task = None
    randomizer = None
    # elastic membership: node ids the run may SPAWN mid-burn (joins beyond
    # the initial member set); candidate set covers spawned nodes too
    spawn_pool = list(range(n_nodes + 1, n_nodes + 1 + max(2, n_nodes // 2))) \
        if elastic_membership else []
    if topology_churn or elastic_membership:
        # random topology mutations at a fixed sim-time cadence
        # (Cluster.java:461, TopologyRandomizer.maybeUpdateTopology); with
        # elastic membership the mutation mix grows join/leave actions
        from .topology_randomizer import TopologyRandomizer
        randomizer = TopologyRandomizer(cluster, rng.fork(),
                                        elastic=elastic_membership,
                                        spawn_pool=spawn_pool)
        if topology_churn:
            churn_task = cluster.scheduler.recurring(
                churn_interval_s, randomizer.maybe_update_topology)
    durability_scheduling: Dict[int, object] = {}
    if durability:
        # scheduled durability + truncation running DURING the burn, with
        # randomized cadences (Cluster.java:429-445)
        from ..impl.durability_scheduling import CoordinateDurabilityScheduling
        shard_cycle = float(rng.next_biased_int(5, 15, 45))
        global_cycle = float(rng.next_biased_int(10, 30, 90))

        def start_durability(node):
            sched = CoordinateDurabilityScheduling(
                node, shard_cycle_time_s=shard_cycle,
                global_cycle_time_s=global_cycle)
            sched.start()
            durability_scheduling[node.id] = sched

        for node in cluster.nodes.values():
            start_durability(node)
        # a restarted node gets a fresh scheduling instance (the old one's
        # timers died with its incarnation); a JOINED node gets one too
        cluster.on_restart_hooks.append(start_durability)
        cluster.on_add_hooks.append(start_durability)
    cache_miss_task = None
    if cache_miss:
        # cache-miss injection (DelayedCommandStores.java:138-195 capability):
        # keep evicting terminal commands so the protocol continuously runs
        # against state that is NOT memory-resident and must fault back in
        # from the journal (requires journal=True)
        assert journal, "cache_miss injection requires the journal"
        evict_rng = rng.fork()

        def evict_some():
            # eviction runs INSIDE each store's executor: a deferred store
            # task (delayed_stores) may still hold a direct reference to a
            # command — evicting from outside would let a later lookup fault
            # in a SECOND live instance of the same command, silently breaking
            # the single-instance invariant even when no mutation races
            for node in cluster.nodes.values():
                for cs in node.command_stores.all_stores():
                    def evict_in_store(safe, cs=cs):
                        for tid in list(cs.commands):
                            if evict_rng.next_float() < 0.3:
                                safe.evict(tid)
                    cs.execute(evict_in_store)
        cache_miss_task = cluster.scheduler.recurring(0.4, evict_some)

    frontier_task = None
    if resolver == "verify" and not chaos and not delayed_stores:
        # continuous frontier parity at (deterministic) quiescent task points
        frontier_task = cluster.scheduler.recurring(
            0.7, lambda: verify_frontiers(cluster))
    frontier_release_task = None
    if frontier_exec:
        # frontier-DRIVEN execution (SURVEY §7 stage 8): indexed STABLE txns
        # whose WaitingOn drained park in store.exec_deferred; only the device
        # kahn_frontier releases them into ReadyToExecute.  A frontier that
        # misses a ready txn stalls the burn — the parity failure is loud.
        assert resolver in ("verify", "tpu"), \
            "frontier_exec needs the device resolver's wait-graph mirror"
        from ..local import commands as C
        from ..local.status import SaveStatus as _SS
        for node in cluster.nodes.values():
            for cs in node.command_stores.all_stores():
                cs.frontier_exec = True

        def release_frontiers():
            for node in cluster.nodes.values():
                for cs in node.command_stores.all_stores():
                    if not cs.exec_deferred:
                        continue

                    def in_store(safe, cs=cs):
                        if not cs.exec_deferred:
                            return
                        r = getattr(cs.resolver, "tpu", cs.resolver)
                        ready = r.frontier_ready()
                        parked = list(cs.exec_deferred)
                        # columnar prefilter (exact-skip): resident rows the
                        # mirror PROVES moved past STABLE are discarded
                        # without the scalar visit; unknown rows (possible
                        # fault-in) always take it
                        known = stable = None
                        if cs.batch_engine is not None:
                            part = cs.batch_engine.exec_deferred_partition(
                                parked)
                            if part is not None:
                                known, stable = part
                        for i, tid in enumerate(parked):
                            if known is not None and known[i] \
                                    and not stable[i]:
                                cs.exec_deferred.discard(tid)
                                continue
                            cmd = safe.get_if_exists(tid)
                            if cmd is None \
                                    or cmd.save_status is not _SS.STABLE:
                                cs.exec_deferred.discard(tid)
                                continue
                            if tid in ready:
                                cs.exec_deferred.discard(tid)
                                cluster.stats["frontier_released"] = \
                                    cluster.stats.get("frontier_released", 0) + 1
                                C.maybe_execute(safe, cmd, True,
                                                from_frontier=True)
                    cs.execute(in_store)
        frontier_release_task = cluster.scheduler.recurring(
            0.05, release_frontiers)
    verifier = StrictSerializabilityVerifier()
    result = BurnResult(seed)
    zipf = rng.next_boolean()
    workload_obj = None
    if workload is not None:
        # the preset draws from its OWN fork of the seeded stream: a seed
        # still fully determines the workload, and the fork keeps the main
        # stream's draw sequence independent of per-op generation arity
        from .workload import make_workload
        workload_obj = make_workload(workload, rate_txn_s=rate_txn_s)
        workload_obj.bind(rng.fork(), key_count=key_count, bound=bound,
                          ops=ops)

    def key_for(i: int) -> IntKey:
        idx = rng.next_zipf(key_count) if zipf else rng.next_int(key_count)
        return IntKey((idx * bound) // key_count)

    state = {"submitted": 0, "in_flight": 0}
    # op_id -> client record; the crash-restart nemesis fails over any op
    # whose coordinator died mid-flight (the reference burn's external client
    # resolving a dead coordinator's silence through CheckStatus probes)
    inflight: Dict[int, dict] = {}
    # per-load-phase goodput buckets (overload burst recovery measurement);
    # load_nemesis is bound below, after the other nemeses
    load_nemesis = None
    phase_ok: Dict[int, int] = {}

    def pick_coordinator():
        # liveness precheck WITHOUT touching the rng (keeps seeded streams
        # stable): if every member is down at once (keep_quorum=False
        # experiments), the redial loop below would spin at HOST level —
        # sim time frozen, so not even the stall watchdog could fire
        if not any(m in cluster.nodes for m in member_ids):
            raise RuntimeError("no live member to coordinate: every member "
                               "node is down (restart_keep_quorum=False with "
                               "restart_max_down >= cluster size?)")
        node_id = rng.pick(member_ids)
        while node_id not in cluster.nodes:   # crashed: the client redials
            node_id = rng.pick(member_ids)
        return cluster.nodes[node_id]

    def live(node):
        """The client's connection: if this node object crashed, dial a
        currently-live node instead."""
        if cluster.nodes.get(node.id) is node:
            return node
        return pick_coordinator()

    def resolve(rec: dict, kind: str, reads=None,
                writes: Optional[dict] = None) -> None:
        if rec["settled"]:
            return   # e.g. probe failover and a late reply raced; first wins
        rec["settled"] = True
        inflight.pop(rec["op_id"], None)
        obs = rec["obs"]
        state["in_flight"] -= 1
        now = cluster.now_micros
        if observer is not None and rec["txn_id"] is not None:
            observer.on_resolve(rec["txn_id"], kind, now)
        if history_rec is not None and not rec.get("control"):
            history_rec.resolve(rec["op_id"], kind, now, reads, writes)
        if kind == "ok":
            obs.complete(now, reads or {}, writes or {})
            result.ops_ok += 1
        elif kind == "recovered":
            obs.complete(now, reads or {}, writes or {})
            result.ops_recovered += 1
        elif kind == "nacked":
            obs.invalidated(now, writes or {})
            result.ops_nacked += 1
        elif kind == "lost":
            obs.lost(now)
            result.ops_lost += 1
        else:
            obs.fail(now)
            result.ops_failed += 1
        if workload_obj is not None and workload_obj.open_loop:
            # client-side AIMD: a shed backs the offered rate off
            # multiplicatively, a success recovers it gradually — the
            # backpressure loop that keeps overload from going metastable
            if rec.get("shed"):
                workload_obj.on_shed()
            elif kind in ("ok", "recovered"):
                workload_obj.on_ok()
            if kind in ("ok", "recovered") and state["submitted"] < ops:
                # a commit landing while arrivals are still being offered:
                # the honest goodput numerator (drain-tail commits after the
                # last arrival are latency, not sustained throughput)
                state["window_ok"] = state.get("window_ok", 0) + 1
        if load_nemesis is not None and kind in ("ok", "recovered"):
            ph = load_nemesis.phase_of(now / 1e6)
            phase_ok[ph] = phase_ok.get(ph, 0) + 1
        submit_next()

    def probe(coordinator, rec: dict, attempt: int) -> None:
        """Client lost-response resolution: CheckStatus the cluster until the
        txn's fate is known (ListRequest.CheckOnResult, ListRequest.java:61-150)."""
        from ..coordinate.fetch_data import check_status_quorum
        if rec["settled"]:
            return
        coordinator = live(coordinator)
        # the prober now owns this op's resolution: if IT crashes mid-probe
        # (its sink teardown swallows the CheckStatus callbacks, so neither
        # reply nor failure ever fires), fail_over_orphans must match on the
        # CURRENT prober, not the original submitter, or the op hangs forever
        rec["coordinator"] = coordinator.id
        txn_id, route, writes = rec["txn_id"], rec["route"], rec["writes"]

        def retry():
            if rec["settled"]:
                return
            if attempt + 1 >= MAX_PROBE_ATTEMPTS:
                resolve(rec, "failed")
                return
            cluster.scheduler.once(0.5 + rng.next_float(),
                                   lambda: probe(coordinator, rec, attempt + 1))

        def on_checked(merged, failure):
            if failure is not None:
                retry()
                return
            ss = merged.save_status if merged is not None else SaveStatus.NOT_DEFINED
            if ss is SaveStatus.INVALIDATED:
                resolve(rec, "nacked", writes=writes)
            elif merged is not None and merged.invalid_if_undecided \
                    and not ss.has_been(Status.PRE_COMMITTED):
                # Infer (Infer.java IfUndecided with quorum): every quorum
                # member's majority-durability watermark passed txnId and none
                # saw a decision — the txn provably never committed and never
                # can (preaccept below the fence refuses): durably invalid
                resolve(rec, "nacked", writes=writes)
            elif ss.ordinal >= SaveStatus.APPLIED.ordinal and not ss.is_truncated:
                reads = dict(merged.result.reads) \
                    if isinstance(merged.result, ListResult) else {}
                resolve(rec, "recovered", reads=reads, writes=writes)
            elif ss.is_truncated:
                # durably decided and cleaned up; outcome unknowable → Lost-class
                resolve(rec, "lost")
            elif not ss.has_been(Status.PRE_ACCEPTED):
                # a quorum answered and nothing witnessed it
                resolve(rec, "lost")
            else:
                # in flight somewhere — but only SOME replica may have
                # witnessed it, and if the home shard never did, NOTHING
                # drives recovery (the progress log monitors only witnessed
                # txns): a minority-witnessed orphan then stays PRE_ACCEPTED
                # forever and the probe loops to its cap.  Tell the home
                # shard it exists (InformOfTxnId.java role; the reference's
                # ListRequest escalation) so MaybeRecover settles it —
                # typically by invalidation — and the next probe resolves.
                if attempt >= 2:
                    from ..messages.status_messages import InformOfTxn
                    topo = coordinator.config_service.current_topology()
                    shard = topo.for_key(route.home_key)
                    if shard is not None:
                        for to in shard.nodes:
                            coordinator.send(to, InformOfTxn(
                                txn_id, route.home_key_only(),
                                coordinator.epoch()))
                retry()  # recovery (now informed) settles it

        check_status_quorum(coordinator, txn_id, route, include_info=True) \
            .to_chain().begin(on_checked)

    def dispatch_txn(op_id: int, txn, read_keys, writes) -> None:
        """Submit one data txn: verifier observation, client record, history
        invoke, coordinate + resolution callback (shared by the classic
        generator and every workload preset)."""
        coordinator = pick_coordinator()
        adm = getattr(coordinator, "admission", None)
        if adm is not None and adm.overloaded():
            # client-entry shed: refused BEFORE a txn id exists, so the fast
            # client-visible failure is sound — the txn provably never
            # entered the system (the round-13 fresh-values rule lets the
            # history checker treat a `fail` as definitely-not-applied)
            adm.sheds += 1
            result.ops_shed += 1
            obs = verifier.begin(cluster.now_micros)
            rec = {"op_id": op_id, "obs": obs, "txn_id": None, "route": None,
                   "writes": {}, "coordinator": coordinator.id,
                   "settled": False, "shed": True}
            inflight[op_id] = rec
            if history_rec is not None:
                history_rec.invoke(op_id, None, cluster.now_micros,
                                   read_keys, writes)
            if observer is not None:
                observer.registry.counter("overload.shed",
                                          node=coordinator.id).inc()
            resolve(rec, "failed")
            return
        txn_id = coordinator.next_txn_id(txn.kind, txn.domain)
        route = txn.to_route()
        obs = verifier.begin(cluster.now_micros)
        rec = {"op_id": op_id, "obs": obs, "txn_id": txn_id, "route": route,
               "writes": dict(writes), "coordinator": coordinator.id,
               "settled": False}
        inflight[op_id] = rec
        if history_rec is not None:
            history_rec.invoke(op_id, txn_id, cluster.now_micros,
                               read_keys, writes)
        if observer is not None:
            observer.on_submit(op_id, txn_id, coordinator.id,
                               cluster.now_micros)
        if on_submit is not None:
            on_submit(op_id, txn_id, txn, coordinator.id)

        def on_done(value, failure, rec=rec, coordinator=coordinator):
            if isinstance(failure, Overloaded) and workload_obj is not None \
                    and workload_obj.open_loop:
                # a replica-side admission nack surfaced as the coordination
                # outcome: pace the open-loop client down before resolving
                # through the normal lost-response machinery
                workload_obj.on_shed()
            if failure is None and isinstance(value, ListResult):
                resolve(rec, "ok", reads=dict(value.reads),
                        writes=dict(rec["writes"]))
            elif isinstance(failure, Invalidated):
                resolve(rec, "nacked", writes=dict(rec["writes"]))
            elif chaos or restart_nodes \
                    or isinstance(failure, CoordinationFailed):
                # response lost in the chaos: resolve through the home shard
                probe(coordinator, rec, 0)
            else:
                resolve(rec, "failed")

        coordinator.coordinate(txn, txn_id=txn_id).add_listener(on_done)

    def dispatch_control(op_id: int, control) -> None:
        """Interactive op (barrier / sync point) through the coordinate
        surface.  No txn id exists before coordination allocates one, so the
        client cannot CheckStatus-probe it: an op whose callbacks died (e.g.
        its coordinator crashed) resolves as lost at a sim-time deadline."""
        coordinator = pick_coordinator()
        obs = verifier.begin(cluster.now_micros)
        rec = {"op_id": op_id, "obs": obs, "txn_id": None, "route": None,
               "writes": {}, "coordinator": coordinator.id,
               "settled": False, "control": True}
        inflight[op_id] = rec
        rec["deadline"] = cluster.scheduler.once(
            control_timeout_s, lambda rec=rec: resolve(rec, "lost"))

        def on_ctl_done(value, failure, rec=rec):
            timer = rec.pop("deadline", None)
            if timer is not None:
                timer.cancel()
            if rec["settled"]:
                return
            if failure is None:
                resolve(rec, "ok")
            elif isinstance(failure, Invalidated):
                resolve(rec, "nacked")
            elif chaos or restart_nodes \
                    or isinstance(failure, CoordinationFailed):
                resolve(rec, "lost")
            else:
                resolve(rec, "failed")

        if control[0] == "barrier":
            _kind, btype, seekables = control
            res = coordinator.barrier(seekables,
                                      min_epoch=coordinator.epoch(),
                                      barrier_type=btype)
        else:
            _kind, seekables = control
            res = coordinator.sync_point(seekables, blocking=False)
        res.add_listener(on_ctl_done)

    def submit_workload_op() -> None:
        op_id = state["submitted"]
        state["submitted"] += 1
        state["in_flight"] += 1
        wop = workload_obj.next_op(op_id)
        if wop.control is not None:
            dispatch_control(op_id, wop.control)
        else:
            dispatch_txn(op_id, wop.txn, wop.read_keys, wop.writes)

    def submit_next() -> None:
        if workload_obj is not None:
            if workload_obj.open_loop:
                return   # arrivals are timer-driven, not window-driven
            while state["in_flight"] < concurrency \
                    and state["submitted"] < ops:
                submit_workload_op()
            return
        while state["in_flight"] < concurrency and state["submitted"] < ops:
            op_id = state["submitted"]
            state["submitted"] += 1
            state["in_flight"] += 1
            if rng.next_float() < 0.15:
                # range query: 1-2 ranges, uniform or zipf sized
                # (BurnTest.java:208-240)
                nranges = rng.next_int(1, 3)
                rngs = []
                for _ in range(nranges):
                    width = 1 + (rng.next_zipf(bound // 2) if zipf
                                 else rng.next_int(bound // 2))
                    start = rng.next_int(bound - 1)
                    rngs.append(Range(IntKey(start),
                                      IntKey(min(bound, start + width))))
                txn = range_read_txn(Ranges.of(*rngs))
                reads = []
                writes = {}
            else:
                nkeys = rng.next_int(1, 4)
                keys = sorted({key_for(i) for i in range(nkeys)})
                kind = rng.pick(["read", "write", "rw", "rw"])
                reads = keys if kind in ("read", "rw") else []
                writes = {key: f"v{op_id}.{ki}" for ki, key in enumerate(keys)} \
                    if kind in ("write", "rw") else {}
                txn = list_txn(reads, writes)
            dispatch_txn(op_id, txn, tuple(reads), writes)

    def schedule_arrivals() -> None:
        """Open-loop: Poisson arrivals on the sim clock — submit at the drawn
        instants regardless of what is in flight."""
        def fire():
            if state["submitted"] >= ops:
                return
            state["last_arrival_us"] = cluster.now_micros
            submit_workload_op()
            arm()

        def arm():
            if state["submitted"] >= ops:
                return
            cluster.scheduler.once(workload_obj.next_arrival_s(), fire)

        arm()

    membership_nemesis = None
    if elastic_membership:
        from .nemesis import MembershipNemesis
        membership_nemesis = MembershipNemesis(
            cluster, rng.fork(), randomizer,
            interval_s=cfg.membership_interval_s,
            min_members=cfg.membership_min_members,
            max_members=cfg.membership_max_members)
        membership_nemesis.attach()
    nemesis = None
    if restart_nodes:
        from .nemesis import RestartNemesis

        def fail_over_orphans(victim: int) -> None:
            # every unsettled op this client had submitted THROUGH the dead
            # coordinator will never hear back (its callbacks died with the
            # process): resolve each through home-shard probes from a live
            # node, exactly like a lost response under chaos
            for rec in list(inflight.values()):
                if rec["coordinator"] == victim and not rec["settled"] \
                        and not rec.get("control"):
                    # control ops (barrier/sync point) have no txn id to
                    # probe; their sim-time deadline resolves them as lost
                    cluster.scheduler.once(
                        0.1 + rng.next_float(),
                        lambda rec=rec: probe(pick_coordinator(), rec, 0))

        nemesis = RestartNemesis(
            cluster, rng.fork(),
            interval_s=cfg.restart_interval_s,
            downtime_min_s=cfg.restart_downtime_min_s,
            downtime_max_s=cfg.restart_downtime_max_s,
            max_down=cfg.restart_max_down,
            keep_quorum=cfg.restart_keep_quorum,
            torn_tail_chance=cfg.journal_torn_tail_chance,
            corrupt_chance=cfg.journal_corrupt_chance,
            on_crash=fail_over_orphans)
        nemesis.attach()
    pause_nemesis = None
    if pause_nodes:
        from .nemesis import PauseNemesis
        pause_nemesis = PauseNemesis(
            cluster, rng.fork(),
            interval_s=cfg.pause_interval_s,
            pause_min_s=cfg.pause_min_s, pause_max_s=cfg.pause_max_s,
            max_paused=cfg.pause_max_paused,
            keep_quorum=cfg.pause_keep_quorum)
        pause_nemesis.attach()
    disk_nemesis = None
    if disk_stall:
        assert journal, "disk_stall requires journal=True (the stalled device)"
        from .nemesis import DiskStallNemesis
        disk_nemesis = DiskStallNemesis(
            cluster, rng.fork(),
            interval_s=cfg.disk_stall_interval_s,
            stall_min_s=cfg.disk_stall_min_s,
            stall_max_s=cfg.disk_stall_max_s)
        disk_nemesis.attach()
    if load_phases:
        assert workload_obj is not None and workload_obj.open_loop, \
            "load_phases requires an open-loop workload (the offered-load " \
            "multiplier scales arrival rates)"
        from .nemesis import LoadSpikeNemesis
        load_nemesis = LoadSpikeNemesis(cluster, workload_obj, load_phases)
        load_nemesis.attach()
    watchdog = None
    if stall_watchdog_s is not None:
        from .watchdog import StallWatchdog
        watchdog = StallWatchdog(cluster, lambda: result.resolved,
                                 stalled_after_s=stall_watchdog_s,
                                 interval_s=cfg.stall_watchdog_interval_s)
        watchdog.attach()
    heartbeat_task = None
    if progress_every_s:
        # one line per N sim-seconds so long seed sweeps aren't silent until
        # the watchdog fires.  NOTE: unlike the flight recorder this DOES
        # schedule (a recurring sim task) — it shifts queue sequence numbers,
        # so runs meant for trace reconciliation should leave it off.
        label = progress_label if progress_label else f"seed {seed}"

        def heartbeat():
            line = (f"[burn {label}] sim={cluster.now_micros / 1e6:.1f}s "
                    f"resolved={result.resolved}/{ops} "
                    f"in_flight={state['in_flight']}")
            if observer is not None:
                fast = observer.registry.counter("txn.path.fast").value
                slow = observer.registry.counter("txn.path.slow").value
                if fast + slow:
                    line += f" fast_path={100.0 * fast / (fast + slow):.0f}%"
            print(line, flush=True)
        heartbeat_task = cluster.scheduler.recurring(float(progress_every_s),
                                                     heartbeat)
    if workload_obj is not None and workload_obj.open_loop:
        schedule_arrivals()
    else:
        submit_next()

    try:
        cluster.run_until(lambda: result.resolved >= ops, max_tasks=max_tasks)
        # quiesce: stop chaos/churn/durability/nemesis so the cluster can
        # settle (the reference's noMoreWorkSignal, Cluster.java:470-475)
        if watchdog is not None:
            watchdog.cancel()   # resolved stops moving by design from here on
        if heartbeat_task is not None:
            heartbeat_task.cancel()
        if churn_task is not None:
            churn_task.cancel()
        if membership_nemesis is not None:
            # stop join/leave scheduling; drained nodes stay live (prior
            # epochs still need them; the agreement check judges the FINAL
            # topology's replica sets)
            membership_nemesis.stop()
        if pause_nemesis is not None:
            # resume every paused node BEFORE restarting downed ones: the
            # parked late-firing timers must drain into a full replica set
            pause_nemesis.stop_and_restore()
        if disk_nemesis is not None:
            # everything buffered becomes durable; held packets hit the wire
            disk_nemesis.stop_and_restore()
        if load_nemesis is not None:
            load_nemesis.stop()
        if nemesis is not None:
            # restore every down node BEFORE judging final state: the
            # agreement checks need the full replica set live and caught up
            nemesis.stop_and_restore()
        for sched in durability_scheduling.values():
            sched.stop()
        if hasattr(cluster.link, "heal"):
            cluster.link.heal()
        cluster.run_until_idle(max_tasks=max_tasks)
        if cache_miss_task is not None:
            cache_miss_task.cancel()
        if frontier_task is not None:
            frontier_task.cancel()
            verify_frontiers(cluster)   # final quiescent frontier parity
        elif resolver == "verify":
            # chaos / delayed-store runs: mid-run points are nondeterministic,
            # but FINAL quiescence must still agree (VERDICT r03 item 3)
            verify_frontiers(cluster)
        if frontier_release_task is not None:
            frontier_release_task.cancel()
            # txns parked AFTER the last release tick (run_until_idle stops
            # once only recurring tasks remain) are not frontier misses: keep
            # releasing while each round strictly shrinks the deferred set
            # (a parked dependency chain can be arbitrarily deep at quiesce),
            # and only judge once a round makes no progress
            def _deferred_count():
                return sum(len(cs.exec_deferred)
                           for n in cluster.nodes.values()
                           for cs in n.command_stores.all_stores())
            prev = _deferred_count()
            while prev:
                release_frontiers()
                cluster.run_until_idle(max_tasks=max_tasks)
                cur = _deferred_count()
                if cur >= prev:
                    break
                prev = cur
            leftover = [(n.id, cs.id, sorted(cs.exec_deferred))
                        for n in cluster.nodes.values()
                        for cs in n.command_stores.all_stores()
                        if cs.exec_deferred]
            if leftover:
                raise HistoryViolation(
                    f"frontier-driven execution left deferred txns: {leftover}")
        result.ops_submitted = state["submitted"]
        result.sim_micros = cluster.now_micros
        result.stats = dict(cluster.stats)
        result.crashes = cluster.stats.get("node_crashes", 0)
        result.restarts = cluster.stats.get("node_restarts", 0)
        result.pauses = cluster.stats.get("node_pauses", 0)
        result.disk_stalls = cluster.stats.get("journal_stalls", 0)
        result.joins = cluster.stats.get("node_joins", 0)
        result.leaves = cluster.stats.get("node_decommissions", 0)
        # overload plane: admission nacks + retry-budget denials, summed from
        # plain per-node counters (observer-free by design — the zero-
        # observer-effect contract extends to the overload.* series); current
        # incarnations only, like every other per-node end-of-run sum
        for node in cluster.nodes.values():
            oc = getattr(node, "overload_counters", None)
            if oc:
                result.overload_nacks += oc.get("nacks", 0)
                result.budget_denied += oc.get("budget_denied", 0)
        if workload_obj is not None and workload_obj.open_loop:
            result.paced_arrivals = workload_obj.paced_arrivals
            result.pace_downs = workload_obj.pace_downs
        for key, val in (("overload_nacks", result.overload_nacks),
                         ("overload_budget_denied", result.budget_denied),
                         ("ops_shed", result.ops_shed),
                         ("paced_arrivals", result.paced_arrivals)):
            if val:
                result.stats[key] = val
        for ph, n_ok in sorted(phase_ok.items()):
            result.stats[f"load_phase{ph}_ok"] = n_ok
        if state.get("last_arrival_us"):
            # the offered-load window (first to last open-loop arrival): the
            # overload oracles measure goodput against THIS, not total sim
            # time — the post-arrival drain tail is latency, not throughput
            result.stats["last_arrival_us"] = state["last_arrival_us"]
            result.stats["window_ok_commits"] = state.get("window_ok", 0)
        # per-key execution-register inversion diagnostic (TimestampsForKey):
        # surfaced in every burn's stats; MUST be 0 in benign runs (asserted
        # by test_timestamps_for_key) — growth under chaos pages the Agent
        # via on_inconsistent_timestamp escalation, not silence
        result.stats["tfk_inversions"] = sum(
            cs.tfk_inversions for node in cluster.nodes.values()
            for cs in node.command_stores.all_stores())
        # columnar-engine effectiveness counters (deterministic given the
        # trajectory — the engine never CHANGES the trajectory): how many
        # scalar visits the vectorized passes proved skippable
        col_stats: Dict[str, int] = {}
        for node in cluster.nodes.values():
            for cs in node.command_stores.all_stores():
                if cs.batch_engine is not None:
                    for k2, v in cs.batch_engine.stats.items():
                        col_stats[k2] = col_stats.get(k2, 0) + v
        if col_stats:
            result.stats.update({f"columnar_{k2}": v
                                 for k2, v in col_stats.items()})
        if cache_miss:
            result.stats["cache_miss_loads"] = sum(
                cs.cache_miss_loads for node in cluster.nodes.values()
                for cs in node.command_stores.all_stores())
        # data-plane telemetry (tpu/verify resolvers): batching + tier
        # choices, from the unified device-metrics source (observe.device —
        # the same counters the flight recorder and bench.py report)
        from ..observe.device import cluster_resolver_totals
        tel = cluster_resolver_totals(cluster)
        if any(tel.values()):
            result.stats.update({f"resolver_{k2}": v for k2, v in tel.items()})
        if profiler is not None:
            # pull the resolver-side wall counters (consult_wall_s totals)
            profiler.collect_cluster(cluster)
        if observer is not None:
            # end-of-run pull collection: simulator stats, per-store gauges,
            # resolver counters — one registry for burns AND bench reporting
            observer.collect_cluster(cluster)
            verdict = getattr(observer, "verdict", None)
            if verdict is not None:
                result.audit = verdict()
            if audit == "strict" and getattr(observer, "violations", None):
                # belt-and-braces: a violation raised inside a callback can
                # be swallowed by on_callback_failure plumbing — a strict
                # run must STILL fail on any recorded violation
                raise observer.violations[0]
        if result.resolved < ops:
            raise HistoryViolation(
                f"only {result.resolved}/{ops} ops resolved (liveness stall): "
                f"{result!r}")
        if not allow_failures and result.ops_failed:
            raise HistoryViolation(f"{result.ops_failed} ops failed unexpectedly")
        if not chaos and not restart_nodes and not cfg.admission_enabled \
                and (result.ops_lost or result.ops_recovered
                     or (not allow_failures and result.ops_nacked)):
            # (a crashed coordinator legitimately turns acks into
            # probe-recovered / lost resolutions even on a benign network —
            # and so does an admission nack: the shed PreAccept is a partial
            # failure the client resolves through probes)
            raise HistoryViolation(
                f"benign network must ack everything: {result!r}")
        # final replica state must agree per key across replicas covering it
        # (under churn, judge against the FINAL topology's replica sets)
        final: Dict[IntKey, tuple] = {}
        for shard in cluster.topologies[-1].shards:
            lists = {}
            for n in shard.nodes:
                store = cluster.stores[n]
                for key, entries in store.data.items():
                    if shard.range.contains(key):
                        lists.setdefault(key, set()).add(tuple(v for _, v in entries))
            for key, variants in lists.items():
                longest = max(variants, key=len)
                for v in variants:
                    if v != longest[:len(v)]:
                        raise HistoryViolation(
                            f"replica divergence on {key}: {sorted(variants)}")
                final[key] = longest
        verifier.verify(final)
        # persistence contract: the journal's diff log must reconstruct every
        # store's durable command state (Journal.java reconstruct)
        if cluster.journal is not None:
            for node in cluster.nodes.values():
                for store in node.command_stores.all_stores():
                    cluster.journal.verify_against(store)
        if check == "history":
            # the independent oracle: replays the CLIENT-VISIBLE history with
            # zero protocol knowledge; raises HistoryAnomaly on any cycle
            from ..observe.checker import check_history
            result.history = check_history(
                history_rec.ops, final_state=final,
                spans=getattr(observer, "spans", None),
                provenance=getattr(observer, "provenance", None))
    except BaseException as e:  # noqa: BLE001
        if profiler is not None:
            try:
                profiler.collect_cluster(cluster)
            except Exception:  # noqa: BLE001 — never mask the real failure
                pass
        if observer is not None:
            # the recording is most valuable on a FAILED seed: pull-collect
            # the cluster gauges so the artifacts written by the CLI's
            # failure path carry the final simulator/store state too
            try:
                observer.collect_cluster(cluster)
                verdict = getattr(observer, "verdict", None)
                if verdict is not None:
                    result.audit = verdict()
            except Exception:  # noqa: BLE001 — never mask the real failure
                pass
        wrapped = SimulationException(seed, e)
        wrapped.audit = result.audit   # the verdict survives the failure path
        raise wrapped from e
    return result


def reconcile(seed: int, **kwargs):
    """Run the same seed twice and assert identical observable behavior —
    the COMPLETE message traces (every SEND/DROP/RPLY/RECV with its logical
    sequence number), plus outcome counters and message stats.  Catches
    nondeterminism itself (BurnTest.reconcile, ReconcilingLogger).  Returns
    the two BurnResults (with ``audit=...`` each run constructs its own
    auditor; the caller reads the verdicts off the results)."""
    from .trace import Trace, diff_traces
    ta, tb = Trace(), Trace()
    a = run_burn(seed, tracer=ta.hook, **kwargs)
    b = run_burn(seed, tracer=tb.hook, **kwargs)
    divergence = diff_traces(ta, tb)
    assert divergence is None, \
        f"nondeterministic trace for seed {seed} " \
        f"({len(ta)} vs {len(tb)} events):\n{divergence}"
    assert (a.ops_ok, a.ops_recovered, a.ops_nacked, a.ops_lost, a.ops_failed,
            a.sim_micros) == \
           (b.ops_ok, b.ops_recovered, b.ops_nacked, b.ops_lost, b.ops_failed,
            b.sim_micros), \
        f"nondeterministic outcome for seed {seed}: {a} vs {b}"
    # tier-choice counters are cost-model (wall-clock) driven, not sim-driven:
    # exclude them from the determinism contract (answers are tier-invariant)
    tier_keys = ("resolver_host_consults", "resolver_native_consults",
                 "resolver_device_consults", "resolver_service_submitted",
                 "resolver_service_batches")
    sa = {k: v for k, v in a.stats.items() if k not in tier_keys}
    sb = {k: v for k, v in b.stats.items() if k not in tier_keys}
    assert sa == sb, \
        f"nondeterministic message counts for seed {seed}: " \
        f"{ {k: (sa.get(k), sb.get(k)) for k in set(sa) | set(sb) if sa.get(k) != sb.get(k)} }"
    return a, b


def build_slo_specs(latency_s=None, budget=None, windows=None):
    """CLI SloSpec tuning (``--slo-latency/--slo-budget/--slo-windows``).

    ``SloSpec`` is an immutable ``__slots__`` class, so overrides rebuild the
    DEFAULT_SLOS tuple with fresh instances.  Returns None when nothing is
    overridden (callers keep the shared defaults).  ``windows`` is
    ``"short:long"`` in sim-seconds; ``latency_s`` applies to latency-kind
    specs only (liveness has no latency threshold)."""
    if latency_s is None and budget is None and windows is None:
        return None
    from ..observe.burnrate import DEFAULT_SLOS, SloSpec
    short_s = long_s = None
    if windows is not None:
        s, sep, l = str(windows).partition(":")
        if not sep:
            raise ValueError(f"--slo-windows wants SHORT:LONG sim-seconds, "
                             f"got {windows!r}")
        short_s, long_s = float(s), float(l)
    specs = []
    for spec in DEFAULT_SLOS:
        specs.append(SloSpec(
            spec.name, spec.kind,
            budget=float(budget) if budget is not None else spec.budget,
            short_s=short_s if short_s is not None else spec.short_us / 1e6,
            long_s=long_s if long_s is not None else spec.long_us / 1e6,
            burn_threshold=spec.burn_threshold,
            min_bad=spec.min_bad,
            latency_slo_us=int(float(latency_s) * 1e6)
            if latency_s is not None and spec.kind == "latency"
            else spec.latency_slo_us))
    return tuple(specs)


def _overload_observer(slo_specs, provenance=None):
    """Fresh warn-mode auditor + burn-rate monitor pair for one overload
    point (each burn needs its own: the monitors are stateful)."""
    from ..observe import BurnRateMonitor, InvariantAuditor
    monitor = BurnRateMonitor(specs=slo_specs) if slo_specs \
        else BurnRateMonitor()
    return InvariantAuditor(mode="warn", burnrate=monitor,
                            provenance=provenance), monitor


def _goodput(result) -> float:
    """Committed client ops per sim-second of OFFERED-LOAD time: commits
    that landed while arrivals were still being offered, over the
    first-to-last-arrival window.  Drain-tail commits (after the last
    arrival) are excluded from BOTH numerator and denominator — they are
    latency, not sustained throughput; the latency SLO monitors are the
    oracle for "committed but far too slow"."""
    window_us = result.stats.get("last_arrival_us", result.sim_micros)
    ok = result.stats.get("window_ok_commits",
                          result.ops_ok + result.ops_recovered)
    return ok / max(window_us / 1e6, 1e-9)


def run_overload_ramp(seed: int, kw: dict, rate_txn_s: float,
                      mults=(0.5, 1.0, 2.0, 4.0), frac: float = 0.8,
                      slo_specs=None) -> dict:
    """The metastability ramp oracle: sequential open-loop burns at each
    offered-load multiple of the estimated capacity rate.  Pass iff goodput
    at every overload point (mult > 1) holds >= ``frac`` of the 1x
    capacity-goodput — a metastable collapse shows up as goodput CRATERING
    past saturation instead of plateauing (shed ops are fast client-visible
    failures, not goodput).  ``kw`` carries the fault matrix + an
    admission/budget-enabled node_config; each point gets a fresh warn-mode
    auditor so SLO flags ride the verdict.

    The ramp clients are deliberately UNCOOPERATIVE (AIMD pacing off): a
    metastability probe must hold the offered rate no matter what the
    cluster signals, so the floor it measures is the server-side defense
    alone (admission + budgets).  The burst oracle is the cooperative-client
    counterpart — there AIMD pacing is exactly what is being demonstrated."""
    from .workload import OpenLoopWorkload
    out = {"mode": "ramp", "rate_txn_s": rate_txn_s,
           "mults": [float(m) for m in mults], "frac": frac, "points": []}
    baseline = None
    base_ops = int(kw.get("ops") or 200)
    for mult in mults:
        kw2 = dict(kw)
        observer, monitor = _overload_observer(slo_specs)
        kw2["observer"] = observer
        kw2["workload"] = OpenLoopWorkload(
            rate_txn_s=rate_txn_s * float(mult), aimd=False)
        # hold the ARRIVAL WINDOW constant across points (ops scales with
        # the rate) so every goodput measurement spans the same sim-seconds
        kw2["ops"] = max(int(base_ops * float(mult)), 20)
        r = run_burn(seed, rate_txn_s=rate_txn_s * float(mult), **kw2)
        point = {"mult": float(mult),
                 "goodput_txn_s": round(_goodput(r), 3),
                 "ok": r.ops_ok, "recovered": r.ops_recovered,
                 "failed": r.ops_failed, "shed": r.ops_shed,
                 "nacks": r.overload_nacks,
                 "budget_denied": r.budget_denied,
                 "paced": r.paced_arrivals,
                 "sim_s": round(r.sim_micros / 1e6, 2),
                 "violations": (r.audit or {}).get("violations", 0),
                 "slo_burn_events": monitor.report()["slo_burn_events"]}
        out["points"].append(point)
        if float(mult) == 1.0:
            baseline = point["goodput_txn_s"]
    over = [p for p in out["points"] if p["mult"] > 1.0]
    clean = all(p["violations"] == 0 for p in out["points"])
    if baseline and over:
        worst = min(p["goodput_txn_s"] for p in over)
        out["capacity_goodput_txn_s"] = baseline
        out["goodput_floor_frac"] = round(worst / baseline, 3)
        out["passed"] = bool(worst >= frac * baseline and clean)
    else:
        out["passed"] = clean   # no goodput comparison — audit alone
    return out


def run_overload_burst(seed: int, kw: dict, rate_txn_s: float,
                       burst_mult: float = 4.0, pre_s: float = 30.0,
                       burst_s: float = 20.0, post_s: float = 40.0,
                       frac: float = 0.8, slo_specs=None,
                       provenance=None) -> dict:
    """The burst-then-recover oracle: one open-loop burn whose offered load
    steps 1x -> ``burst_mult`` -> 1x on the deterministic LoadSpikeNemesis
    schedule.  Pass iff post-burst goodput recovers to >= ``frac`` of
    pre-burst goodput within the bounded post window AND the run ends with
    zero open SLO flags/burns — the signature of a metastable failure is
    exactly a system that does NOT recover when the trigger is removed."""
    phases = [(0.0, 1.0), (pre_s, float(burst_mult)),
              (pre_s + burst_s, 1.0)]
    # size the op count to span the whole schedule (arrivals stop at `ops`)
    ops = max(int(rate_txn_s * (pre_s + burst_s * float(burst_mult)
                                + post_s)), 50)
    kw2 = dict(kw, ops=ops, load_phases=phases)
    kw2.setdefault("workload", "openloop")
    observer, monitor = _overload_observer(slo_specs, provenance=provenance)
    kw2["observer"] = observer
    if provenance is not None:
        kw2["provenance"] = provenance
    r = run_burn(seed, rate_txn_s=rate_txn_s, **kw2)
    sim_s = r.sim_micros / 1e6
    pre_ok = r.stats.get("load_phase0_ok", 0)
    burst_ok = r.stats.get("load_phase1_ok", 0)
    post_ok = r.stats.get("load_phase2_ok", 0)
    post_dur = max(sim_s - (pre_s + burst_s), 1e-9)
    pre_goodput = pre_ok / pre_s
    post_goodput = post_ok / post_dur
    rep = monitor.report()
    open_flags = (r.audit or {}).get("slo_flags_open", 0)
    recovered = pre_goodput == 0.0 or post_goodput >= frac * pre_goodput
    out = {"mode": "burst", "rate_txn_s": rate_txn_s,
           "burst_mult": float(burst_mult), "frac": frac, "ops": ops,
           "pre_goodput_txn_s": round(pre_goodput, 3),
           "burst_goodput_txn_s": round(burst_ok / burst_s, 3),
           "post_goodput_txn_s": round(post_goodput, 3),
           "recovery_sim_s": round(post_dur, 2),
           "shed": r.ops_shed, "nacks": r.overload_nacks,
           "budget_denied": r.budget_denied, "paced": r.paced_arrivals,
           "sim_s": round(sim_s, 2),
           "slo_burn_events": rep["slo_burn_events"],
           "open_slo_burns": len(rep["open_slo_burns"]),
           "slo_flags_open": open_flags,
           "violations": (r.audit or {}).get("violations", 0),
           "passed": bool(recovered and not rep["open_slo_burns"]
                          and open_flags == 0
                          and (r.audit or {}).get("violations", 0) == 0)}
    return out


def _append_trend(record: dict) -> None:
    """Ledger a record into BENCH_HISTORY.jsonl via tools/trend.py.
    Best-effort: the ledger must never be able to fail a burn."""
    try:
        import os as _os
        import sys as _sys
        root = _os.path.dirname(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))))
        if root not in _sys.path:
            _sys.path.insert(0, root)
        from tools.trend import append_entry
        append_entry(record)
    except Exception:  # noqa: BLE001 — the ledger must never fail a burn
        pass


def _sweep_worker(seed: int, kw: dict) -> dict:
    """One seed of a ``--parallel-seeds`` sweep.  Module-level so the spawn
    pool can pickle it; observer-free (the sweep is a pass/fail matrix —
    replay a failed seed singly for artifacts).  Never raises: a failure
    becomes a status entry so the cohort always completes."""
    import time as _time
    t0 = _time.perf_counter()
    entry = {"seed": seed}
    try:
        result = run_burn(seed, **kw)
        entry.update(status="pass", resolved=result.resolved,
                     ok=result.ops_ok, recovered=result.ops_recovered,
                     nacked=result.ops_nacked, lost=result.ops_lost,
                     failed=result.ops_failed, shed=result.ops_shed,
                     paced=result.paced_arrivals,
                     budget_denied=result.budget_denied,
                     sim_ms=result.sim_micros // 1000)
        if result.history is not None:
            entry["history"] = {k: result.history[k]
                                for k in ("ops", "ok", "keys", "edges")}
        if getattr(result, "audit", None) is not None:
            entry["audit"] = result.audit
    except SimulationException as e:
        entry.update(status="fail", error=str(e.cause)[:2000])
    except Exception as e:  # noqa: BLE001 — report, don't kill the pool
        entry.update(status="fail", error=repr(e)[:2000])
    entry["wall_s"] = round(_time.perf_counter() - t0, 3)
    return entry


def main(argv=None) -> None:
    """Long-running burn entry point (the reference's BurnTest main:
    ``python -m cassandra_accord_tpu.harness.burn --seeds 0:100 --ops 1000``).
    Every seed runs the full hostile matrix by default; any violation raises
    SimulationException with the seed for replay."""
    import argparse
    import time as _time
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--seeds", default="0:10",
                   help="seed or lo:hi range (default 0:10)")
    p.add_argument("--ops", type=int, default=1000)
    p.add_argument("--concurrency", type=int, default=20)
    p.add_argument("--rf", type=int, default=None,
                   help="replication factor (default: seeded 2-9)")
    p.add_argument("--nodes", type=int, default=None)
    p.add_argument("--resolver", default=None,
                   choices=[None, "cpu", "tpu", "verify"])
    p.add_argument("--columnar", default=None,
                   choices=[None, "auto", "on", "off"],
                   help="columnar protocol engine (protocol_batch/): "
                        "struct-of-arrays txn batches + vectorized release/"
                        "frontier/progress scans.  Trajectory-neutral by "
                        "contract (same-seed on-vs-off burns are byte-"
                        "identical); default: LocalConfig/ACCORD_COLUMNAR "
                        "(auto = on)")
    p.add_argument("--benign", action="store_true",
                   help="disable the chaos network")
    p.add_argument("--no-churn", action="store_true",
                   help="disable topology churn (churn is part of the "
                        "default hostile matrix: the reference's hardest "
                        "regime mutates topology DURING partitions)")
    p.add_argument("--elastic", action="store_true",
                   help="elastic membership: seeded join (add_node + join "
                        "epoch) and decommission (hand-off + removal from "
                        "every shard) cycles under load, plus join/leave "
                        "actions in the churn mix — all respecting the "
                        "muted-quorum floor")
    p.add_argument("--matrix", default=None, choices=["big"],
                   help="'big' = the large-cluster elastic regime: 10-20 "
                        "nodes (seeded), rf 3/5, elastic membership + the "
                        "full gray-failure matrix.  Gated behind "
                        "ACCORD_LONG_BURNS=1 (hours-class wall clock)")
    p.add_argument("--no-cache-miss", action="store_true")
    p.add_argument("--no-restart", action="store_true",
                   help="disable the crash-restart nemesis (node kills + "
                        "journal-replay rebuilds are part of the default "
                        "hostile matrix)")
    p.add_argument("--no-pause", action="store_true",
                   help="disable the pause nemesis (stop-the-world process "
                        "pauses with late-firing timers are part of the "
                        "default hostile matrix)")
    p.add_argument("--no-disk-stall", action="store_true",
                   help="disable the disk-stall nemesis (journal-append "
                        "stalls; a crash mid-stall loses the unsynced tail)")
    p.add_argument("--no-corruption", action="store_true",
                   help="disable crash-time journal damage injection "
                        "(torn tail records, bit flips)")
    p.add_argument("--corruption-policy", default=None,
                   choices=["quarantine", "halt"],
                   help="restart-replay policy for a corrupt MID-LOG record "
                        "(default: LocalConfig/ACCORD_JOURNAL_CORRUPTION)")
    p.add_argument("--restart-interval", type=float, default=None,
                   help="mean sim-seconds between crash attempts "
                        "(default: LocalConfig/ACCORD_RESTART_INTERVAL)")
    p.add_argument("--audit", default="off",
                   choices=["strict", "warn", "off"],
                   help="online protocol-invariant auditor over the flight-"
                        "recorder stream (observe/audit.py): strict raises "
                        "at the first violated invariant with the txn's "
                        "full timeline; warn records violations into the "
                        "--json verdict; SLO liveness flags are recorded "
                        "either way")
    p.add_argument("--audit-slo", type=float, default=None, metavar="SIM_S",
                   help="auditor liveness budget: flag a txn undecided this "
                        "many sim-seconds with no recovery attempt "
                        "attributed (default 10)")
    p.add_argument("--check", default="off", choices=["off", "history"],
                   help="independent history oracle (observe/checker.py): "
                        "record the client-visible invoke/ok/fail/info "
                        "history and verify strict serializability over it "
                        "with ZERO protocol knowledge — version orders from "
                        "unique write values, wr/ww/rw + real-time edges, "
                        "any cycle named (G0/G1c/G-single/G2/-realtime, "
                        "lost-update, non-repeatable-read) with the "
                        "offending sub-history.  Composes with --audit")
    p.add_argument("--workload", default=None,
                   choices=["multirange", "zipf", "openloop"],
                   help="traffic shape preset (harness/workload.py): "
                        "multirange = cross-shard txns + interactive "
                        "barriers/sync points; zipf = hot-key skew with a "
                        "mid-burn hot-range migration; openloop = Poisson "
                        "arrivals at --rate txn/s of sim-time (pair with "
                        "--burnrate: zero slo.burn events = rate sustained). "
                        "Default: the classic uniform closed-loop mix")
    p.add_argument("--rate", type=float, default=25.0, metavar="TXN_S",
                   help="openloop arrival rate, txn per sim-second "
                        "(default 25)")
    p.add_argument("--overload", default=None, choices=["ramp", "burst"],
                   help="overload-robustness oracle (implies --workload "
                        "openloop, admission control + retry budgets ON): "
                        "ramp = sequential burns at --overload-mults x "
                        "--rate, pass iff goodput past saturation holds "
                        ">= --overload-frac of the 1x capacity-goodput; "
                        "burst = one burn whose offered load steps "
                        "1x -> 4x -> 1x, pass iff post-burst goodput "
                        "recovers and zero SLO flags stay open.  Exit code "
                        "4 on acceptance failure (2 stays the stall exit)")
    p.add_argument("--overload-mults", default="0.5,1,2,4", metavar="M,M,..",
                   help="ramp offered-load multipliers (default 0.5,1,2,4)")
    p.add_argument("--overload-frac", type=float, default=0.8,
                   metavar="FRAC",
                   help="acceptance floor: overload goodput >= FRAC x "
                        "capacity-goodput (default 0.8)")
    p.add_argument("--slo-latency", type=float, default=None, metavar="SIM_S",
                   help="commit-latency SLO threshold in sim-seconds "
                        "(default 5.0) for the burn-rate monitors")
    p.add_argument("--slo-budget", type=float, default=None, metavar="FRAC",
                   help="SLO error-budget fraction in (0,1) applied to "
                        "every monitor (defaults: latency 0.05, "
                        "liveness 0.02)")
    p.add_argument("--slo-windows", default=None, metavar="SHORT:LONG",
                   help="burn-rate window pair in sim-seconds "
                        "(default 5:30)")
    p.add_argument("--parallel-seeds", type=int, default=0, metavar="N",
                   help="run the seed range across N worker processes "
                        "(spawn pool; observers/artifacts stay off in "
                        "workers) and ledger one cohort record to "
                        "BENCH_HISTORY.jsonl")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write a machine-readable per-seed summary "
                        "(pass/stall/divergence, wall-clock, ops resolved, "
                        "faults injected) after every seed — seed-range "
                        "matrix runs diff across PRs instead of eyeballing "
                        "logs")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write the flight recorder's metrics-registry "
                        "snapshot (stable JSON; per-seed suffix on seed "
                        "ranges) after every seed")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write the flight recorder's Chrome trace-event "
                        "JSON (open in Perfetto / chrome://tracing; one "
                        "track per node/store) after every seed")
    p.add_argument("--provenance", default=None, metavar="PATH",
                   help="record the causal event DAG (observe/provenance.py: "
                        "every message/handler/timer/transition with its "
                        "execution + message-chain parents) and write the "
                        "dump after every seed (per-seed suffix on seed "
                        "ranges).  Zero observer effect: the message trace "
                        "stays byte-identical.  Audit violations, history "
                        "anomalies and watchdog stall dumps gain bounded "
                        "backward causal slices; --trace-out gains causal "
                        "flow arrows")
    p.add_argument("--explain-vs", default=None, metavar="PROV_JSON",
                   help="divergence forensics: after the run, align this "
                        "run's causal DAG against a reference --provenance "
                        "dump and report the causally-first divergent event "
                        "+ its ancestor cone (implies provenance recording; "
                        "single seed only)")
    p.add_argument("--timeline-out", default=None, metavar="PATH",
                   help="write the sim-time windowed-telemetry JSONL "
                        "(observe/timeline.py: per-window commits/s + "
                        "latency p50/p95/p99 + in-flight + message rates, "
                        "plus consult-service trajectory windows) after "
                        "every seed; also adds a per-window counter track "
                        "to --trace-out")
    p.add_argument("--timeline-window", type=float, default=1.0,
                   metavar="SIM_S",
                   help="timeline window width in sim-seconds (default 1.0)")
    p.add_argument("--burnrate", action="store_true",
                   help="multi-window SLO burn-rate monitors "
                        "(observe/burnrate.py) over commit latency and the "
                        "auditor's liveness-flag plane: deterministic "
                        "slo.burn events land in the --json audit verdict "
                        "and the watchdog stall dump — mid-run early "
                        "warning for soak burns (implies --audit=warn when "
                        "auditing is off: the liveness-flag plane feeds "
                        "the monitors)")
    p.add_argument("--profile", action="store_true",
                   help="two-plane performance profile per seed: the "
                        "sim-time critical-path latency budget (which "
                        "segment classes a commit's life is spent in — "
                        "observe/critical_path.py) and the wall-clock "
                        "profile (per-message-type handler CPU, event-loop "
                        "occupancy, device launch breakdown — "
                        "observe/profiler.py).  Rides the flight recorder; "
                        "zero effect on the recorded trace.  With --json "
                        "both reports land in the per-seed entry; with "
                        "--trace-out the wall handler tracks + txn flow "
                        "links are embedded in the Perfetto trace")
    p.add_argument("--progress", type=float, default=None, metavar="SIM_S",
                   help="heartbeat: one progress line (resolved, in-flight, "
                        "fast-path %%) per SIM_S sim-seconds")
    p.add_argument("--no-watchdog", action="store_true",
                   help="disable the stall watchdog (on stall it dumps the "
                        "wait graph + status frontier and exits nonzero)")
    p.add_argument("--watchdog-stall", type=float, default=None,
                   help="sim-seconds without a resolved op before the "
                        "watchdog fires (default: LocalConfig)")
    p.add_argument("--reconcile", action="store_true",
                   help="double-run each seed and diff full traces")
    args = p.parse_args(argv)
    from dataclasses import replace as _replace
    from ..config import LocalConfig
    from .watchdog import StallError
    cfg = LocalConfig.from_env()
    if args.restart_interval is not None:
        cfg = _replace(cfg, restart_interval_s=args.restart_interval)
    if args.no_corruption:
        cfg = _replace(cfg, journal_torn_tail_chance=0.0,
                       journal_corrupt_chance=0.0)
    if args.corruption_policy is not None:
        cfg = _replace(cfg, journal_corruption_policy=args.corruption_policy)
    watchdog_s = None
    if not args.no_watchdog:
        watchdog_s = args.watchdog_stall if args.watchdog_stall is not None \
            else cfg.stall_watchdog_after_s
    # --slo-* overrides rebuild the DEFAULT_SLOS tuple (None = defaults)
    slo_specs = build_slo_specs(args.slo_latency, args.slo_budget,
                                args.slo_windows)
    if args.matrix == "big":
        import os as _os
        if "ACCORD_LONG_BURNS" not in _os.environ:
            raise SystemExit("--matrix big is an hours-class run: set "
                             "ACCORD_LONG_BURNS=1 to confirm")
        args.elastic = True
    lo, _, hi = args.seeds.partition(":")
    seeds = range(int(lo), int(hi) + 1) if hi else [int(lo)]
    summaries: list = []

    def artifact_path(path: str, seed: int) -> str:
        """Per-seed artifact name on seed ranges; the exact path otherwise."""
        if len(seeds) == 1:
            return path
        import os.path as _p
        stem, ext = _p.splitext(path)
        return f"{stem}.seed{seed}{ext or '.json'}"

    if args.reconcile and (args.metrics_out or args.trace_out or args.profile
                           or args.timeline_out or args.burnrate
                           or args.provenance or args.explain_vs):
        # reconcile runs two bare runs per seed and diffs them; a flight
        # recorder would conflate both into one recording — say so up front
        # instead of silently never writing the files
        print("warning: --metrics-out/--trace-out/--profile/--timeline-out/"
              "--burnrate/--provenance/--explain-vs are ignored with "
              "--reconcile (no artifacts/profiles will be produced)",
              flush=True)

    if args.explain_vs and len(seeds) != 1 and not args.reconcile:
        raise SystemExit("--explain-vs compares ONE run against ONE "
                         f"reference dump (got --seeds {args.seeds})")

    if args.burnrate and args.audit == "off" and not args.reconcile:
        # the monitors' liveness plane burns on the auditor's SLO-flag
        # openings, and the --json burnrate report rides the audit verdict —
        # without the auditor a total wedge starves BOTH monitor streams and
        # nothing ever fires.  --burnrate therefore implies the warn plane.
        print("note: --burnrate implies --audit=warn (the liveness-flag "
              "plane feeds the monitors and carries their report)",
              flush=True)
        args.audit = "warn"

    def write_json() -> None:
        if args.json is None:
            return
        import json as _json
        doc = {"ops": args.ops, "concurrency": args.concurrency,
               "seeds": args.seeds, "benign": args.benign,
               "results": summaries}
        with open(args.json, "w") as f:
            _json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")

    _FAULT_KEYS = ("node_crashes", "node_restarts", "node_pauses",
                   "journal_stalls", "journal_unsynced_lost",
                   "journal_injected_tears", "journal_injected_bitflips",
                   "journal_torn_records", "journal_quarantined_txns",
                   "node_joins", "node_decommissions")
    def base_kw(seed: int):
        """Seeded per-seed run_burn kwargs — shared by the inline loop and
        the --parallel-seeds pool, so everything here must stay picklable."""
        if args.matrix == "big":
            # the large-cluster regime: 10-20 nodes, rf 3/5, seeded per seed
            srng = RandomSource(seed)
            rf = args.rf if args.rf is not None else srng.pick([3, 3, 5])
            if args.nodes is None:
                args_nodes = srng.next_int(10, 21)
            else:
                args_nodes = args.nodes
        else:
            rf = args.rf if args.rf is not None \
                else 2 + RandomSource(seed).next_int(8)
            args_nodes = args.nodes
        kw = dict(ops=args.ops, concurrency=args.concurrency, rf=rf,
                  nodes=args_nodes, resolver=args.resolver,
                  chaos=not args.benign, allow_failures=not args.benign,
                  topology_churn=not args.no_churn,
                  elastic_membership=bool(args.elastic),
                  durability=True, journal=True,
                  delayed_stores=not args.benign, clock_drift=not args.benign,
                  cache_miss=not args.no_cache_miss,
                  restart_nodes=not args.no_restart,
                  pause_nodes=not args.no_pause,
                  disk_stall=not args.no_disk_stall,
                  stall_watchdog_s=watchdog_s,
                  columnar=args.columnar,
                  check=args.check,
                  workload=args.workload,
                  rate_txn_s=args.rate,
                  node_config=cfg,
                  max_tasks=200_000_000)
        return rf, kw

    if args.overload:
        if args.workload not in (None, "openloop"):
            raise SystemExit("--overload drives the openloop workload "
                             f"(got --workload {args.workload})")
        if args.reconcile or args.parallel_seeds > 1:
            raise SystemExit("--overload does not compose with --reconcile/"
                             "--parallel-seeds (the oracle is itself a "
                             "multi-burn schedule)")
        # the defense under test: admission control + retry budgets ON
        ov_cfg = _replace(cfg, admission_enabled=True,
                          retry_budget_enabled=True)
        try:
            mults = tuple(float(m) for m in args.overload_mults.split(",")
                          if m.strip())
        except ValueError:
            raise SystemExit(f"--overload-mults wants comma-separated "
                             f"floats, got {args.overload_mults!r}")
        failures = 0
        for seed in seeds:
            _rf, kw = base_kw(seed)
            kw.update(workload="openloop", node_config=ov_cfg,
                      allow_failures=True)
            kw.pop("rate_txn_s", None)   # the oracle sets the rate per point
            if args.audit != "off":
                kw["audit"] = args.audit
                kw["audit_slo_s"] = args.audit_slo
            t0 = _time.perf_counter()
            entry = {"seed": seed, "overload": args.overload,
                     "rate_txn_s": args.rate}
            summaries.append(entry)
            prov = None
            if args.provenance and args.overload == "burst":
                # one recorder per burst burn; the ramp oracle runs several
                # burns per point and would conflate them into one DAG
                from ..observe import ProvenanceRecorder
                prov = ProvenanceRecorder()
            elif args.provenance and args.overload == "ramp":
                print("warning: --provenance is ignored with --overload "
                      "ramp (multi-burn schedule)", flush=True)
            try:
                if args.overload == "ramp":
                    out = run_overload_ramp(
                        seed, kw, args.rate, mults=mults,
                        frac=args.overload_frac, slo_specs=slo_specs)
                else:
                    out = run_overload_burst(
                        seed, kw, args.rate, frac=args.overload_frac,
                        slo_specs=slo_specs, provenance=prov)
            except SimulationException as e:
                entry.update(status="fail", error=str(e.cause)[:2000],
                             wall_s=round(_time.perf_counter() - t0, 3))
                if prov is not None:
                    # the DAG up to the failure point IS the forensic artifact
                    prov.save(artifact_path(args.provenance, seed))
                write_json()
                if isinstance(e.cause, StallError):
                    print(f"seed {seed}: STALL during --overload "
                          f"{args.overload}\n{e.cause.dump}")
                    raise SystemExit(2)
                raise
            entry.update(status="pass" if out["passed"] else
                         "overload_failed",
                         wall_s=round(_time.perf_counter() - t0, 3),
                         result=out)
            if prov is not None:
                prov.save(artifact_path(args.provenance, seed))
            if args.overload == "ramp":
                metric, value = ("goodput_floor_frac",
                                 out.get("goodput_floor_frac"))
            else:
                metric, value = ("recovery_sim_s", out.get("recovery_sim_s"))
            _append_trend({"kind": "overload", "metric": metric,
                           "value": value, "unit": "frac"
                           if args.overload == "ramp" else "s",
                           "mode": args.overload, "seeds": [seed],
                           "rate_txn_s": args.rate,
                           "capacity_goodput_txn_s":
                           out.get("capacity_goodput_txn_s",
                                   out.get("pre_goodput_txn_s")),
                           "shed": out.get("shed", sum(
                               p["shed"] for p in out.get("points", []))),
                           "budget_denied": out.get("budget_denied", sum(
                               p["budget_denied"]
                               for p in out.get("points", []))),
                           "paced": out.get("paced", sum(
                               p["paced"] for p in out.get("points", []))),
                           "passed": out["passed"]})
            print(f"seed {seed}: overload {args.overload} "
                  f"{'PASS' if out['passed'] else 'FAIL'} "
                  f"({_time.perf_counter() - t0:.1f}s) {out}", flush=True)
            if not out["passed"]:
                failures += 1
        write_json()
        if failures:
            # distinct exit code: the cluster survived (no stall, no
            # violation) but FAILED the overload acceptance bar
            raise SystemExit(4)
        return

    if args.parallel_seeds > 1:
        if args.reconcile:
            raise SystemExit("--parallel-seeds does not compose with "
                             "--reconcile (run the sweep, replay failed "
                             "seeds singly)")
        if (args.metrics_out or args.trace_out or args.profile
                or args.timeline_out or args.provenance or args.explain_vs):
            print("warning: per-seed artifacts are skipped under "
                  "--parallel-seeds (workers run observer-free)", flush=True)
        import multiprocessing as _mp
        t0 = _time.perf_counter()
        jobs = []
        for seed in seeds:
            _rf, kw = base_kw(seed)
            if args.audit != "off":
                # run_burn constructs its own auditor per worker; the mode
                # string is picklable where an InvariantAuditor is not
                kw["audit"] = args.audit
                kw["audit_slo_s"] = args.audit_slo
            jobs.append((seed, kw))
        ctx = _mp.get_context("spawn")   # no inherited simulator/device state
        with ctx.Pool(processes=args.parallel_seeds) as pool:
            results = pool.starmap(_sweep_worker, jobs)
        wall = round(_time.perf_counter() - t0, 3)
        summaries.extend(results)
        n_pass = sum(1 for r in results if r["status"] == "pass")
        _append_trend({"kind": "burn_sweep", "metric": "sweep_wall_s",
                       "value": wall, "unit": "s",
                       "seeds": [int(s) for s in seeds], "ops": args.ops,
                       "workers": args.parallel_seeds,
                       "workload": args.workload, "check": args.check,
                       "audit": args.audit, "benign": bool(args.benign),
                       "passed": n_pass,
                       "failed": len(results) - n_pass})
        write_json()
        for r in results:
            line = f"seed {r['seed']}: {r['status']} ({r['wall_s']}s)"
            if r["status"] != "pass":
                line += f" — {r.get('error', '')[:200]}"
            print(line, flush=True)
        print(f"sweep: {n_pass}/{len(results)} passed in {wall}s "
              f"({args.parallel_seeds} workers)", flush=True)
        if n_pass != len(results):
            raise SystemExit(1)
        return

    for seed in seeds:
        rf, kw = base_kw(seed)
        observer = None
        # per-seed trajectory planes: windowed sim-time telemetry
        # (--timeline-out) and the multi-window SLO burn-rate monitors
        # (--burnrate) — both ride whichever recorder/auditor is built below
        timeline = None
        if args.timeline_out and not args.reconcile:
            from ..observe import Timeline
            timeline = Timeline(window_us=int(args.timeline_window * 1e6))
        monitor = None
        if args.burnrate and not args.reconcile:
            from ..observe import BurnRateMonitor
            monitor = BurnRateMonitor(specs=slo_specs) if slo_specs \
                else BurnRateMonitor()
        prov = None
        if (args.provenance or args.explain_vs) and not args.reconcile:
            from ..observe import ProvenanceRecorder
            prov = ProvenanceRecorder()
            kw["provenance"] = prov
        if args.audit != "off" and not args.reconcile:
            # the auditor IS a FlightRecorder, so it also serves
            # --metrics-out/--trace-out (reconcile runs construct their own
            # auditor per run inside run_burn — audit composes with
            # --reconcile, artifacts do not)
            from ..observe import InvariantAuditor
            observer = InvariantAuditor(
                mode=args.audit, slo_unattended_s=args.audit_slo,
                record_messages=bool(args.trace_out or args.profile),
                timeline=timeline, burnrate=monitor, provenance=prov)
            kw["observer"] = observer
            kw["audit"] = args.audit
        elif args.audit != "off" and args.reconcile:
            kw["audit"] = args.audit
            kw["audit_slo_s"] = args.audit_slo
        elif (args.metrics_out or args.trace_out or args.profile
              or args.timeline_out or args.burnrate or prov is not None) \
                and not args.reconcile:
            # flight recorder (reconcile runs its own two bare runs: the
            # recorder would conflate them, so it stays off there — warned
            # once before the loop).  --profile keeps the message timeline:
            # the critical-path extractor uses PreAccept RECV events to
            # split network wait from replica queueing
            from ..observe import FlightRecorder
            observer = FlightRecorder(
                record_messages=bool(args.trace_out or args.profile),
                timeline=timeline, burnrate=monitor, provenance=prov)
            kw["observer"] = observer
        profiler = None
        if args.profile and not args.reconcile:
            from ..observe import WallProfiler
            profiler = WallProfiler()
            kw["profiler"] = profiler
        if args.progress:
            kw.update(progress_every_s=args.progress,
                      progress_label=f"seed {seed}")

        def write_artifacts(observer=observer, seed=seed, profiler=profiler,
                            prov=prov):
            if args.provenance and prov is not None:
                prov.save(artifact_path(args.provenance, seed))
            if observer is None:
                return
            import json as _json
            if args.metrics_out:
                with open(artifact_path(args.metrics_out, seed), "w") as f:
                    _json.dump(observer.metrics_snapshot(), f, indent=2,
                               sort_keys=True)
                    f.write("\n")
            if args.trace_out:
                # the wall handler tracks + sim→wall txn flow links ride
                # along whenever the profiler ran
                observer.write_trace(artifact_path(args.trace_out, seed),
                                     profiler=profiler)
            if args.timeline_out and getattr(observer, "timeline", None) \
                    is not None:
                observer.write_timeline(
                    artifact_path(args.timeline_out, seed))

        def profile_reports(entry, observer=observer, profiler=profiler,
                            seed=seed):
            """--profile: compute/print both planes, enrich the --json entry.
            Runs on success AND failure (the budget of a stalled seed is the
            forensic artifact)."""
            if profiler is None or observer is None:
                return
            from ..observe import format_budget, format_wall_profile
            budget = observer.latency_budget()
            wall = profiler.report()
            entry["latency_budget"] = budget
            entry["wall_profile"] = wall
            print(format_budget(budget, label=f"seed {seed}"), flush=True)
            print(format_wall_profile(wall, label=f"seed {seed}"), flush=True)

        def explain_report(entry, prov=prov, seed=seed):
            """--explain-vs: align this run's causal DAG against the
            reference --provenance dump.  Prints the human forensics report
            (causally-first divergent event + ancestor cone back to the
            originating decision) and embeds the machine-readable core in
            the --json entry.  Runs on success AND failure."""
            if args.explain_vs is None or prov is None:
                return
            from ..observe import ProvenanceRecorder, explain_divergence
            ref = ProvenanceRecorder.load(args.explain_vs)
            rep = explain_divergence(ref, prov)
            if rep is None:
                entry["explain"] = None
                print(f"seed {seed}: causal DAG identical to reference "
                      f"{args.explain_vs}", flush=True)
                return
            entry["explain"] = {k: v for k, v in rep.items() if k != "text"}
            print(rep["text"], flush=True)
        t0 = _time.perf_counter()
        entry = {"seed": seed, "rf": rf, "ops": args.ops}
        summaries.append(entry)
        try:
            if args.reconcile:
                ra, _rb = reconcile(seed, **kw)
                entry.update(status="pass", reconciled=True,
                             wall_s=round(_time.perf_counter() - t0, 3))
                if getattr(ra, "audit", None) is not None:
                    # warn-mode verdicts must not be silently dropped: the
                    # runs are trace-identical, so one verdict speaks for both
                    entry["audit"] = ra.audit
                write_json()
                print(f"seed {seed}: reconciled (rf={rf}, "
                      f"{_time.perf_counter() - t0:.1f}s)")
            else:
                result = run_burn(seed, **kw)
                entry.update(
                    status="pass", wall_s=round(_time.perf_counter() - t0, 3),
                    resolved=result.resolved, ok=result.ops_ok,
                    recovered=result.ops_recovered, nacked=result.ops_nacked,
                    lost=result.ops_lost, failed=result.ops_failed,
                    shed=getattr(result, "ops_shed", 0),
                    paced=getattr(result, "paced_arrivals", 0),
                    budget_denied=getattr(result, "budget_denied", 0),
                    sim_ms=result.sim_micros // 1000,
                    faults={k: result.stats[k] for k in _FAULT_KEYS
                            if result.stats.get(k)})
                if observer is not None:
                    # --json enrichment: the cluster-scope registry (outcome
                    # partition, path split, recovery/timeout counters)
                    entry["metrics"] = \
                        observer.metrics_snapshot().get("cluster", {})
                if getattr(result, "audit", None) is not None:
                    # per-seed audit verdict: violations + SLO flags
                    entry["audit"] = result.audit
                if getattr(result, "history", None) is not None:
                    # the oracle's clean-run summary (op/edge counts); any
                    # anomaly would have raised HistoryAnomaly instead
                    entry["history"] = {k: result.history[k]
                                        for k in ("ops", "ok", "keys",
                                                  "edges")}
                if args.workload == "openloop" and monitor is not None:
                    # the open-loop SLO preset's verdict: sustained = the
                    # arrival rate was held for the whole burn with zero
                    # slo.burn events — ledgered as the workload_slo series
                    rep = monitor.report()
                    events = rep.get("slo_burn_events", 0)
                    slo_rec = {"kind": "workload_slo",
                               "metric": "slo_burn_events", "value": events,
                               "slo_burn_events": events,
                               "unit": "events", "workload": "openloop",
                               "seeds": [seed], "ops": args.ops,
                               "rate_txn_s": args.rate,
                               "sim_minutes": round(
                                   result.sim_micros / 60e6, 2),
                               "sustained": events == 0}
                    _append_trend(slo_rec)
                    entry["workload_slo"] = slo_rec
                profile_reports(entry)
                explain_report(entry)
                write_artifacts()
                write_json()
                print(f"seed {seed}: {result!r} (rf={rf}, "
                      f"{_time.perf_counter() - t0:.1f}s)")
        except SimulationException as e:
            from ..observe.audit import AuditViolation
            from ..observe.checker import HistoryAnomaly
            if isinstance(e.cause, AuditViolation):
                status = "audit_violation"
            elif isinstance(e.cause, HistoryAnomaly):
                status = "history_anomaly"
            elif isinstance(e.cause, StallError):
                status = "stall"
            elif isinstance(e.cause, HistoryViolation) \
                    and "divergence" in str(e.cause):
                status = "divergence"
            else:
                status = "fail"
            entry.update(status=status,
                         wall_s=round(_time.perf_counter() - t0, 3),
                         error=str(e.cause)[:2000])
            if isinstance(e.cause, HistoryAnomaly):
                # the structured report (named anomalies + sub-histories +
                # flight-recorder timelines) for machine diffing
                entry["history"] = e.cause.report
            if e.audit is not None:
                entry["audit"] = e.audit
            # the flight recording is MOST valuable on a failed seed: write
            # whatever was captured up to the failure point
            try:
                profile_reports(entry)
            except Exception:  # noqa: BLE001 — never mask the real failure
                pass
            try:
                # forensics on the FAILED trajectory: where did this run
                # causally depart from the reference?
                explain_report(entry)
            except Exception:  # noqa: BLE001 — never mask the real failure
                pass
            write_artifacts()
            write_json()
            if isinstance(e.cause, StallError):
                # actionable stall artifact for CI / seed-range sweeps: the
                # wait-graph + status-frontier dump, then a nonzero exit —
                # never rely on an external `timeout` kill for this signal
                print(f"seed {seed}: STALL after "
                      f"{_time.perf_counter() - t0:.1f}s\n{e.cause.dump}")
                raise SystemExit(2)
            raise
    write_json()


if __name__ == "__main__":
    main()
