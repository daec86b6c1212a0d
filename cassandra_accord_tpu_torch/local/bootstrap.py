"""Bootstrap: adoption of newly-replicated ranges on topology change.

Capability parity with ``accord.local.Bootstrap`` (Bootstrap.java:83-494, doc :51-82):
when a topology change gives a command store ranges it did not previously replicate,
the store must (1) fence the past with a coordinated **exclusive sync point** over the
new ranges, (2) fetch the data those ranges held before (``DataStore.fetch`` from
prior-epoch replicas, complete up to the sync point since sources applied it),
(3) mark ``bootstrapped_at`` in RedundantBefore — older dependencies are then
implicitly satisfied by the fetched snapshot — and re-evaluate any transactions that
were waiting on pre-bootstrap dependencies.  Until then the ranges are marked
pending so reads are refused (served by other replicas) while writes apply normally.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List

from ..primitives.keys import Ranges
from ..utils import async_ as au

if TYPE_CHECKING:
    from .command_store import CommandStore
    from .node import Node


def refence_backoff(node: "Node", store: "CommandStore", delay: float) -> float:
    """Stretch a re-fencing delay by the store's unapplied pressure (txns
    decided ``refence_pressure_age_s`` ago with no local apply — the
    condition the auditor's ``slo.unapplied`` plane flags), capped at
    ``refence_backoff_max_s``.  Shared by the bootstrap retry ladder and the
    staleness catch-up escalation: both allocate fresh fence sync points and
    re-mark ``bootstrapped_at``, and firing them faster than in-flight reads
    assemble partial coverage is the seed-6 bootstrap-refencing wedge."""
    cfg = getattr(node, "config", None)
    age_s = cfg.refence_pressure_age_s if cfg is not None else 10.0
    cap_s = cfg.refence_backoff_max_s if cfg is not None else 30.0
    pressure = store.unapplied_pressure(age_s)
    if pressure <= 0:
        return delay
    obs = getattr(node, "observer", None)
    if obs is not None:
        obs.registry.counter("bootstrap.refence_backoffs",
                             node=node.id, store=store.id).inc()
    return min(max(delay, 1.0) * (1.0 + pressure), max(cap_s, delay))


class Bootstrap:
    """One bootstrap attempt for one store's added ranges at one epoch."""

    def __init__(self, node: "Node", store: "CommandStore", ranges: Ranges,
                 epoch: int, catch_up: bool = False):
        self.node = node
        self.store = store
        self.ranges = ranges
        self.epoch = epoch
        # catch-up mode: re-running the ladder IN PLACE for a stale range
        # (data lost to a truncation gap) — fetch sources from fence-epoch
        # peers instead of the prior topology (staleUntilAtLeast analog)
        self.catch_up = catch_up
        self.result = au.settable()
        self.attempts = 0
        # retry budget (local/overload.py): every rung of the ladder allocates
        # a fresh fence ESP that peers must then recover or invalidate — a
        # whole-cluster refencing storm (KNOWN_ISSUES round 7) is many such
        # ladders outrunning the heal rate.  The bucket bounds this store's
        # rung rate; a denied rung stretches to the refence cap instead of
        # firing.  None when the knob is off (default).
        self._budget = None
        cfg = getattr(node, "config", None)
        if cfg is not None and cfg.retry_budget_enabled:
            from .overload import TokenBucket
            self._budget = TokenBucket(
                cfg.retry_budget_rate_s, cfg.retry_budget_burst,
                cfg.retry_budget_jitter,
                salt=(node.id << 16) ^ (store.id + 0x5BD1) ^ epoch,
                now_s=node.now_micros() / 1e6)

    def _retry_delay(self) -> float:
        """Exponential backoff for the attempt ladder (Bootstrap.Attempt).
        Under chaos+churn a flat cadence floods stores with abandoned fence
        sync points (each attempt allocates a fresh ExclusiveSyncPoint txn
        that then needs recovery/invalidation) — the hostile matrix went
        superlinear on exactly this."""
        self.attempts += 1
        # exponent capped BEFORE exponentiation: 2.0**1024 raises
        # OverflowError, and a long-starved bootstrap (a quorumless range
        # retrying through a whole hostile run) gets past 1024 attempts —
        # values are identical below the cap (2**5 already saturates the 8s
        # ceiling)
        delay = min(0.5 * (2.0 ** min(self.attempts - 1, 8)), 8.0)
        # re-fencing cooperates with in-flight reads (the seed-6 wedge):
        # every retry rung allocates a FRESH fence ESP and re-marks
        # bootstrapped_at at the higher id.  While the store carries
        # unapplied pressure (txns decided long ago, not applied — the
        # slo.unapplied condition), the ladder is outrunning partial-read
        # coverage assembly: stretch the rung so the reads win the race.
        delay = refence_backoff(self.node, self.store, delay)
        if self._budget is not None and not self._budget.try_acquire(
                self.node.now_micros() / 1e6):
            # budget denied: this rung would join a refencing herd — stretch
            # it to the cap so the bucket refills before the next attempt
            cfg = self.node.config
            delay = max(delay, cfg.refence_backoff_max_s)
            counters = getattr(self.node, "overload_counters", None)
            if counters is not None:
                counters["budget_denied"] += 1
            obs = getattr(self.node, "observer", None)
            if obs is not None:
                obs.registry.counter("overload.budget_denied",
                                     node=self.node.id,
                                     store=self.store.id).inc()
        return delay

    def start(self) -> au.AsyncResult:
        self.store.pending_bootstrap = self.store.pending_bootstrap.union(self.ranges)
        self._attempt()
        return self.result

    def _attempt(self) -> None:
        """One sync-point attempt.  The fence id is allocated FIRST and
        ``bootstrapped_at`` marked with it BEFORE coordination
        (Bootstrap.java markBootstrapping): the bootstrapping store then elides
        pre-bootstrap dependencies — the fetched snapshot covers them — so the
        fence itself (and txns committed during bootstrap) can apply here.
        Without the early mark, a blocking fence over ranges whose replica set
        fully changed deadlocks: its apply quorum needs the NEW replicas, whose
        applies wait on data only the post-fence fetch can deliver."""
        from ..primitives.timestamp import Domain, TxnKind
        txn_id = self.node.next_txn_id(TxnKind.EXCLUSIVE_SYNC_POINT, Domain.RANGE)

        def mark(safe_store):
            from .durability import RedundantBefore
            self.store.redundant_before = self.store.redundant_before.merge(
                RedundantBefore.of(self.ranges, bootstrapped_at=txn_id))
            # re-evaluate pre-existing waiters ONCE per bootstrap (and again on
            # finish): the new fence's own WaitingOn is built AFTER this mark
            # and elides via the live bounds, so retry rungs gain nothing from
            # a rescan — per-rung rescans made churn quiesce O(rungs x edges)
            # (waiters whose deps fall between successive fence ids drain via
            # the progress log or the finish re-evaluation)
            if self.attempts == 0:
                _reevaluate_waiting(safe_store, self.ranges)
            self.node.sync_point(self.ranges, exclusive=True, blocking=True,
                                 txn_id=txn_id).add_listener(self._on_sync_point)

        self.store.execute(mark)

    def _on_sync_point(self, sync_point, failure) -> None:
        if failure is not None:
            # retry ladder (Bootstrap.Attempt): the agent decides; default retries
            def retry():
                self.node.scheduler.once(self._retry_delay(), self._attempt)
            self.node.agent.on_failed_bootstrap("sync point", self.ranges, retry,
                                                failure)
            return
        fetch_done = au.settable()
        self._fetch(sync_point, fetch_done)
        fetch_done.add_listener(
            lambda _v, f: self._on_fetched(sync_point, f))

    def _fetch(self, sync_point, fetch_done: au.Settable) -> None:
        class FetchRanges:
            def fetched(self_inner, ranges: Ranges) -> None:
                if not fetch_done.is_done():
                    fetch_done.set_success(ranges)

            def fail(self_inner, failure: BaseException) -> None:
                if not fetch_done.is_done():
                    fetch_done.set_failure(failure)

        import inspect
        supports_catch_up = "catch_up" in inspect.signature(
            self.node.data_store.fetch).parameters

        def run(safe_store):
            if supports_catch_up:
                self.node.data_store.fetch(self.node, safe_store, self.ranges,
                                           sync_point, FetchRanges(),
                                           catch_up=self.catch_up)
            else:
                # DataStore impls without catch-up support (SPI default);
                # a catch-up Bootstrap REQUIRES the stronger contract
                # (prior-topology mode can report lost ranges 'trivially
                # complete', silently masking data loss)
                assert not self.catch_up, \
                    "catch-up bootstrap needs a catch_up-aware DataStore.fetch"
                self.node.data_store.fetch(self.node, safe_store, self.ranges,
                                           sync_point, FetchRanges())

        self.store.execute(run)

    def _on_fetched(self, sync_point, failure) -> None:
        if failure is not None:
            def retry():
                self.node.scheduler.once(
                    self._retry_delay(),
                    lambda: self._on_sync_point(sync_point, None))
            self.node.agent.on_failed_bootstrap("fetch", self.ranges, retry, failure)
            return

        def finish(safe_store):
            from .durability import RedundantBefore
            store = self.store
            store.redundant_before = store.redundant_before.merge(
                RedundantBefore.of(self.ranges, bootstrapped_at=sync_point.txn_id))
            store.pending_bootstrap = store.pending_bootstrap.without(self.ranges)
            _reevaluate_waiting(safe_store, self.ranges)
            self.result.set_success(sync_point)

        self.store.execute(finish)


def _reevaluate_waiting(safe_store, ranges=None) -> None:
    """Drop now-redundant (pre-bootstrap) deps from every waiting command and
    try to execute it (Commands re-evaluation after bootstrappedAt advances).

    Runs on every bootstrap mark/finish — including each rung of the retry
    ladder — so the scan is aggressively filtered:

    - ``ranges``: the mark only advanced bounds on the bootstrapped ranges, so
      only deps whose footprint intersects them can have become redundant;
    - store-wide max-bound gate (a dep at/above the max locally-redundant
      bound anywhere is unprunable);
    - per-edge participants are cached on the store (immutable per deps
      object; rebuilding the key unions per rung dominated churn quiesce);
    - redundancy verdicts are memoised per (dep, footprint) within a pass."""
    from . import commands as C
    store = safe_store.store
    redundant = store.redundant_before
    max_bound = redundant.max_locally_redundant_over(store.all_ranges())
    if max_bound is None:
        return
    memo: dict = {}
    parts_cache = getattr(store, "_dep_parts_cache", None)
    if parts_cache is None:
        parts_cache = store._dep_parts_cache = {}
    elif len(parts_cache) > 50_000:
        parts_cache.clear()
    for command in list(store.commands.values()):
        waiting = command.waiting_on
        if waiting is None or not waiting.is_waiting():
            continue
        deps = command.partial_deps
        for dep_id in list(waiting.waiting):
            if not dep_id < max_bound:
                continue
            ck = (command.txn_id, dep_id)
            ent = parts_cache.get(ck)
            if ent is None or ent[0] is not deps:
                parts = deps.participants(dep_id) if deps is not None else None
                if parts is None:
                    parts_cache[ck] = (deps, None, None)
                    continue
                keys, rngs = parts
                mk = (dep_id, tuple(keys), tuple((r.start, r.end) for r in rngs))
                ent = parts_cache[ck] = (deps, parts, mk)
            _d, parts, mk = ent
            if parts is None:
                continue
            if ranges is not None and not _parts_intersect(parts, ranges):
                continue
            hit = memo.get(mk)
            if hit is None:
                hit = memo[mk] = redundant.is_locally_redundant(dep_id, parts)
            if hit:
                # elided below the advancing bootstrap bound: the write
                # arrives with the fetch, not a local apply — noted so the
                # read-serve path treats its slices as at-risk until it
                # proves the dep landed (grandfathered serve)
                C._note_elided_unless_applied(safe_store, command, dep_id)
                waiting.remove(dep_id, True)
                store.resolver.remove_waiting(command.txn_id, dep_id)
                dep = safe_store.get_if_exists(dep_id)
                if dep is not None:
                    dep.listeners.discard(command.txn_id)
        if not waiting.is_waiting():
            C.maybe_execute(safe_store, command, always_notify_listeners=False)


def _parts_intersect(parts, ranges: Ranges) -> bool:
    keys, rngs = parts
    for k in keys:
        if ranges.contains(k):
            return True
    for r in rngs:
        if ranges.intersects(Ranges.of(r)):
            return True
    return False
