"""Hostile-network fault injection: periodically re-randomized per-link behavior.

Capability parity with the reference burn's link chaos
(``accord.impl.basic.Cluster`` — overrideLinks/partition/linkOverrideSupplier,
Cluster.java:455-459,615-760; ``NodeSink.Action``, NodeSink.java:45): every
``interval_s`` of sim-time the whole link table is re-rolled:

- with a per-run biased probability, a **network partition** cuts a random
  minority (up to ``(rf+1)//2 - 1`` nodes, so every shard keeps a live quorum
  on the majority side) off from the rest — messages crossing the boundary DROP;
- on top, a random **override kind** is applied: NONE, PAIRED_UNIDIRECTIONAL
  (each node paired with one other, one direction overridden), RANDOM_UNIDIRECTIONAL
  or RANDOM_BIDIRECTIONAL (a random set of links overridden).  Overridden links
  get a per-message weighted action distribution over
  {DELIVER, DROP, DELIVER_WITH_FAILURE, FAILURE} and/or inflated latencies.

The schedule itself is driven by the cluster's deterministic queue, so the whole
fault pattern replays from the seed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..utils.random import RandomSource
from .cluster import Cluster, LinkConfig

_ACTIONS = (LinkConfig.DELIVER, LinkConfig.DROP,
            LinkConfig.DELIVER_WITH_FAILURE, LinkConfig.FAILURE)


class _LinkOverride:
    """One overridden link: per-message weighted action pick and/or a latency
    override (linkOverrideSupplier, Cluster.java:692-711)."""

    __slots__ = ("rng", "weights", "latency_range")

    def __init__(self, rng: RandomSource, weights: Optional[List[float]],
                 latency_range: Optional[Tuple[int, int]]):
        self.rng = rng
        self.weights = weights                    # None => keep default action
        self.latency_range = latency_range        # None => keep default latency

    def action(self) -> Optional[str]:
        if self.weights is None:
            return None
        r = self.rng.next_float() * sum(self.weights)
        acc = 0.0
        for w, a in zip(self.weights, _ACTIONS):
            acc += w
            if r < acc:
                return a
        return _ACTIONS[-1]

    def latency_us(self) -> Optional[int]:
        if self.latency_range is None:
            return None
        lo, hi = self.latency_range
        return self.rng.next_int(lo, hi)


class RandomizedLinkConfig(LinkConfig):
    """LinkConfig whose behavior is re-rolled every ``interval_s`` sim-seconds.

    ``heal()`` permanently restores a benign network (used by the burn once all
    ops have resolved, mirroring the reference's noMoreWorkSignal cancelling the
    chaos task)."""

    KINDS = ("none", "paired_uni", "random_uni", "random_bidi")

    def __init__(self, rng: RandomSource, rf: int, interval_s: float = 5.0,
                 min_latency_us: int = 500, max_latency_us: int = 20_000):
        super().__init__(rng, min_latency_us, max_latency_us)
        self.rf = rf
        self.interval_s = interval_s
        # per-run biased partition coin (Cluster.java:719 biasedUniformBools)
        self.partition_chance = rng.next_float()
        self.partitioned: frozenset = frozenset()
        # ASYMMETRIC partitions (reference Cluster.java overrideLinks
        # supports per-link asymmetry), behind the same per-run biased coin:
        # - one-way cut: the minority side's links fail in ONE direction
        #   only (it can hear but not be heard, or speak but not be heard
        #   back — "deaf"/"mute" halves of a failing NIC);
        # - bridge partial partition: two sides cannot reach each other
        #   directly, but a bridge node talks to both (a half-healed
        #   spanning link) — no side is fully cut off yet no quorum sees
        #   the full membership.
        self.asym_chance = rng.next_float()
        self.partition_mode = "sym"      # sym | oneway_out | oneway_in | bridge
        self.bridge: frozenset = frozenset()   # bridge node(s) for "bridge"
        self.overrides: Dict[Tuple[int, int], _LinkOverride] = {}
        self.healed = False
        self._nodes: List[int] = []
        self._task = None

    # -- wiring ---------------------------------------------------------------
    def attach(self, cluster: Cluster) -> None:
        """Register the re-randomization task on the cluster queue (the chaos
        recurring task, Cluster.java:455-459), retaining the handle so
        ``heal`` can CANCEL it — the ``healed`` no-op guard alone left the
        reroll firing (and drawing rng) forever after quiesce."""
        self._cluster = cluster
        self._nodes = sorted(cluster.nodes)

        def reroll():
            if not self.healed:
                # refresh the node set each re-roll: elastic membership
                # spawns processes mid-burn, and a snapshot taken at attach
                # would leave every joiner permanently exempt from
                # partitions and link faults (membership would not be a
                # fault axis for the very nodes it adds).  Down nodes stay
                # in the pool (they restart; and for non-elastic runs
                # nodes|down is constant, so trajectories are unchanged)
                self._nodes = sorted(set(cluster.nodes) | cluster.down)
                self.randomize()

        self._task = cluster.scheduler.recurring(self.interval_s, reroll)
        self.randomize()

    def heal(self) -> None:
        self.healed = True
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.partitioned = frozenset()
        self.overrides = {}

    # -- the re-roll ----------------------------------------------------------
    def randomize(self) -> None:
        rng = self.rng
        # partition: minority side cut off (Cluster.java:615-622), with the
        # asymmetric variants behind their own per-run biased coin
        self.partitioned = frozenset()
        self.partition_mode = "sym"
        self.bridge = frozenset()
        if self._nodes and rng.next_float() < self.partition_chance:
            size = rng.next_int((self.rf + 1) // 2)
            if size > 0:
                picks = list(self._nodes)
                rng.shuffle(picks)
                self.partitioned = frozenset(picks[:size])
                if rng.next_float() < self.asym_chance:
                    self.partition_mode = rng.pick(
                        ["oneway_out", "oneway_in", "bridge"])
                    if self.partition_mode == "bridge":
                        rest = [n for n in picks[size:]]
                        if rest:
                            self.bridge = frozenset(rest[:1])
                        else:
                            self.partition_mode = "sym"
        # link overrides (Cluster.java:714-741)
        self.overrides = {}
        kind = rng.pick(list(self.KINDS))
        if kind == "none" or len(self._nodes) < 2:
            return
        if kind == "paired_uni":
            picks = list(self._nodes)
            rng.shuffle(picks)
            for i in range(0, len(picks) - 1, 2):
                self.overrides[(picks[i], picks[i + 1])] = self._make_override()
        else:
            bidi = kind == "random_bidi"
            n = len(self._nodes)
            count = rng.next_int(1, max(2, n if (bidi or rng.next_boolean())
                                        else max(2, (n * n) // 2)))
            for _ in range(count):
                a = rng.pick(self._nodes)
                b = rng.pick(self._nodes)
                self.overrides[(a, b)] = self._make_override()
                if bidi:
                    self.overrides[(b, a)] = self._make_override()

    def _make_override(self) -> _LinkOverride:
        rng = self.rng
        # OverrideLinkKind: ACTION / LATENCY / BOTH (Cluster.java:690-711)
        which = rng.pick(["action", "latency", "both"])
        weights = None
        latency_range = None
        if which in ("action", "both"):
            weights = [rng.next_float() for _ in _ACTIONS]
            weights[0] += 1.0   # keep DELIVER likeliest so the run stays live
        if which in ("latency", "both"):
            lo = rng.next_int(1_000, 300_000)
            hi = lo + rng.next_int(1_000, 1_700_000)
            latency_range = (lo, hi)
        return _LinkOverride(rng.fork(), weights, latency_range)

    def _partition_drops(self, from_node: int, to_node: int) -> bool:
        """Does the current partition cut this directed link?

        - ``sym``: any link crossing the minority boundary drops (both
          directions — the classic clean partition);
        - ``oneway_out``: only packets FROM the minority drop (it hears the
          world but cannot be heard — mute);
        - ``oneway_in``: only packets TO the minority drop (it speaks but
          hears nothing back — deaf);
        - ``bridge``: links crossing the boundary drop UNLESS either
          endpoint is the bridge node, which talks to both sides."""
        crossing = (from_node in self.partitioned) != (to_node in self.partitioned)
        if not crossing:
            return False
        mode = self.partition_mode
        if mode == "oneway_out":
            return from_node in self.partitioned
        if mode == "oneway_in":
            return to_node in self.partitioned
        if mode == "bridge":
            return from_node not in self.bridge and to_node not in self.bridge
        return True

    # -- LinkConfig interface -------------------------------------------------
    def action(self, from_node: int, to_node: int, message=None) -> str:
        if self.healed:
            return LinkConfig.DELIVER
        if self._partition_drops(from_node, to_node):
            return LinkConfig.DROP
        override = self.overrides.get((from_node, to_node))
        if override is not None:
            act = override.action()
            if act is not None:
                return act
        return LinkConfig.DELIVER

    def latency_us(self, from_node: int, to_node: int) -> int:
        if not self.healed:
            override = self.overrides.get((from_node, to_node))
            if override is not None:
                lat = override.latency_us()
                if lat is not None:
                    return lat
        return super().latency_us(from_node, to_node)
