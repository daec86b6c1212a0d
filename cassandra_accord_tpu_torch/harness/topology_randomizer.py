"""Random topology mutations for the burn test.

Capability parity with ``accord.burn.TopologyRandomizer`` (TopologyRandomizer.java:1-524):
periodically mutate the cluster topology — move a replica between nodes, split a
shard's range, merge adjacent shards — driving live epoch adoption, bootstrap
(data fetch + exclusive sync point fencing) and epoch-sync machinery under load.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Iterable, List, Optional

from ..primitives.keys import Range, Ranges
from ..topology.topology import Shard, Topology
from ..utils.random import RandomSource

if TYPE_CHECKING:
    from .cluster import Cluster


class TopologyRandomizer:
    """``elastic=True`` grows the mutation mix with **join** (a node outside
    the current member set — spawned via ``Cluster.add_node`` from
    ``spawn_pool`` when no live non-member exists — takes a replica slot)
    and **leave** (a member hands off every shard it replicates to live
    peers in one epoch, ``Cluster.decommission``).  Every mutation respects
    the muted-quorum floor at range granularity (``_keeps_clean_quorum``)."""

    def __init__(self, cluster: "Cluster", rng: RandomSource,
                 candidate_nodes: Optional[List[int]] = None,
                 elastic: bool = False,
                 spawn_pool: Optional[List[int]] = None):
        self.cluster = cluster
        self.rng = rng
        self.candidates = sorted(candidate_nodes or cluster.nodes)
        self.elastic = elastic
        # node ids this randomizer may bring to life (never yet members)
        self.spawn_pool = sorted(spawn_pool or ())
        # member-count bounds for the churn-mix join/leave actions; set by
        # MembershipNemesis (its resolved membership_{min,max}_members) so
        # BOTH membership planes honor the configured bounds — None leaves
        # only the structural floors (rf, spawn-pool exhaustion)
        self.min_members: Optional[int] = None
        self.max_members: Optional[int] = None

    def _live_candidates(self) -> List[int]:
        """Move targets: the static candidate list, or — elastic — every
        live, non-drained process (joined nodes become move targets too)."""
        if self.elastic:
            return [n for n in sorted(self.cluster.nodes)
                    if n not in self.cluster.down
                    and n not in self.cluster.decommissioned]
        return self.candidates

    # -- the clean-replica floor ---------------------------------------------
    def _unreadable_at(self, node_id: int, rng_: Range) -> bool:
        """Is ``node_id``'s copy of ``rng_`` currently unreadable — the node
        muted (down/paused/journal-stalled), or the range overlapping its
        pending-bootstrap or stale marks?"""
        from .nemesis import muted_nodes
        cluster = self.cluster
        if node_id in muted_nodes(cluster):
            return True
        node = cluster.nodes.get(node_id)
        if node is None:
            return True
        probe = Ranges.of(rng_)
        for cs in node.command_stores.all_stores():
            if cs.pending_bootstrap and cs.pending_bootstrap.intersects(probe):
                return True
        stale = getattr(cluster.stores.get(node_id), "stale_ranges", None)
        if stale is not None and len(stale) and stale.intersects(probe):
            return True
        return False

    def _keeps_clean_quorum(self, shard: Shard,
                            joining: Iterable[int] = ()) -> bool:
        """Would ``shard`` (a candidate post-mutation shard) keep a READABLE
        slow-path quorum — replicas that are live, not muted, not mid-
        bootstrap/stale on the range, and not the about-to-bootstrap
        newcomers?  Stacking a second adoption (or join) onto a range whose
        previous adoption has not finished its fetch starves the range of
        clean readable copies: once every current-epoch owner of a slice is
        simultaneously re-fencing, no partial-read union can cover it and
        the range wedges against its own bootstrap fences (the seed-6
        shape).  The muted-quorum floor the nemeses share, extended to the
        churn plane (the reference gates churn globally on
        ``pendingTopologies() > 5``; this is the same idea at range
        granularity)."""
        joining = set(joining)
        clean = sum(1 for n in shard.nodes
                    if n not in joining and not self._unreadable_at(n, shard.range))
        return clean >= shard.slow_path_quorum_size

    def maybe_update_topology(self) -> Optional[Topology]:
        """Apply one random mutation; returns the new topology (or None if the
        chosen mutation was not applicable).

        Gated on outstanding bootstraps, matching the reference
        (TopologyRandomizer.java:434 ``pendingTopologies() > 5 -> skip``):
        un-gated churn outruns bootstrap completion and drives the cluster
        into a pending-bootstrap blanket — every replica's copy of most keys
        pending, reads unable to assemble coverage from any union, and the
        bootstrap fences those reads gate stuck behind them.  The reference
        never exercises that regime; neither should the harness."""
        # distinct pending ranges cluster-wide ~ topologies in flight (one
        # mutation bootstraps 1-2 distinct ranges across its replicas) —
        # counting per-store pieces over-gates by ~replication factor
        pending = {rng for node in self.cluster.nodes.values()
                   for cs in node.command_stores.all_stores()
                   for rng in (cs.pending_bootstrap or ())}
        if len(pending) > 5:
            return None
        current = self.cluster.topologies[-1]
        mutations = ["move", "move", "split", "merge"]
        if self.elastic:
            mutations += ["join", "leave"]
        mutation = self.rng.pick(mutations)
        shards = list(current.shards)
        if mutation == "move":
            new_shards = self._move(shards)
        elif mutation == "split":
            new_shards = self._split(shards)
        elif mutation == "join":
            new_shards = self._join(shards, current)
        elif mutation == "leave":
            new_shards = self._leave(shards, current)
        else:
            new_shards = self._merge(shards)
        if new_shards is None:
            return None
        topology = Topology(current.epoch + 1, new_shards)
        self.cluster.update_topology(topology)
        return topology

    # -- mutations -----------------------------------------------------------
    def _move(self, shards: List[Shard]) -> Optional[List[Shard]]:
        """Replace one replica of one shard with a node not currently in it."""
        idx = self.rng.next_int(len(shards))
        shard = shards[idx]
        outside = [n for n in self._live_candidates() if n not in shard.nodes]
        if not outside:
            return None
        newcomer = self.rng.pick(outside)
        leaver = self.rng.pick(list(shard.nodes))
        replicas = [newcomer if n == leaver else n for n in shard.nodes]
        new_shard = Shard(shard.range, replicas)
        if not self._keeps_clean_quorum(new_shard, joining=(newcomer,)):
            return None
        shards[idx] = new_shard
        return shards

    def _split(self, shards: List[Shard]) -> Optional[List[Shard]]:
        """Split one shard's range at an interior point."""
        idx = self.rng.next_int(len(shards))
        shard = shards[idx]
        start, end = shard.range.start, shard.range.end
        sv, ev = getattr(start, "value", None), getattr(end, "value", None)
        if not isinstance(sv, int) or not isinstance(ev, int) or ev - sv < 2:
            return None
        mid = sv + 1 + self.rng.next_int(ev - sv - 1)
        cls = type(start)
        prefix = getattr(start, "prefix", 0)
        mid_key = cls(mid, prefix)
        shards[idx: idx + 1] = [Shard(Range(start, mid_key), list(shard.nodes)),
                                Shard(Range(mid_key, end), list(shard.nodes))]
        return shards

    def _join(self, shards: List[Shard], current) -> Optional[List[Shard]]:
        """Bring a NON-MEMBER into the member set: a live node outside every
        shard (preferring an already-running non-member — e.g. a previously
        drained one — else a fresh process from ``spawn_pool`` via
        ``Cluster.add_node``) replaces one replica of one shard.  The
        newcomer bootstraps the range from live peers; the clean-quorum
        floor counts it unavailable until its fetch lands."""
        cluster = self.cluster
        members = current.nodes()
        if self.max_members is not None and len(members) >= self.max_members:
            return None
        live_outside = [n for n in sorted(cluster.nodes)
                        if n not in members and n not in cluster.down]
        spawnable = [n for n in self.spawn_pool if n not in cluster.nodes
                     and n not in cluster.down]
        if not live_outside and not spawnable:
            return None
        idx = self.rng.next_int(len(shards))
        shard = shards[idx]
        pool = live_outside if live_outside else spawnable
        newcomer = self.rng.pick(pool)
        leaver = self.rng.pick(list(shard.nodes))
        replicas = [newcomer if n == leaver else n for n in shard.nodes]
        new_shard = Shard(shard.range, replicas)
        # floor check BEFORE spawning (it only inspects existing members —
        # the newcomer is excluded via ``joining``): a refused join must not
        # leak a memberless fresh process into the cluster
        if not self._keeps_clean_quorum(new_shard, joining=(newcomer,)):
            return None
        if newcomer not in cluster.nodes:
            cluster.add_node(newcomer)   # counts node_joins itself
        else:
            # an already-running non-member (e.g. previously drained)
            # re-entering the member set is a join too — without this the
            # --json fault summary reports 0 joins for a rejoin-only run
            cluster._count("node_joins")
        cluster.decommissioned.discard(newcomer)   # a drained node can rejoin
        shards[idx] = new_shard
        return shards

    def _leave(self, shards: List[Shard], current) -> Optional[List[Shard]]:
        """A member hands off and leaves EVERY shard in one epoch (the
        ``Cluster.decommission`` shape, driven through the randomizer so the
        leave epoch interleaves with move/split/merge churn).  Replacements
        are live members; each affected shard must keep a clean readable
        quorum counting the (bootstrapping) replacement unavailable.  The
        leaver's process stays live serving prior epochs."""
        cluster = self.cluster
        members = sorted(current.nodes())
        if len(members) <= max(s.rf() for s in shards):
            return None   # nobody can be spared: every member is needed
        if self.min_members is not None and len(members) <= self.min_members:
            return None
        leaver = self.rng.pick(members)
        out = cluster.plan_handoff(
            shards, leaver,
            candidate_pool=[n for n in members
                            if n != leaver and n not in cluster.down
                            and n not in cluster.decommissioned],
            shard_ok=lambda new_shard, pick: self._keeps_clean_quorum(
                new_shard, joining=(pick,)))
        if out is None:
            return None
        cluster.decommissioned.add(leaver)
        cluster._count("node_decommissions")
        return out

    def _merge(self, shards: List[Shard]) -> Optional[List[Shard]]:
        """Merge two adjacent shards (the survivors' replicas bootstrap the
        merged range)."""
        if len(shards) < 2:
            return None
        idx = self.rng.next_int(len(shards) - 1)
        a, b = shards[idx], shards[idx + 1]
        if a.range.end != b.range.start or a.rf != b.rf:
            return None
        shards[idx: idx + 2] = [Shard(Range(a.range.start, b.range.end),
                                      list(a.nodes))]
        return shards
