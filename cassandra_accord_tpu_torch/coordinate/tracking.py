"""Per-shard quorum trackers driving coordinator state machines.

Capability parity with ``accord.coordinate.tracking`` (AbstractTracker.java,
QuorumTracker.java, FastPathTracker.java:33-160, ReadTracker.java,
RecoveryTracker.java): a tracker owns one ShardTracker per (epoch, shard) across the
contacted Topologies and aggregates per-shard outcomes into an overall RequestStatus.
"""
from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..topology.topology import Shard, Topologies
from ..utils.invariants import check_state


class RequestStatus(enum.Enum):
    NO_CHANGE = 0
    SUCCESS = 1
    FAILED = 2


class ShardTracker:
    __slots__ = ("shard", "successes", "failures")

    def __init__(self, shard: Shard):
        self.shard = shard
        self.successes: Set[int] = set()
        self.failures: Set[int] = set()

    def has_reached_quorum(self) -> bool:
        return len(self.successes) >= self.shard.slow_path_quorum_size

    def has_failed(self) -> bool:
        return len(self.failures) > self.shard.max_failures

    def has_in_flight(self) -> bool:
        return len(self.successes) + len(self.failures) < self.shard.rf()


class AbstractTracker:
    """Tracks one ShardTracker per unique (epoch, shard)."""

    def __init__(self, topologies: Topologies, tracker_cls=ShardTracker):
        self.topologies = topologies
        self.trackers: List = []
        self._by_node: Dict[int, List] = {}
        for topology in topologies:
            for shard in topology.shards:
                t = tracker_cls(shard)
                self.trackers.append(t)
                for n in shard.nodes:
                    self._by_node.setdefault(n, []).append(t)
        self.waiting_on_shards = len(self.trackers)

    def nodes(self) -> List[int]:
        return sorted(self._by_node.keys())

    def trackers_for(self, node: int) -> List:
        return self._by_node.get(node, [])

    def _all_success(self, predicate) -> bool:
        return all(predicate(t) for t in self.trackers)


class QuorumTracker(AbstractTracker):
    """Simple-majority per shard (QuorumTracker.java)."""

    def record_success(self, node: int) -> RequestStatus:
        newly = False
        for t in self.trackers_for(node):
            if node in t.successes or node in t.failures:
                continue
            pre = t.has_reached_quorum()
            t.successes.add(node)
            if not pre and t.has_reached_quorum():
                newly = True
        if newly and self._all_success(ShardTracker.has_reached_quorum):
            return RequestStatus.SUCCESS
        return RequestStatus.NO_CHANGE

    def record_failure(self, node: int) -> RequestStatus:
        for t in self.trackers_for(node):
            if node in t.successes or node in t.failures:
                continue
            t.failures.add(node)
            if t.has_failed():
                return RequestStatus.FAILED
        return RequestStatus.NO_CHANGE

    def has_reached_quorum(self) -> bool:
        return self._all_success(ShardTracker.has_reached_quorum)


class FastPathShardTracker(ShardTracker):
    __slots__ = ("fast_path_accepts", "fast_path_rejects")

    def __init__(self, shard: Shard):
        super().__init__(shard)
        self.fast_path_accepts: Set[int] = set()
        self.fast_path_rejects: Set[int] = set()

    def has_met_fast_path_criteria(self) -> bool:
        return len(self.fast_path_accepts) >= self.shard.fast_path_quorum_size

    def has_rejected_fast_path(self) -> bool:
        return self.shard.rejects_fast_path(len(self.fast_path_rejects))


class FastPathTracker(AbstractTracker):
    """PreAccept tracker (FastPathTracker.java:33-160): counts fast-path votes
    (witnessedAt == txnId) within each shard's electorate alongside the slow-path
    quorum.  SUCCESS fires once all shards have a slow quorum AND the fast-path
    outcome is decided (achieved everywhere or rejected somewhere)."""

    def __init__(self, topologies: Topologies):
        super().__init__(topologies, FastPathShardTracker)

    def record_success(self, node: int, with_fast_path_vote: bool) -> RequestStatus:
        for t in self.trackers_for(node):
            if node in t.successes or node in t.failures:
                continue
            t.successes.add(node)
            if node in t.shard.fast_path_electorate:
                if with_fast_path_vote:
                    t.fast_path_accepts.add(node)
                else:
                    t.fast_path_rejects.add(node)
        return self._status()

    def record_failure(self, node: int) -> RequestStatus:
        for t in self.trackers_for(node):
            if node in t.successes or node in t.failures:
                continue
            t.failures.add(node)
            # an unreachable electorate member can no longer vote for the fast path
            if node in t.shard.fast_path_electorate:
                t.fast_path_rejects.add(node)
            if t.has_failed():
                return RequestStatus.FAILED
        return self._status()

    def _status(self) -> RequestStatus:
        if not self._all_success(ShardTracker.has_reached_quorum):
            return RequestStatus.NO_CHANGE
        # quorum reached everywhere: success once fast-path is decided
        if self.has_fast_path_accepted():
            return RequestStatus.SUCCESS
        for t in self.trackers:
            if not t.has_rejected_fast_path() and not t.has_met_fast_path_criteria() \
                    and t.has_in_flight():
                return RequestStatus.NO_CHANGE  # fast path still undecided; keep waiting
        return RequestStatus.SUCCESS

    def has_fast_path_accepted(self) -> bool:
        return self._all_success(FastPathShardTracker.has_met_fast_path_criteria)

    def fast_path_votes(self) -> Tuple[int, int]:
        """(accepts, rejects) electorate vote totals across every shard — the
        observability accessor behind the flight recorder's
        ``txn.fastpath.votes_*`` counters (why a txn went slow-path is the
        first question a latency investigation asks)."""
        accepts = sum(len(t.fast_path_accepts) for t in self.trackers)
        rejects = sum(len(t.fast_path_rejects) for t in self.trackers)
        return accepts, rejects


class ReadShardTracker(ShardTracker):
    __slots__ = ("data_received", "in_flight_reads")

    def __init__(self, shard: Shard):
        super().__init__(shard)
        self.data_received = False
        self.in_flight_reads: Set[int] = set()


class ReadTracker(AbstractTracker):
    """One successful data read per shard, with retry on failure
    (ReadTracker.java slow-replica speculation simplified to failure-retry)."""

    def __init__(self, topologies: Topologies):
        super().__init__(topologies, ReadShardTracker)
        self._contacted: Set[int] = set()

    def initial_contacts(self, prefer: Optional[int] = None,
                         rotate: int = 0,
                         avoid: frozenset = frozenset()) -> List[int]:
        """Pick one replica per shard (preferring ``prefer`` — normally self).

        ``rotate`` shifts EVERY shard's pick index by that many positions, so
        retry rounds contact a different replica per shard — a global
        preferred node only rotates shards that contain it.

        ``avoid`` holds replicas the coordinator's gray-failure tracker
        currently marks slow (paused-but-alive, stalled-disk, saturated):
        the pick shifts past them when ANY non-slow alternative exists, so a
        known-slow replica never costs a whole timeout/speculation round.
        When every replica of a shard is marked slow, the base pick stands —
        avoidance must never starve a shard of its read.

        Shards already marked ``data_received`` are skipped: a retry round
        with grandfathered partial-read coverage (coordinate_transaction)
        pre-marks fully-covered shards, and re-reading them would burn
        replies — or spurious exhaustion — on data already banked."""
        out: Set[int] = set()
        for t in self.trackers:
            if t.data_received:
                continue
            nodes = t.shard.nodes
            base = nodes.index(prefer) if prefer in nodes else 0
            pick = nodes[(base + rotate) % len(nodes)]
            if avoid and pick in avoid:
                for off in range(1, len(nodes)):
                    alt = nodes[(base + rotate + off) % len(nodes)]
                    if alt not in avoid:
                        pick = alt
                        break
            t.in_flight_reads.add(pick)
            out.add(pick)
        self._contacted.update(out)
        return sorted(out)

    def speculate(self, avoid: frozenset = frozenset()) -> List[int]:
        """Slow-replica speculation (ReadTracker.java's slow/insufficient
        ladder): for each shard still awaiting data, contact ONE additional
        untried replica WITHOUT failing the in-flight one — a slow replica
        costs only the duplicate read, not a whole reply-timeout round.
        Known-slow candidates (``avoid``) are picked last."""
        extra: Set[int] = set()
        for t in self.trackers:
            if t.data_received:
                continue
            candidates = [n for n in t.shard.nodes
                          if n not in t.failures
                          and n not in t.in_flight_reads]
            if candidates:
                pick = next((n for n in candidates if n not in avoid),
                            candidates[0])
                t.in_flight_reads.add(pick)
                extra.add(pick)
        self._contacted.update(extra)
        return sorted(extra)

    def record_read_success(self, node: int) -> RequestStatus:
        for t in self.trackers_for(node):
            if node in t.in_flight_reads:
                t.in_flight_reads.discard(node)
                t.data_received = True
        if self._all_success(lambda t: t.data_received):
            return RequestStatus.SUCCESS
        return RequestStatus.NO_CHANGE

    def record_read_failure(self, node: int,
                            avoid: frozenset = frozenset()) \
            -> Tuple[RequestStatus, List[int]]:
        """Returns (status, additional nodes to contact).  Replacement picks
        prefer replicas NOT currently marked slow (``avoid``)."""
        retries: Set[int] = set()
        for t in self.trackers_for(node):
            t.in_flight_reads.discard(node)
            t.failures.add(node)
            if t.data_received or t.in_flight_reads:
                continue
            candidates = [n for n in t.shard.nodes
                          if n not in t.failures and n not in t.in_flight_reads]
            if not candidates:
                return RequestStatus.FAILED, []
            pick = next((n for n in candidates if n not in avoid),
                        candidates[0])
            t.in_flight_reads.add(pick)
            retries.add(pick)
        self._contacted.update(retries)
        return RequestStatus.NO_CHANGE, sorted(retries)


class RecoveryShardTracker(ShardTracker):
    __slots__ = ("fast_path_rejects",)

    def __init__(self, shard: Shard):
        super().__init__(shard)
        self.fast_path_rejects = 0

    def rejects_fast_path(self) -> bool:
        """True when so many electorate members witnessed the txn at a timestamp
        other than its txnId that the original coordinator cannot have gathered a
        fast-path quorum (RecoveryTracker.java:44-47)."""
        return self.shard.rejects_fast_path(self.fast_path_rejects)


class RecoveryTracker(AbstractTracker):
    """BeginRecovery tracker (RecoveryTracker.java): a slow-path quorum per shard,
    additionally accounting fast-path vote evidence for the recovery decision."""

    def __init__(self, topologies: Topologies):
        super().__init__(topologies, RecoveryShardTracker)

    def record_success(self, node: int, accepts_fast_path: bool) -> RequestStatus:
        newly = False
        for t in self.trackers_for(node):
            if node in t.successes or node in t.failures:
                continue
            pre = t.has_reached_quorum()
            t.successes.add(node)
            if not accepts_fast_path and node in t.shard.fast_path_electorate:
                t.fast_path_rejects += 1
            if not pre and t.has_reached_quorum():
                newly = True
        if newly and self._all_success(ShardTracker.has_reached_quorum):
            return RequestStatus.SUCCESS
        return RequestStatus.NO_CHANGE

    def record_failure(self, node: int) -> RequestStatus:
        for t in self.trackers_for(node):
            if node in t.successes or node in t.failures:
                continue
            t.failures.add(node)
            if t.has_failed():
                return RequestStatus.FAILED
        return RequestStatus.NO_CHANGE

    def rejects_fast_path(self) -> bool:
        return any(t.rejects_fast_path() for t in self.trackers)


class AppliedTracker(QuorumTracker):
    """Tracks Apply acks reaching a quorum (AppliedTracker)."""
