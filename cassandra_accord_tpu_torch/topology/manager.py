"""Per-node epoch ledger with epoch-sync quorum tracking.

Capability parity with ``accord.topology.TopologyManager`` (TopologyManager.java:78-795):
tracks every topology epoch this node has learned, which remote nodes have finished
syncing each epoch (a quorum per shard makes the epoch "synced"), epoch
closure/redundancy marks, and selects the Topologies a coordination round must contact
for a route over [txnId.epoch, executeAt.epoch] — extended downward over unsynced
epochs (``with_unsynced_epochs``) so no dependency can be missed during topology
change.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

from ..primitives.keys import Ranges
from ..utils import async_ as au
from ..utils.invariants import check_argument, check_state
from .topology import Topologies, Topology


class EpochReady:
    """Four stages of epoch adoption (ConfigurationService.java:65): metadata known,
    coordination possible, data bootstrapped, reads allowed."""

    __slots__ = ("epoch", "metadata", "coordination", "data", "reads")

    def __init__(self, epoch: int,
                 metadata: au.AsyncResult = None, coordination: au.AsyncResult = None,
                 data: au.AsyncResult = None, reads: au.AsyncResult = None):
        self.epoch = epoch
        self.metadata = metadata or au.success_result()
        self.coordination = coordination or au.success_result()
        self.data = data or au.success_result()
        self.reads = reads or au.success_result()

    @staticmethod
    def done(epoch: int) -> "EpochReady":
        return EpochReady(epoch)


class _EpochState:
    __slots__ = ("topology", "synced_nodes", "sync_complete", "closed", "redundant",
                 "ready")

    def __init__(self, topology: Topology):
        self.topology = topology
        self.synced_nodes: Set[int] = set()
        self.sync_complete = False
        self.closed: Ranges = Ranges.EMPTY
        self.redundant: Ranges = Ranges.EMPTY
        self.ready: Optional[EpochReady] = None

    def recompute_sync(self) -> None:
        if self.sync_complete:
            return
        for shard in self.topology.shards:
            acks = sum(1 for n in shard.nodes if n in self.synced_nodes)
            if acks < shard.slow_path_quorum_size:
                return
        self.sync_complete = True


class TopologyManager:
    def __init__(self, node_id: int, sorter=None):
        self.node_id = node_id
        self.sorter = sorter
        self._epochs: List[_EpochState] = []   # index 0 = min_epoch
        self._min_epoch = 0
        self._awaiting: Dict[int, List[au.Settable]] = {}
        # sync-complete reports that arrived before we learned the epoch
        self._pending_sync: Dict[int, Set[int]] = {}

    # -- queries ------------------------------------------------------------
    @property
    def min_epoch(self) -> int:
        return self._min_epoch

    @property
    def current_epoch(self) -> int:
        return self._min_epoch + len(self._epochs) - 1 if self._epochs else 0

    def current(self) -> Topology:
        check_state(bool(self._epochs), "no topology known yet")
        return self._epochs[-1].topology

    def has_epoch(self, epoch: int) -> bool:
        return self._min_epoch <= epoch <= self.current_epoch and bool(self._epochs)

    def topology_for_epoch(self, epoch: int) -> Topology:
        check_argument(self.has_epoch(epoch), "unknown epoch %s", epoch)
        return self._epochs[epoch - self._min_epoch].topology

    def is_sync_complete(self, epoch: int) -> bool:
        return self.has_epoch(epoch) and self._epochs[epoch - self._min_epoch].sync_complete

    # -- updates ------------------------------------------------------------
    def on_topology_update(self, topology: Topology,
                           ready_factory: Optional[Callable[[Topology], EpochReady]] = None
                           ) -> EpochReady:
        if self._epochs:
            check_argument(topology.epoch == self.current_epoch + 1,
                           "expected epoch %s, got %s", self.current_epoch + 1, topology.epoch)
        else:
            self._min_epoch = topology.epoch
        state = _EpochState(topology)
        self._epochs.append(state)
        # first epoch has nothing to sync from; mark prior-epoch-less epochs synced
        if len(self._epochs) == 1:
            state.sync_complete = True
        # apply any sync reports that raced ahead of the topology
        for n in self._pending_sync.pop(topology.epoch, ()):  # type: ignore[arg-type]
            state.synced_nodes.add(n)
        state.recompute_sync()
        state.ready = ready_factory(topology) if ready_factory else EpochReady.done(topology.epoch)
        for waiter in self._awaiting.pop(topology.epoch, []):
            waiter.set_success(topology)
        return state.ready

    def on_remote_sync_complete(self, node: int, epoch: int) -> None:
        """``node`` reports it has finished syncing ``epoch``."""
        if not self.has_epoch(epoch):
            if epoch <= self.current_epoch:
                return  # epoch already truncated — stale report
            self._pending_sync.setdefault(epoch, set()).add(node)
            return
        state = self._epochs[epoch - self._min_epoch]
        state.synced_nodes.add(node)
        state.recompute_sync()

    def reload_prior_epoch(self, topology: Topology,
                           synced_nodes: Optional[Set[int]] = None) -> None:
        """Restart path (crash-restart nemesis): re-install a durably-known
        epoch OLDER than the boot epoch.  Topology metadata is durable state
        on a real node — a restarted node must still answer
        ``precise_epochs`` for transactions that started in epochs its
        in-memory manager was rebuilt after.  Prepends strictly-consecutive
        epochs below ``min_epoch``; closure/redundancy marks are volatile and
        conservatively reset (they re-accumulate from durability rounds)."""
        check_state(bool(self._epochs), "boot epoch must be installed first")
        check_argument(topology.epoch == self._min_epoch - 1,
                       "prior-epoch reload must be consecutive: expected %s, got %s",
                       self._min_epoch - 1, topology.epoch)
        state = _EpochState(topology)
        state.synced_nodes = set(synced_nodes or ())
        # the first epoch overall has no predecessor to sync from
        state.sync_complete = topology.epoch == 1
        state.recompute_sync()
        state.ready = EpochReady.done(topology.epoch)
        self._epochs.insert(0, state)
        self._min_epoch = topology.epoch

    def truncate_until(self, epoch: int) -> None:
        """Drop epochs strictly below ``epoch`` (topology GC)."""
        if epoch <= self._min_epoch:
            return
        drop = min(epoch - self._min_epoch, len(self._epochs) - 1)
        if drop > 0:
            self._epochs = self._epochs[drop:]
            self._min_epoch += drop
        for stale in [e for e in self._pending_sync if e < self._min_epoch]:
            del self._pending_sync[stale]
        for stale in [e for e in self._awaiting if e < self._min_epoch]:
            del self._awaiting[stale]

    def on_epoch_closed(self, ranges: Ranges, epoch: int) -> None:
        if self.has_epoch(epoch):
            st = self._epochs[epoch - self._min_epoch]
            st.closed = st.closed.union(ranges)

    def on_epoch_redundant(self, ranges: Ranges, epoch: int) -> None:
        if self.has_epoch(epoch):
            st = self._epochs[epoch - self._min_epoch]
            st.redundant = st.redundant.union(ranges)

    # -- awaiting -----------------------------------------------------------
    def await_epoch(self, epoch: int) -> au.AsyncResult:
        if self.has_epoch(epoch):
            return au.success_result(self.topology_for_epoch(epoch))
        s = au.settable()
        self._awaiting.setdefault(epoch, []).append(s)
        return s

    def fail_epoch_waiters(self, epoch: int, failure: BaseException) -> None:
        """The epoch-fetch watchdog gave up (configuration service
        unreachable): fail every waiter so gated work errors out instead of
        stalling forever (TopologyManager.java epoch-fetch watchdog)."""
        for s in self._awaiting.pop(epoch, []):
            if not s.is_done():
                s.set_failure(failure)

    # -- coordination selection (TopologyManager.java:513+) ------------------
    def precise_epochs(self, unseekables, min_epoch: int, max_epoch: int) -> Topologies:
        """Topologies over [min_epoch, max_epoch], each trimmed to the shards
        intersecting ``unseekables`` (a Route/RoutingKeys/Ranges, or None for all)."""
        check_argument(self.has_epoch(min_epoch) and self.has_epoch(max_epoch),
                       "epochs [%s,%s] not all known", min_epoch, max_epoch)
        return Topologies([self.topology_for_epoch(e).trim(unseekables)
                           for e in range(min_epoch, max_epoch + 1)])

    def with_unsynced_epochs(self, unseekables, min_epoch: int, max_epoch: int) -> Topologies:
        """Like precise_epochs but extended down over epochs that are not both
        sync-complete AND CLOSED over the footprint.  Sync alone is not enough:
        an epoch may be synced while old-epoch transactions are still in flight
        on its replicas — a dependency round that skips them can miss a
        committed-at-old-executeAt txn entirely (the bootstrap-fence
        completeness hole).  Only an applied exclusive sync point closes an
        epoch's ranges to new proposals (TopologyManager epoch closure,
        TopologyManager.java:78-795)."""
        lo = min_epoch
        while lo > self._min_epoch and not (
                self.is_sync_complete(lo - 1)
                and self._closed_over(lo - 1, unseekables)):
            lo -= 1
        return self.precise_epochs(unseekables, lo, max_epoch)

    def _closed_over(self, epoch: int, unseekables) -> bool:
        """Is every part of ``unseekables`` marked closed at ``epoch``?"""
        if not self.has_epoch(epoch):
            return True
        st = self._epochs[epoch - self._min_epoch]
        from ..primitives.route import Route
        parts = unseekables.participants() if isinstance(unseekables, Route) \
            else unseekables
        if parts is None:
            return False
        return st.closed.contains_all(parts)

    def with_open_epochs(self, unseekables, min_epoch: int, max_epoch: int) -> Topologies:
        return self.with_unsynced_epochs(unseekables, min_epoch, max_epoch)
