"""MockCluster: a controllable-reply unit harness for per-phase coordinator
tests.

Capability parity with ``accord.impl.mock.MockCluster`` /
``RecordingMessageSink`` / ``Network`` (impl/mock/MockCluster.java,
CoordinateTransactionTest.java:1-438): real Nodes on the simulated cluster,
with a delivery filter that lets a test HOLD matching requests in flight,
inspect them, and then for each one:

- ``release()`` — deliver normally (the replica processes and replies);
- ``reply(r)``  — swallow the request and deliver a hand-crafted reply to the
  sender's callback (preemptions, stale CheckStatusOk, nacks — states that
  are hard to reach organically);
- ``drop()``    — lose it silently (the sender's reply-timeout fires).

Interceptions are prefix-matched on message type name and optional from/to
node ids; each captures up to ``count`` requests then deactivates.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ..primitives.keys import IntKey, Range, Ranges
from ..primitives.route import Route
from ..primitives.txn import Txn
from ..topology.topology import Shard, Topology
from ..utils import async_ as au
from .cluster import Cluster, ReplyContext


class Held:
    """One intercepted request, frozen mid-flight."""

    __slots__ = ("mock", "from_node", "to_node", "request", "msg_id",
                 "has_callback", "done")

    def __init__(self, mock: "MockCluster", from_node: int, to_node: int,
                 request, msg_id: int, has_callback: bool):
        self.mock = mock
        self.from_node = from_node
        self.to_node = to_node
        self.request = request
        self.msg_id = msg_id
        self.has_callback = has_callback
        self.done = False

    def _once(self) -> None:
        assert not self.done, "held request already resolved"
        self.done = True

    def release(self) -> None:
        """Deliver to the replica normally."""
        self._once()
        cluster = self.mock.cluster
        ctx = ReplyContext(self.from_node, self.msg_id)
        cluster.queue.add_after(0, lambda: cluster._deliver(
            self.to_node, self.request, self.from_node, ctx))

    def reply(self, reply) -> None:
        """Swallow the request; deliver ``reply`` to the sender's callback as
        if the replica had answered it."""
        self._once()
        cluster = self.mock.cluster
        cluster.queue.add_after(0, lambda: cluster.sinks[self.from_node]
                                .deliver_reply(self.to_node, self.msg_id, reply))

    def drop(self) -> None:
        """Lose the request; the sender's reply-timeout handles it."""
        self._once()

    def fail(self, exc: Optional[BaseException] = None) -> None:
        """Report a link failure to the sender's callback."""
        self._once()
        cluster = self.mock.cluster
        e = exc if exc is not None else ConnectionError(
            f"mock link {self.from_node}->{self.to_node}")
        cluster.queue.add_after(0, lambda: cluster.sinks[self.from_node]
                                .report_failure(self.msg_id, self.to_node, e))

    def __repr__(self):
        return (f"Held({type(self.request).__name__} "
                f"n{self.from_node}->n{self.to_node})")


class Interception:
    __slots__ = ("type_prefix", "from_node", "to_node", "remaining", "held")

    def __init__(self, type_prefix: str, from_node: Optional[int],
                 to_node: Optional[int], count: int):
        self.type_prefix = type_prefix
        self.from_node = from_node
        self.to_node = to_node
        self.remaining = count
        self.held: List[Held] = []

    def matches(self, from_node: int, to_node: int, request) -> bool:
        return (self.remaining > 0
                and type(request).__name__.startswith(self.type_prefix)
                and (self.from_node is None or from_node == self.from_node)
                and (self.to_node is None or to_node == self.to_node))


class MockCluster:
    """A small benign-network cluster with controllable delivery."""

    def __init__(self, rf: int = 3, seed: int = 1,
                 key_bound: int = 100, progress_log: bool = False):
        shards = [Shard(Range(IntKey(0), IntKey(key_bound)),
                        tuple(range(1, rf + 1)))]
        topology = Topology(1, shards)
        self.cluster = Cluster(topology, seed=seed, progress_log=progress_log)
        self.cluster.request_filter = self._filter
        self.interceptions: List[Interception] = []

    # -- interception ---------------------------------------------------------
    def intercept(self, type_prefix: str, from_node: Optional[int] = None,
                  to_node: Optional[int] = None, count: int = 1_000_000
                  ) -> Interception:
        """Hold up to ``count`` future requests whose type name starts with
        ``type_prefix`` (e.g. "Accept" also matches AcceptInvalidate — use
        "Accept(" semantics via exact names when that matters)."""
        ic = Interception(type_prefix, from_node, to_node, count)
        self.interceptions.append(ic)
        return ic

    def _filter(self, from_node: int, to_node: int, request, msg_id: int,
                has_callback: bool) -> bool:
        for ic in self.interceptions:
            if ic.matches(from_node, to_node, request):
                ic.remaining -= 1
                ic.held.append(Held(self, from_node, to_node, request,
                                    msg_id, has_callback))
                return True
        return False

    # -- driving --------------------------------------------------------------
    def node(self, node_id: int):
        return self.cluster.nodes[node_id]

    def coordinate(self, node_id: int, txn: Txn) -> au.AsyncResult:
        return self.cluster.nodes[node_id].coordinate(txn)

    def run_for(self, sim_seconds: float) -> None:
        self.cluster.run_for(sim_seconds)

    def run_until(self, cond: Callable[[], bool], sim_limit_s: float = 30.0
                  ) -> bool:
        deadline = self.cluster.queue.now_micros + int(sim_limit_s * 1e6)
        self.cluster.run_until(
            lambda: cond() or self.cluster.queue.now_micros > deadline)
        return cond()

    def await_held(self, ic: Interception, n: int = 1,
                   sim_limit_s: float = 10.0) -> List[Held]:
        """Run the sim until ``n`` requests are held (or the limit passes)."""
        ok = self.run_until(lambda: len(ic.held) >= n, sim_limit_s)
        assert ok, f"only {len(ic.held)}/{n} {ic.type_prefix} held"
        return ic.held[:n]

    # -- txn helpers ----------------------------------------------------------
    def write_txn(self, writes: dict) -> Txn:
        from ..impl.list_store import list_txn
        return list_txn([], writes)

    def read_txn(self, keys) -> Txn:
        from ..impl.list_store import list_txn
        return list_txn(list(keys), {})
