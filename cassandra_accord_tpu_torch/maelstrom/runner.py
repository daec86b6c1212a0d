"""In-process Maelstrom simulator: seeded queues, random delays, periodic
partitions.

Capability parity with ``accord-maelstrom``'s test-tree ``Cluster``/``Runner``
(maelstrom/Cluster.java:70-330, Runner.java): runs the full Maelstrom packet
protocol (init / txn / accord wrappers) between in-process MaelstromNodes over a
simulated-time queue, with random delivery delays and periodic random network
partitions, and validates client results.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional

from ..harness.cluster import PendingQueue, SimScheduler
from ..utils.random import RandomSource
from .node import MaelstromNode, node_num


class MaelstromCluster:
    """N MaelstromNodes exchanging JSON packets over a seeded queue."""

    def __init__(self, n_nodes: int, seed: int = 1,
                 min_latency_us: int = 500, max_latency_us: int = 10_000,
                 partition_interval_s: Optional[float] = 2.0,
                 partition_duration_s: float = 0.5):
        self.rng = RandomSource(seed)
        self.queue = PendingQueue()
        self.scheduler = SimScheduler(self.queue)
        self.min_latency_us = min_latency_us
        self.max_latency_us = max_latency_us
        self.names = [f"n{i}" for i in range(1, n_nodes + 1)]
        self.partitioned: set = set()   # node names on the minority side
        self.errors: List[BaseException] = []
        self.client_replies: List[dict] = []
        self._reply_handlers: Dict[int, Callable[[dict], None]] = {}
        self._next_client_msg = [0]
        self.nodes: Dict[str, MaelstromNode] = {}
        for name in self.names:
            self.nodes[name] = MaelstromNode(
                name, list(self.names),
                emit=lambda packet: self._route(packet),
                scheduler=self.scheduler,
                now_micros=lambda: self.queue.now_micros,
                on_error=self.errors.append)
        if partition_interval_s:
            self.scheduler.recurring(partition_interval_s,
                                     lambda: self._random_partition(partition_duration_s))

    # -- network -------------------------------------------------------------
    def _random_partition(self, duration_s: float) -> None:
        """Partition a random minority for ``duration_s`` (Cluster.java:143-215)."""
        k = self.rng.next_int(1, max(2, len(self.names) // 2 + 1))
        side = set(self.rng.pick(self.names) for _ in range(k))
        self.partitioned = side
        self.scheduler.once(duration_s, lambda: self._heal(side))

    def _heal(self, side: set) -> None:
        if self.partitioned == side:
            self.partitioned = set()

    def _dropped(self, src: str, dest: str) -> bool:
        return (src in self.partitioned) != (dest in self.partitioned)

    def _route(self, packet: dict) -> None:
        # serialize/deserialize for wire fidelity (catches codec gaps)
        packet = json.loads(json.dumps(packet))
        src, dest = packet["src"], packet["dest"]
        if dest.startswith("c"):
            self._deliver_client(packet)
            return
        if self._dropped(src, dest):
            return
        delay = self.rng.next_int(self.min_latency_us, self.max_latency_us)
        self.queue.add_after(delay, lambda: self.nodes[dest].handle(
            packet, self._client_reply))
        # note: node->node packets never need client_reply, but txn packets
        # delivered via submit() do

    def _deliver_client(self, packet: dict) -> None:
        self.client_replies.append(packet)
        handler = self._reply_handlers.pop(packet["body"].get("in_reply_to"), None)
        if handler is not None:
            handler(packet)

    def _client_reply(self, request_packet: dict, body: dict) -> None:
        self._next_client_msg[0] += 1
        body = dict(body)
        body["msg_id"] = self._next_client_msg[0]
        if "msg_id" in request_packet["body"]:
            body["in_reply_to"] = request_packet["body"]["msg_id"]
        self._route({"src": request_packet["dest"], "dest": request_packet["src"],
                     "body": body})

    # -- clients -------------------------------------------------------------
    def submit_txn(self, to: str, ops: List[list], msg_id: int,
                   on_reply: Callable[[dict], None]) -> None:
        self._reply_handlers[msg_id] = on_reply
        packet = {"src": "c1", "dest": to,
                  "body": {"type": "txn", "msg_id": msg_id, "txn": ops}}
        delay = self.rng.next_int(self.min_latency_us, self.max_latency_us)
        self.queue.add_after(delay, lambda: self.nodes[to].handle(
            packet, self._client_reply))

    # -- execution -----------------------------------------------------------
    def run_until(self, predicate: Callable[[], bool],
                  max_tasks: int = 1_000_000) -> bool:
        n = 0
        while n < max_tasks:
            if predicate():
                return True
            task = self.queue.pop()
            if task is None:
                return predicate()
            task()
            n += 1
            if self.errors:
                raise self.errors[0]
        return predicate()


def run_workload(seed: int, n_nodes: int = 3, ops: int = 50,
                 partition_interval_s: Optional[float] = 2.0,
                 check: bool = True) -> Dict:
    """Seeded list-append workload (SimpleRandomTest): every txn must eventually
    get txn_ok (retrying on error/timeout), and every read must observe a
    prefix-consistent list per key.

    With ``check=True`` the adapter also records the full client-visible
    history (every attempt: an errored attempt may still have committed, so
    it is recorded as an info op and the retry uses FRESH values — reusing
    values would break the unique-write attribution the checker relies on),
    reads back every touched key for an authoritative final state, and runs
    the protocol-blind oracle (observe/checker.py) over it — the Elle-style
    cross-check of the Maelstrom path (ROADMAP item 4d)."""
    from ..observe.checker import check_history
    from ..observe.history import HistoryRecorder
    cluster = MaelstromCluster(n_nodes, seed=seed,
                               partition_interval_s=partition_interval_s)
    rng = RandomSource(seed * 31 + 1)
    history = HistoryRecorder()
    results: Dict[int, dict] = {}
    state = {"msg": 0, "done": 0, "submitted": 0, "val": 0}
    pending: Dict[int, tuple] = {}
    touched: set = set()

    def submit(op_id: int, shape: List[tuple], attempt: int = 0) -> None:
        state["msg"] += 1
        msg_id = state["msg"]
        ops_list: List[list] = []
        reads: List[int] = []
        writes: Dict[int, list] = {}
        for kind, key in shape:
            if kind == "r":
                ops_list.append(["r", key, None])
                reads.append(key)
            else:
                state["val"] += 1
                v = state["val"]
                ops_list.append(["append", key, v])
                writes.setdefault(key, []).append(v)
                touched.add(key)
        pending[msg_id] = (op_id, shape, attempt)
        hid = (op_id, attempt)
        history.invoke(hid, None, cluster.queue.now_micros,
                       tuple(reads), writes)

        def handler(packet: dict, _msg_id=msg_id, _hid=hid,
                    _writes=writes) -> None:
            op_id2, shape2, attempt2 = pending.pop(_msg_id)
            body = packet["body"]
            now = cluster.queue.now_micros
            if body["type"] == "txn_ok":
                observed = {k: tuple(v or ()) for op, k, v in body["txn"]
                            if op == "r"}
                history.resolve(_hid, "ok", now, reads=observed,
                                writes=_writes)
                results[op_id2] = body
                state["done"] += 1
            else:
                # outcome unknown — the txn may still have committed: an
                # info op, then retry on a (possibly different) node with
                # fresh values — client-side liveness (ListRequest retry
                # semantics)
                history.resolve(_hid, "lost", now)
                submit(op_id2, shape2, attempt2 + 1)

        to = f"n{1 + rng.next_int(n_nodes)}"
        cluster.submit_txn(to, ops_list, msg_id, handler)

    for i in range(ops):
        key = rng.next_int(8)
        shape: List[tuple] = []
        if rng.next_boolean():
            shape.append(("r", key))
        shape.append(("append", key))
        if rng.next_float() < 0.3:
            shape.append(("append", rng.next_int(8)))
        submit(i, shape)
        state["submitted"] += 1

    ok = cluster.run_until(lambda: state["done"] >= ops, max_tasks=3_000_000)
    assert ok, f"only {state['done']}/{ops} maelstrom txns completed"

    # prefix consistency per key across all observed reads
    longest: Dict[int, list] = {}
    for op_id in sorted(results):
        for op, key, value in results[op_id]["txn"]:
            if op != "r":
                continue
            prev = longest.setdefault(key, [])
            shorter, longer = sorted([prev, value], key=len)
            assert longer[: len(shorter)] == shorter, \
                f"non-prefix reads on {key}: {prev} vs {value}"
            longest[key] = longer
    out = {"ok": state["done"],
           "reads_checked": sum(len(v) for v in longest.values())}

    if check:
        # authoritative final state: read back every touched key (retrying
        # through partitions), then hand the whole history to the oracle
        final_state: Dict[int, tuple] = {}

        def read_back(key: int, attempt: int = 0) -> None:
            state["msg"] += 1
            msg_id = state["msg"]
            hid = ("final", key, attempt)
            history.invoke(hid, None, cluster.queue.now_micros, (key,), None)

            def handler(packet: dict, _hid=hid, _key=key,
                        _attempt=attempt) -> None:
                body = packet["body"]
                now = cluster.queue.now_micros
                if body["type"] == "txn_ok":
                    val = tuple(body["txn"][0][2] or ())
                    history.resolve(_hid, "ok", now, reads={_key: val})
                    final_state[_key] = val
                else:
                    history.resolve(_hid, "lost", now)
                    read_back(_key, _attempt + 1)

            to = f"n{1 + rng.next_int(n_nodes)}"
            cluster.submit_txn(to, [["r", key, None]], msg_id, handler)

        for key in sorted(touched):
            read_back(key)
        ok2 = cluster.run_until(
            lambda: len(final_state) >= len(touched), max_tasks=3_000_000)
        assert ok2, f"final-state read-back stalled: " \
                    f"{len(final_state)}/{len(touched)} keys"
        report = check_history(history.ops, final_state=final_state)
        out["history_ops"] = len(history)
        out["final_keys"] = len(final_state)
        out["history"] = {k: report[k] for k in ("ops", "ok", "keys", "edges")}
    return out
