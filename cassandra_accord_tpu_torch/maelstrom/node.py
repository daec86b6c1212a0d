"""Maelstrom node core: the protocol adapter between Maelstrom JSON packets and
the accord Node, independent of transport (stdio Main and the in-process Runner
both drive it).

Capability parity with ``accord-maelstrom`` Main/MaelstromRequest/TopologyFactory
(Main.java:60-244, MaelstromRequest.java, TopologyFactory.java): ``init`` builds the
Node with a static topology computed from the node list; ``txn`` bodies carry
Maelstrom micro-op lists (``[["r", k, null], ["append", k, v]]`` — the list-append
workload) executed as one accord transaction; accord's own wire messages travel
wrapped in ``accord``/``accord_reply`` bodies via the codec.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..api.interfaces import Agent, ConfigurationService, MessageSink, Scheduler
from ..impl.list_store import (ListData, ListQuery, ListRead, ListResult,
                               ListStore, ListUpdate)
from ..local.node import Node
from ..primitives.keys import IntKey, Keys, Range, SentinelKey
from ..primitives.txn import Txn
from ..topology.topology import Shard, Topology
from ..utils import async_ as au
from ..utils.random import RandomSource
from . import codec

MULTI = "$multi"


def node_num(name: str) -> int:
    """Maelstrom node id ("n3") -> accord node id (3).  Arbitrary names map via
    crc32 (process-stable; Python's str hash is salted per process)."""
    import zlib
    stripped = name.lstrip("n")
    return int(stripped) if stripped.isdigit() \
        else (zlib.crc32(name.encode()) % 10**6) + 10**6


class TopologyFactory:
    """Static topology from the init node list (TopologyFactory.java): the int
    key space split contiguously into one shard per node, each replicated rf-way
    (simplification of the reference's hash-split; same shard/replica shape)."""

    @staticmethod
    def build(node_names: List[str], rf: Optional[int] = None,
              key_bound: int = 1 << 16) -> Topology:
        ids = sorted(node_num(n) for n in node_names)
        n = len(ids)
        rf = rf if rf is not None else min(3, n)
        shards = []
        lo = SentinelKey.min(0)
        for i in range(n):
            hi = SentinelKey.max(0) if i == n - 1 \
                else IntKey(((i + 1) * key_bound) // n)
            replicas = [ids[(i + j) % n] for j in range(rf)]
            shards.append(Shard(Range(lo, hi), replicas))
            lo = hi
        return Topology(1, shards)


class StaticConfigService(ConfigurationService):
    """SimpleConfigService: one static topology, everyone synced."""

    def __init__(self, topology: Topology, node_id: int, peers: List[int],
                 send_sync: Callable[[int, int], None]):
        self.topology = topology
        self.node_id = node_id
        self.peers = peers
        self.send_sync = send_sync
        self.listeners: List[ConfigurationService.Listener] = []

    def register_listener(self, listener) -> None:
        self.listeners.append(listener)

    def current_topology(self) -> Topology:
        return self.topology

    def get_topology_for_epoch(self, epoch: int) -> Optional[Topology]:
        return self.topology if epoch == self.topology.epoch else None

    def fetch_topology_for_epoch(self, epoch: int) -> None:
        pass

    def acknowledge_epoch(self, ready, start_sync: bool) -> None:
        for peer in self.peers:
            self.send_sync(peer, ready.epoch)


class MaelstromAgent(Agent):
    def __init__(self, on_error: Callable[[BaseException], None]):
        self._on_error = on_error

    def on_uncaught_exception(self, failure: BaseException) -> None:
        self._on_error(failure)

    def on_handled_exception(self, failure: BaseException) -> None:
        pass


def parse_txn(ops: List[list]) -> Tuple[Txn, List[list]]:
    """Build an accord Txn from Maelstrom micro-ops.  Multiple appends to one
    key coalesce into one tagged multi-value (flattened again in replies)."""
    reads: List[IntKey] = []
    appends: Dict[IntKey, list] = {}
    for op, key, value in ops:
        k = IntKey(int(key))
        if op == "r":
            if k not in reads:
                reads.append(k)
        elif op == "append":
            appends.setdefault(k, []).append(value)
        else:
            raise ValueError(f"unsupported op {op!r}")
    upd = {k: (v[0] if len(v) == 1 else [MULTI] + v) for k, v in appends.items()}
    all_keys = Keys.of(list(reads) + list(upd.keys()))
    txn = Txn.of(all_keys, ListRead(Keys.of(reads)),
                 ListUpdate(upd) if upd else None, ListQuery())
    return txn, ops


def flatten(values: tuple) -> list:
    out = []
    for v in values:
        if isinstance(v, (list, tuple)) and len(v) > 0 and v[0] == MULTI:
            out.extend(v[1:])
        else:
            out.append(v)
    return out


def fill_results(ops: List[list], result: ListResult) -> List[list]:
    """Fill the read ops with observed values (MaelstromReply txn_ok body).
    Reads report the pre-transaction state, appends are echoed as-is — exactly
    the reference's reply shape (MaelstromReply.writeBody)."""
    out = []
    for op, key, value in ops:
        if op == "r":
            got = flatten(result.reads.get(IntKey(int(key)), ()))
            out.append(["r", key, got])
        else:
            out.append([op, key, value])
    return out


class PacketSink(MessageSink):
    """MessageSink over Maelstrom packets (StdoutSink, Main.java:86-143):
    requests carry a fresh ``amsg_id`` for reply correlation; callbacks time out
    after ``timeout_s`` (swept by the transport's scheduler)."""

    def __init__(self, me: str, emit: Callable[[dict], None],
                 now_s: Callable[[], float], timeout_s: float = 1.0):
        self.me = me
        self.emit = emit
        self.now_s = now_s
        self.timeout_s = timeout_s
        self.next_id = 0
        self.callbacks: Dict[int, Tuple[object, float]] = {}

    def _packet(self, to: int, body: dict) -> dict:
        return {"src": self.me, "dest": f"n{to}", "body": body}

    def send(self, to: int, request) -> None:
        self.next_id += 1
        self.emit(self._packet(to, {"type": "accord", "amsg_id": self.next_id,
                                    "payload": codec.encode_message(request)}))

    def send_with_callback(self, to: int, request, callback) -> None:
        self.next_id += 1
        self.callbacks[self.next_id] = (callback, self.now_s() + self.timeout_s, to)
        self.emit(self._packet(to, {"type": "accord", "amsg_id": self.next_id,
                                    "payload": codec.encode_message(request)}))

    def reply(self, to: int, reply_context, reply) -> None:
        from ..messages.base import LOCAL_NO_REPLY
        if reply_context is LOCAL_NO_REPLY:
            return   # self-delivered local request (Propagate): no reply
        amsg_id = reply_context
        self.emit(self._packet(to, {"type": "accord_reply", "in_reply_to_a": amsg_id,
                                    "payload": codec.encode_message(reply)}))

    def deliver_reply(self, from_node: int, amsg_id: int, reply) -> None:
        entry = self.callbacks.get(amsg_id)
        if entry is None:
            return
        callback = entry[0]
        if getattr(reply, "is_final", True):
            del self.callbacks[amsg_id]
        from ..messages.base import FailureReply
        if isinstance(reply, FailureReply):
            callback.on_failure(from_node, reply.failure)
        else:
            callback.on_success(from_node, reply)

    def sweep_timeouts(self) -> None:
        now = self.now_s()
        for amsg_id in [i for i, e in self.callbacks.items() if e[1] <= now]:
            callback, _deadline, to = self.callbacks.pop(amsg_id)
            callback.on_failure(to, TimeoutError(f"no reply to {amsg_id}"))


class MaelstromNode:
    """One Maelstrom process: wires Node + ListStore + PacketSink and handles
    every packet type."""

    def __init__(self, name: str, node_names: List[str],
                 emit: Callable[[dict], None], scheduler: Scheduler,
                 now_micros: Callable[[], int],
                 on_error: Optional[Callable[[BaseException], None]] = None,
                 rf: Optional[int] = None):
        self.name = name
        self.id = node_num(name)
        self.errors: List[BaseException] = []
        self.scheduler = scheduler

        def emit_or_loopback(packet: dict) -> None:
            if packet["dest"] == name:
                # self-sends dispatch in-process, not over the wire
                scheduler.now(lambda: self.handle(packet, lambda *_: None))
            else:
                emit(packet)

        self.sink = PacketSink(name, emit_or_loopback, lambda: now_micros() / 1e6)
        topology = TopologyFactory.build(node_names, rf=rf)
        peers = sorted(node_num(n) for n in node_names if n != name)
        self.store = ListStore(self.id)
        config = StaticConfigService(topology, self.id, peers, self._send_sync)
        self.node = Node(self.id, self.sink, config,
                         MaelstromAgent(on_error or self.errors.append),
                         scheduler, self.store, RandomSource(self.id),
                         now_micros=now_micros)
        scheduler.recurring(0.25, self.sink.sweep_timeouts)

    def _send_sync(self, peer: int, epoch: int) -> None:
        self.sink.emit(self.sink._packet(peer, {"type": "accord_sync",
                                                "epoch": epoch}))

    # -- packet handling (Main.java:207-232) ---------------------------------
    def handle(self, packet: dict, client_reply: Callable[[dict, dict], None]) -> None:
        body = packet["body"]
        btype = body.get("type")
        if btype == "txn":
            self._handle_txn(packet, body, client_reply)
        elif btype == "accord":
            request = codec.decode_message(body["payload"])
            self.node.receive(request, node_num(packet["src"]), body["amsg_id"])
        elif btype == "accord_reply":
            reply = codec.decode_message(body["payload"])
            self.sink.deliver_reply(node_num(packet["src"]),
                                    body["in_reply_to_a"], reply)
        elif btype == "accord_sync":
            self.node.on_remote_sync_complete(node_num(packet["src"]), body["epoch"])
        elif btype in ("init", "init_ok"):
            pass  # init handled by the transport constructing this object
        else:
            client_reply(packet, {"type": "error", "code": 10,
                                  "text": f"unsupported {btype}"})

    def _handle_txn(self, packet: dict, body: dict,
                    client_reply: Callable[[dict, dict], None]) -> None:
        try:
            txn, ops = parse_txn(body["txn"])
        except Exception as e:  # noqa: BLE001
            client_reply(packet, {"type": "error", "code": 12, "text": str(e)})
            return

        def on_done(value, failure):
            if failure is not None or not isinstance(value, ListResult):
                client_reply(packet, {"type": "error", "code": 11,
                                      "text": f"txn failed: {failure}"})
            else:
                client_reply(packet, {"type": "txn_ok",
                                      "txn": fill_results(ops, value)})

        self.node.coordinate(txn).add_listener(on_done)
