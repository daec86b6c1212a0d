"""Maelstrom stdio node binary.

Capability parity with ``accord-maelstrom``'s ``Main`` (Main.java:60-244): reads
JSON packets from stdin, answers ``init`` with ``init_ok``, then serves ``txn``
client bodies and accord wrapper messages until EOF.  Run under the Maelstrom
workbench as::

    maelstrom test -w txn-list-append --bin ./maelstrom-node ...

where ``maelstrom-node`` execs ``python -m cassandra_accord_tpu.maelstrom``.

Real time drives the scheduler: timers are serviced between stdin lines (stdin
reads use a small poll timeout so timeouts/retries fire while idle).
"""
from __future__ import annotations

import heapq
import json
import select
import sys
import time
from typing import Callable, List, Optional

from ..api.interfaces import Scheduler
from .node import MaelstromNode


class RealTimeScheduler(Scheduler):
    """Monotonic-clock task queue serviced by the stdio loop."""

    def __init__(self):
        self.heap: List = []
        self.seq = 0

    def _push(self, at: float, run: Callable[[], None], interval: Optional[float],
              state: Optional[dict] = None):
        self.seq += 1
        state = state if state is not None else {"cancelled": False}
        heapq.heappush(self.heap, [at, self.seq, run, interval, state])

        class _S(Scheduler.Scheduled):
            def cancel(self_inner):
                state["cancelled"] = True
        return _S()

    def once(self, delay_s: float, run: Callable[[], None]):
        return self._push(time.monotonic() + delay_s, run, None)

    def recurring(self, interval_s: float, run: Callable[[], None]):
        return self._push(time.monotonic() + interval_s, run, interval_s)

    def now(self, run: Callable[[], None]):
        return self._push(time.monotonic(), run, None)

    def service(self) -> float:
        """Run everything due; return seconds until the next task (or 0.2)."""
        while self.heap and self.heap[0][0] <= time.monotonic():
            at, _seq, run, interval, state = heapq.heappop(self.heap)
            if state["cancelled"]:
                continue
            if interval is not None:
                # re-arm sharing the SAME cancellation state: the handle
                # returned at registration keeps working after every fire
                self._push(time.monotonic() + interval, run, interval, state)
            run()
        if not self.heap:
            return 0.2
        return max(0.0, min(0.2, self.heap[0][0] - time.monotonic()))


def emit(packet: dict) -> None:
    sys.stdout.write(json.dumps(packet, separators=(",", ":")) + "\n")
    sys.stdout.flush()


def main() -> None:
    import os
    scheduler = RealTimeScheduler()
    node: Optional[MaelstromNode] = None
    next_msg_id = [0]

    def client_reply(packet: dict, body: dict) -> None:
        next_msg_id[0] += 1
        body = dict(body)
        body["msg_id"] = next_msg_id[0]
        if "msg_id" in packet["body"]:
            body["in_reply_to"] = packet["body"]["msg_id"]
        emit({"src": packet["dest"], "dest": packet["src"], "body": body})

    def handle_line(line: str) -> None:
        nonlocal node
        packet = json.loads(line)
        body = packet.get("body", {})
        if body.get("type") == "init":
            node = MaelstromNode(
                body["node_id"], body["node_ids"], emit, scheduler,
                now_micros=lambda: int(time.time() * 1e6))
            # the device tier's start-up before init_ok, not inside the
            # first consult, where it would time out every request in flight
            from ..impl.tpu_resolver import warm_device_tier
            warm_device_tier(node.node.config, node.node.resolver_kind)
            client_reply(packet, {"type": "init_ok"})
        elif node is not None:
            node.handle(packet, client_reply)
        else:
            client_reply(packet, {"type": "error", "code": 10,
                                  "text": "not initialised"})

    # raw non-blocking reads + own line buffer: several lines can arrive in one
    # read, and buffered readline + select would strand all but the first
    fd = sys.stdin.fileno()
    os.set_blocking(fd, False)
    buf = b""
    eof = False
    while not eof:
        timeout = scheduler.service()
        ready, _, _ = select.select([fd], [], [], timeout)
        if not ready:
            continue
        try:
            chunk = os.read(fd, 1 << 16)
        except BlockingIOError:
            continue
        if chunk == b"":
            eof = True
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            line = line.strip()
            if line:
                handle_line(line.decode())
        if eof and buf.strip():
            # final line without a trailing newline still counts
            handle_line(buf.strip().decode())
            buf = b""


if __name__ == "__main__":
    main()
