"""Full message tracing + trace reconciliation.

Capability parity with ``accord.impl.basic.Trace`` and the burn's
``ReconcilingLogger`` (Cluster.java:237-264, burn/ReconcilingLogger.java):
every network event — SEND (with the link action taken: DELIVER / DROP /
FAILURE / DELIVER_WITH_FAILURE), reply routing (RPLY_*), and the actual
delivery (RECV / RECV_RPLY) — is recorded with a logical sequence number.
``reconcile`` then runs the same seed twice and diffs the COMPLETE traces,
not summary scalars: any nondeterminism in the simulation (iteration order,
uncontrolled randomness, wall-clock leakage) surfaces as the first
divergent event.
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Tuple


def _brief(message) -> str:
    """A compact, deterministic description: class + primary txn id."""
    name = type(message).__name__
    tid = getattr(message, "txn_id", None)
    return f"{name}({tid})" if tid is not None else name


class Trace:
    """Recorder for one run; install via ``cluster.tracer = trace.hook`` —
    the cluster calls the hook for SEND/RPLY routing decisions and RECV
    deliveries.

    ``keep_last``: optional ring-buffer bound.  Reconciliation needs the FULL
    event list (both runs diff byte-for-byte), but a long burn that only
    wants the trace for forensics (the flight recorder's message timeline,
    stall postmortems) can cap memory at the last N events — a 1000-op
    hostile seed emits hundreds of thousands of events, and
    ``ACCORD_LONG_BURNS`` sweeps hold several runs' traces at once.  Dropped
    events are counted in ``dropped``; sequence numbers stay absolute, so a
    truncated trace is still diffable against the same-seed tail."""

    __slots__ = ("events", "_seq", "dropped", "_keep_last")

    def __init__(self, keep_last: Optional[int] = None):
        if keep_last is not None and keep_last < 0:
            raise ValueError(f"keep_last must be >= 0, got {keep_last}")
        # `is not None`: keep_last=0 means "count events, keep none", not
        # "unbounded" (deque(maxlen=0) implements exactly that)
        self.events = deque(maxlen=keep_last) if keep_last is not None else []
        self._keep_last = keep_last
        self._seq = 0
        self.dropped = 0

    def hook(self, event: str, frm: int, to: int, msg_id, message,
             now_micros: int) -> None:
        if self._keep_last is not None \
                and len(self.events) == self._keep_last:
            self.dropped += 1
        self.events.append((self._seq, now_micros, event, frm, to, msg_id,
                            _brief(message)))
        self._seq += 1

    def __len__(self):
        return len(self.events)


def diff_traces(a: Trace, b: Trace) -> Optional[str]:
    """None if identical; else a report of the first divergence with
    surrounding context.  Ring-bounded traces are normalised to lists first
    (a deque has no slicing); their absolute sequence numbers make truncated
    tails directly comparable."""
    ea, eb = list(a.events), list(b.events)
    n = min(len(ea), len(eb))
    for i in range(n):
        if ea[i] != eb[i]:
            lo = max(0, i - 3)
            ctx_a = "\n".join(f"  a[{j}]: {ea[j]}" for j in range(lo, min(i + 2, len(ea))))
            ctx_b = "\n".join(f"  b[{j}]: {eb[j]}" for j in range(lo, min(i + 2, len(eb))))
            return (f"traces diverge at event {i}:\n{ctx_a}\n  --- vs ---\n{ctx_b}")
    if len(ea) != len(eb):
        tail = (ea if len(ea) > n else eb)[n:n + 3]
        return (f"trace lengths differ: {len(ea)} vs {len(eb)}; "
                f"first extra events: {tail}")
    return None
