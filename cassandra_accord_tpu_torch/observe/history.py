"""Client-visible operation history — the record the independent oracle reads.

Every burn can record what an external client of the system saw, and ONLY
that: for each operation an ``invoke`` event (sim-time, the keys it asked to
read, the values it asked to append) and a terminal event —

- ``ok``           the client received a result: observed per-key version
                   lists + its writes acknowledged (acked and probe-recovered
                   ops both land here: the client learned the outcome),
- ``invalidated``  durably nacked: the writes must NEVER surface,
- ``info``         outcome unknown (lost/truncated): writes MAY have applied,
- ``fail``         the op definitely did not run.

This is exactly the event vocabulary of Jepsen's Elle checker
(invoke / ok / fail / info), deliberately containing ZERO protocol
bookkeeping — no TxnId ordering, no deps, no ballots — so the checker in
``observe/checker.py`` constitutes a second opinion that cannot inherit a
protocol bug.  (It still stores each op's txn id opaquely, solely so anomaly
reports can pull flight-recorder timelines for the implicated txns.)

ZERO OBSERVER EFFECT (the package invariant): the recorder is a passive
sink fed values the harness already computed.  It never touches an RNG, the
scheduler, or the wall clock — proven in-tree by the same-seed trace-diff
test in tests/test_history_checker.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: terminal-event mapping from the burn harness's resolution kinds
_OUTCOMES = {"ok": "ok", "recovered": "ok", "nacked": "invalidated",
             "lost": "info", "failed": "fail"}


def _as_values(v) -> tuple:
    """Normalize a per-key write to a tuple of appended values (a txn may
    append more than one value to a key — the maelstrom workload does)."""
    if isinstance(v, tuple):
        return v
    if isinstance(v, list):
        return tuple(v)
    return (v,)


class HistoryOp:
    """One client operation: invocation + (eventual) terminal event."""

    __slots__ = ("op_id", "txn_id", "invoke_us", "read_keys", "complete_us",
                 "outcome", "reads", "writes")

    def __init__(self, op_id, txn_id, invoke_us: int,
                 read_keys: Tuple = (), writes: Optional[Dict] = None):
        self.op_id = op_id
        self.txn_id = txn_id
        self.invoke_us = invoke_us
        self.read_keys = tuple(read_keys)
        # intended writes, normalized to key -> (value, ...) append tuples
        self.writes: Dict[object, tuple] = \
            {k: _as_values(v) for k, v in (writes or {}).items()}
        self.complete_us: Optional[int] = None
        self.outcome: Optional[str] = None   # ok|invalidated|info|fail|None
        self.reads: Dict[object, tuple] = {}  # observed per-key version lists

    def to_record(self) -> dict:
        """JSON-safe rendering for anomaly reports / artifacts."""
        return {
            "op_id": self.op_id,
            "txn_id": str(self.txn_id),
            "invoke_us": self.invoke_us,
            "complete_us": self.complete_us,
            "outcome": self.outcome or "open",
            "reads": {str(k): list(v) for k, v in sorted(
                self.reads.items(), key=lambda kv: str(kv[0]))},
            "writes": {str(k): list(v) for k, v in sorted(
                self.writes.items(), key=lambda kv: str(kv[0]))},
        }

    def __repr__(self):
        return (f"HistoryOp({self.op_id}, {self.outcome or 'open'}, "
                f"[{self.invoke_us}..{self.complete_us}], "
                f"r={sorted(map(str, self.reads))}, "
                f"w={sorted(map(str, self.writes))})")


class HistoryRecorder:
    """Accumulates the client-visible history of one burn."""

    def __init__(self):
        self.ops: List[HistoryOp] = []
        self._by_id: Dict[object, HistoryOp] = {}

    def invoke(self, op_id, txn_id, now_us: int, read_keys=(),
               writes: Optional[Dict] = None) -> HistoryOp:
        op = HistoryOp(op_id, txn_id, now_us, read_keys, writes)
        self.ops.append(op)
        self._by_id[op_id] = op
        return op

    def resolve(self, op_id, kind: str, now_us: int,
                reads: Optional[Dict] = None,
                writes: Optional[Dict] = None) -> None:
        """Terminal event for ``op_id``; ``kind`` is the harness resolution
        kind (ok/recovered/nacked/lost/failed)."""
        op = self._by_id.get(op_id)
        if op is None:   # never invoked (harness bug) — don't mask it here
            return
        op.complete_us = now_us
        op.outcome = _OUTCOMES.get(kind, "info")
        if reads:
            op.reads = {k: tuple(v) for k, v in reads.items()}
        if writes:
            # the acked write set can be narrower than intended (it never is
            # in our harness, but the record must reflect what was ACKED)
            op.writes = {k: _as_values(v) for k, v in writes.items()}

    def to_records(self) -> List[dict]:
        return [op.to_record() for op in self.ops]

    def __len__(self):
        return len(self.ops)
