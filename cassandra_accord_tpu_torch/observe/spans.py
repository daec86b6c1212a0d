"""Transaction lifecycle spans.

One ``TxnSpan`` per transaction records, with sim-timestamps:

- the client submit / resolve envelope (coordinator node, op id, outcome),
- fast/slow-path classification from the PreAccept round's tracker votes,
- recovery and invalidation attribution (how many recovery attempts touched
  this txn; whether an invalidation round was launched against it),
- reply timeout and backoff re-arm counts attributed to the txn's messages,
- every per-(node, store) ``SaveStatus`` transition — the
  PreAccept→Accept→Commit→Stable→Apply timeline the Chrome-trace export
  renders one track per node/store.

Span identity is the transaction's own ``TxnId`` — already unique and
deterministic — so recording allocates nothing from any shared sequence
(the zero-observer-effect contract).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# resolve-kind (harness/burn.py) -> final outcome class.  "ok" resolutions
# split fast/slow by the recorded coordination path.
_KIND_OUTCOME = {"recovered": "recovered", "nacked": "invalidated",
                 "lost": "lost", "failed": "failed"}


class TxnSpan:
    __slots__ = ("txn_id", "op_id", "coordinator", "submitted_us",
                 "resolved_us", "path", "outcome", "recoveries",
                 "invalidate_attempts", "timeouts", "backoffs", "transitions")

    def __init__(self, txn_id):
        self.txn_id = txn_id
        self.op_id: Optional[int] = None
        self.coordinator: Optional[int] = None
        self.submitted_us: Optional[int] = None
        self.resolved_us: Optional[int] = None
        self.path: Optional[str] = None          # "fast" | "slow"
        self.outcome: Optional[str] = None       # schema.OUTCOMES
        self.recoveries = 0
        self.invalidate_attempts = 0
        self.timeouts = 0
        self.backoffs = 0
        # (node, store) -> [(save_status_name, sim_micros), ...]
        self.transitions: Dict[Tuple[int, int], List[Tuple[str, int]]] = {}

    @property
    def is_client_op(self) -> bool:
        return self.submitted_us is not None

    def to_dict(self) -> dict:
        """Stable plain-data rendering (the span schema tests pin this)."""
        return {
            "txn_id": str(self.txn_id),
            "op_id": self.op_id,
            "coordinator": self.coordinator,
            "submitted_us": self.submitted_us,
            "resolved_us": self.resolved_us,
            "path": self.path,
            "outcome": self.outcome,
            "recoveries": self.recoveries,
            "invalidate_attempts": self.invalidate_attempts,
            "timeouts": self.timeouts,
            "backoffs": self.backoffs,
            "transitions": {f"{n}/{s}": list(ts)
                            for (n, s), ts in sorted(self.transitions.items())},
        }


class TxnSpanRecorder:
    """All spans of one run, keyed by TxnId.  System transactions (sync
    points, durability rounds) get transition-only spans; client ops get the
    full submit/resolve envelope from the burn harness."""

    __slots__ = ("spans",)

    def __init__(self):
        self.spans: Dict[object, TxnSpan] = {}

    def _span(self, txn_id) -> TxnSpan:
        span = self.spans.get(txn_id)
        if span is None:
            span = TxnSpan(txn_id)
            self.spans[txn_id] = span
        return span

    # -- client envelope (harness/burn.py) -----------------------------------
    def on_submit(self, op_id: int, txn_id, coordinator: int,
                  now_us: int) -> None:
        span = self._span(txn_id)
        span.op_id = op_id
        span.coordinator = coordinator
        span.submitted_us = now_us

    def on_resolve(self, txn_id, kind: str, now_us: int) -> str:
        """Record the final resolution; returns the outcome class."""
        span = self._span(txn_id)
        span.resolved_us = now_us
        outcome = _KIND_OUTCOME.get(kind)
        if outcome is None:                      # kind == "ok"
            outcome = span.path or "slow"
        span.outcome = outcome
        return outcome

    # -- coordination classification (coordinate/) ---------------------------
    def on_path(self, txn_id, path: str) -> None:
        span = self._span(txn_id)
        if span.path is None:        # first classification wins (recovery
            span.path = path         # re-proposals don't reclassify)

    def on_recovery(self, txn_id) -> None:
        self._span(txn_id).recoveries += 1

    def on_invalidate_attempt(self, txn_id) -> None:
        self._span(txn_id).invalidate_attempts += 1

    # -- message-plane attribution (harness/cluster.py sinks) ----------------
    def on_timeout(self, txn_id) -> None:
        if txn_id is not None:
            self._span(txn_id).timeouts += 1

    def on_backoff(self, txn_id) -> None:
        if txn_id is not None:
            self._span(txn_id).backoffs += 1

    # -- replica-side lifecycle (local/commands.py) --------------------------
    def on_transition(self, node: int, store: int, txn_id,
                      status_name: str, now_us: int) -> None:
        self._span(txn_id).transitions.setdefault((node, store), []) \
            .append((status_name, now_us))

    # -- rendering -----------------------------------------------------------
    def client_spans(self) -> List[TxnSpan]:
        return [s for s in self.spans.values() if s.is_client_op]

    def to_list(self) -> List[dict]:
        return [span.to_dict() for _txn_id, span in
                sorted(self.spans.items(), key=lambda kv: str(kv[0]))]
