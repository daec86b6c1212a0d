"""ConflictGraphModel — the device-resident deps-resolution pipeline, in torch.

Port of ``cassandra_accord_tpu/models/conflict_graph.py``: a tuple of device
tensors (ops.graph_state.GraphState) plus step functions that advance it.
One ``txn_step`` does, for a whole batch, what the reference does per
transaction between PreAccept and Apply on the metadata plane:

  reference (per txn, scalar Java)              here (per BATCH)
  ------------------------------------------    ----------------------------
  CommandsForKey.mapReduceActive deps scan      overlap_join (kernel K1)
  MaxConflicts lookup + proposal                max_conflict_ts (+ ts_next)
  Commands.commit -> initialiseWaitingOn        adjacency rows of the batch
  Commands.maybeExecute / updateWaitingOn       kahn_frontier
  apply + listener cascade                      status := APPLIED

The control plane stays on the host; this module is pure tensor programs.

``preaccept_step``, ``stabilise_step``, ``execute_step`` and ``gc_step``
return a new state and leave their input's tensors as they were (unchanged
fields are shared, as the reference's ``_replace`` shares buffers).
``txn_step`` and ``txn_step_scan`` take the state over, as the reference's
``donate_argnums=(0,)`` does, and write its tensors in place: a state (or
one that shares tensors with it) must not be read after it was passed
there.  At T = 65,536 the adjacency alone is 4 GiB, so this is what keeps
a step's memory near one state.

A padding row (valid = False) scatters to slot T-1 and writes back that
slot's old value, and a slot named by several rows takes the last one in
batch order — the reference's CPU answer, kept here by writing only the
winning valid rows (``ops._kernels.write_rows``).  So a valid row aimed at
slot T-1 followed by padding rows is not inserted, exactly as in the
reference.

On the card a step reads nothing back: the rows are written and the
frontier is found by kernels (csrc/step_rows.cu), the conflict max by one
pass over the deps rows (csrc/lex_max.cu), the join's CSR query is
built at a capacity fixed by its shape (``deps_kernels.query_csr``), and
the status codes go in as launch arguments, so the host queues the whole
step while the device runs it.  ``gc_step`` reads its eviction list back.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..observe.profiler import span
from ..ops import _kernels
from ..ops import graph_state as gs
from ..ops import deps_kernels as dk


class TxnBatch(NamedTuple):
    """A batch of incoming transactions (host-assembled, device-consumed)."""
    slots: torch.Tensor     # [B] int32 — target slot per txn (host-assigned)
    key_inc: torch.Tensor   # [B, K] int8
    txn_id: torch.Tensor    # [B, 5] int32 packed lanes
    kind: torch.Tensor      # [B] int8
    valid: torch.Tensor     # [B] bool — allows padding a partial batch


def _preaccept(state: gs.GraphState, batch: TxnBatch, inplace: bool):
    with span("accord.step.witness"):
        with span("accord.step.join"):
            deps = dk.overlap_join(state.key_inc, state.txn_id, state.kind,
                                   state.status, state.active,
                                   batch.key_inc, batch.txn_id, batch.kind)
        deps = deps & batch.valid.to(torch.bool)[:, None]
        with span("accord.step.lex_max"):
            conflict_max, any_dep = dk.max_conflict_ts(state.ts, deps)
        if not inplace:
            state = gs.GraphState(*(x.clone() for x in state))
        _kernels.write_rows(state, batch.slots, batch.valid,
                            key_inc=batch.key_inc, ts=batch.txn_id,
                            txn_id=batch.txn_id, kind=batch.kind,
                            status=gs.PREACCEPTED, adj=deps, active=True)
        return state, deps, conflict_max, any_dep


def _stabilise(state: gs.GraphState, slots: torch.Tensor,
               execute_at: torch.Tensor, valid: torch.Tensor,
               inplace: bool) -> gs.GraphState:
    with span("accord.step.stabilise"):
        if not inplace:
            state = state._replace(ts=state.ts.clone(),
                                   status=state.status.clone())
        _kernels.write_rows(state, slots, valid, ts=execute_at,
                            status=gs.STABLE)
        return state


def _execute(state: gs.GraphState, inplace: bool):
    with span("accord.step.execute"):
        ready = dk.kahn_frontier(state.adj, state.status, state.active)
        if inplace:
            status = state.status.masked_fill_(ready, gs.APPLIED)
        else:
            status = state.status.masked_fill(ready, gs.APPLIED)
        return state._replace(status=status), ready


def preaccept_step(state: gs.GraphState, batch: TxnBatch
                   ) -> Tuple[gs.GraphState, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Witness a batch: compute deps, propose conflict-max, insert rows.

    Returns (state', deps [B, T] bool, conflict_max [B, 5], any_dep [B]).
    Invalid (padding) lanes insert nothing."""
    return _preaccept(state, batch, inplace=False)


def stabilise_step(state: gs.GraphState, slots: torch.Tensor,
                   execute_at: torch.Tensor,
                   valid: torch.Tensor) -> gs.GraphState:
    """Fix executeAt + deps for a batch (the Commit/Stable transition:
    Commands.commit -> initialiseWaitingOn, Commands.java:289,688)."""
    return _stabilise(state, slots, execute_at, valid, inplace=False)


def execute_step(state: gs.GraphState
                 ) -> Tuple[gs.GraphState, torch.Tensor]:
    """One execution wave: find the ready frontier and apply it
    (Commands.maybeExecute -> Applied, Commands.java:617-666).

    Returns (state', applied_mask [T] bool)."""
    return _execute(state, inplace=False)


def gc_step(state: gs.GraphState,
            redundant_before: torch.Tensor) -> gs.GraphState:
    """Evict applied txns with txnId below the GC watermark
    (RedundantBefore.java:49-529): their slots become reusable.

    redundant_before: [5] int32 packed lanes."""
    with span("accord.gc"):
        applied = ((state.status == gs.APPLIED)
                   | (state.status == gs.INVALIDATED))
        below = gs.ts_less(state.txn_id, redundant_before[None, :])
        return gs.evict_mask(state, ~(applied & below & state.active))


def txn_step(state: gs.GraphState, batch: TxnBatch
             ) -> Tuple[gs.GraphState, torch.Tensor, torch.Tensor]:
    """The full step: witness a batch, stabilise it at its proposed
    timestamps (fast path: executeAt == txnId when no conflict is later; slow
    path: conflict_max.next), then run one execution wave.  Takes the state
    over and writes it in place (module doc).

    Returns (state', deps [B, T], applied_mask [T])."""
    with span("accord.step"):
        state, deps, conflict_max, any_dep = _preaccept(state, batch,
                                                        inplace=True)
        # fast-path: no conflict later than us -> executeAt = txnId
        fast = ~any_dep | gs.ts_less(conflict_max, batch.txn_id)
        exec_at = torch.where(fast[:, None], batch.txn_id,
                              gs.ts_next(conflict_max, 0))
        state = _stabilise(state, batch.slots, exec_at, batch.valid,
                           inplace=True)
        state, applied = _execute(state, inplace=True)
        return state, deps, applied


def txn_step_scan(state: gs.GraphState, batches: TxnBatch
                  ) -> Tuple[gs.GraphState, torch.Tensor]:
    """Run txn_step over a stacked sequence of batches (fields with a
    leading iteration axis [N, ...]).  Takes the state over, as txn_step.

    Returns (state', applied_count [N] int32)."""
    counts = []
    for n in range(batches.slots.shape[0]):
        state, _deps, applied = txn_step(
            state, TxnBatch(*(field[n] for field in batches)))
        counts.append(applied.sum(dtype=torch.int32))
    if not counts:
        return state, torch.zeros((0,), dtype=torch.int32,
                                  device=state.status.device)
    return state, torch.stack(counts)
