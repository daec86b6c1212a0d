"""Device-resident conflict-graph state for one command-store shard, in torch.

Port of ``cassandra_accord_tpu/ops/graph_state.py``: one fixed-shape tuple of
tensors covers every in-flight transaction a shard manages (the reference's
per-key CSR conflict indexes, CommandsForKey.java:615-628, as dense arrays):

- ``key_inc``   [T, K]  int8 key incidence (txn slot x key slot); key slots
                        are assigned exactly by the host, never hashed.
- ``ts``        [T, 5]  int32 execute-at lanes (witnessed-at until fixed).
- ``txn_id``    [T, 5]  int32 TxnId lanes (slot identity).
- ``kind``      [T]     int8 Txn.Kind code.
- ``status``    [T]     int8 InternalStatus code.
- ``adj``       [T, T]  int8 adjacency: adj[i, j] = 1 iff txn i depends on
                        (must execute after) txn j.
- ``active``    [T]     bool slot-occupied mask.

Timestamps cross the host/device boundary as five non-negative int32 lanes
(epoch, hlc>>31, hlc&0x7FFFFFFF, flags, node) from ``Timestamp.pack_lanes``;
lexicographic order over the lanes equals the host total order, so every
device comparison is a signed int32 compare and lanes never widen.

Every update here returns a new state and leaves its input's tensors as they
were; fields it does not change are shared with the input, as the
reference's ``_replace`` shares its buffers.  Scatters never see a duplicate
index (``last_rows``): torch leaves the winner of duplicate writes undefined
on CUDA, and the reference's CPU backend keeps the last row in batch order.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device

# InternalStatus codes mirrored from ..local.cfk.InternalStatus (kept as plain
# ints here so device code never imports the host control plane).
TRANSITIVELY_KNOWN = 0
PREACCEPTED = 1
ACCEPTED = 2
COMMITTED = 3
STABLE = 4
APPLIED = 5
INVALIDATED = 6

TS_LANES = 5  # (epoch, hlc_hi, hlc_lo, flags, node)

FIELD_DTYPES = {"key_inc": torch.int8, "ts": torch.int32,
                "txn_id": torch.int32, "kind": torch.int8,
                "status": torch.int8, "adj": torch.int8,
                "active": torch.bool}


class GraphState(NamedTuple):
    """One shard's device-resident conflict graph (see module doc)."""
    key_inc: torch.Tensor   # [T, K] int8
    ts: torch.Tensor        # [T, 5] int32 — execute-at (witnessed-at until fixed)
    txn_id: torch.Tensor    # [T, 5] int32 — slot identity
    kind: torch.Tensor      # [T] int8 — Txn.Kind code
    status: torch.Tensor    # [T] int8
    adj: torch.Tensor       # [T, T] int8
    active: torch.Tensor    # [T] bool

    @property
    def txn_slots(self) -> int:
        return self.key_inc.shape[0]

    @property
    def key_slots(self) -> int:
        return self.key_inc.shape[1]


def init_state(txn_slots: int, key_slots: int, device="cuda") -> GraphState:
    """Fresh empty shard state with static capacity (T, K) on ``device`` (the
    card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    shapes = {"key_inc": (txn_slots, key_slots), "ts": (txn_slots, TS_LANES),
              "txn_id": (txn_slots, TS_LANES), "kind": (txn_slots,),
              "status": (txn_slots,), "adj": (txn_slots, txn_slots),
              "active": (txn_slots,)}
    return GraphState(**{f: torch.zeros(shapes[f], dtype=FIELD_DTYPES[f],
                                        device=dev)
                         for f in GraphState._fields})


def state_from_numpy(fields, device="cuda") -> GraphState:
    """The reference's GraphState as numpy arrays (a NamedTuple or mapping
    with its field names) -> the port's, on ``device``.  Always copies."""
    if not isinstance(fields, Mapping):
        fields = fields._asdict()
    dev = resolve_device(device)

    def up(a, dtype):
        a = np.asarray(a)
        if not (a.flags.writeable and a.flags.c_contiguous):
            a = np.array(a)          # torch.from_numpy wants writable memory
        return torch.from_numpy(a).to(device=dev, dtype=dtype, copy=True)
    return GraphState(**{f: up(fields[f], FIELD_DTYPES[f])
                         for f in GraphState._fields})


def state_to_numpy(state: GraphState) -> dict:
    """The port's GraphState -> {field: numpy array} on the host."""
    return {f: getattr(state, f).cpu().numpy() for f in GraphState._fields}


def ts_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over packed-timestamp lanes.

    a, b: [..., 5] int32 (broadcastable).  All lanes are non-negative
    (Timestamp.pack_lanes bounds, enforced at the host boundary) so signed
    compare is safe."""
    lt = a[..., TS_LANES - 1] < b[..., TS_LANES - 1]
    for lane in range(TS_LANES - 2, -1, -1):
        lt = (a[..., lane] < b[..., lane]) | ((a[..., lane] == b[..., lane]) & lt)
    return lt


def ts_next(ts: torch.Tensor, node_id) -> torch.Tensor:
    """Smallest timestamp strictly greater than ts for the given node:
    hlc+1 (with carry hlc_lo -> hlc_hi), flags cleared, node stamped.
    ts: [..., 5] int32.

    Kept in int32 to match the reference bit for bit: at hlc_lo =
    0x7FFFFFFF, ``lo + 1`` wraps to INT32_MIN and the arithmetic ``>> 31``
    gives a carry of -1, so the result is below the input (the reference
    does the same; widening would not)."""
    lo = ts[..., 2] + 1
    carry = lo >> 31
    return torch.stack([
        ts[..., 0],
        ts[..., 1] + carry,
        lo & 0x7FFFFFFF,
        torch.zeros_like(ts[..., 3]),
        torch.full_like(ts[..., 4], int(node_id)),
    ], dim=-1)


def last_rows(slots: torch.Tensor, t: int,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices (int64, ascending) of the rows of ``slots`` [B] that are the
    last in batch order to name their slot — the row whose write the
    reference's scatter keeps — restricted to rows where ``keep`` holds.
    Writing only these rows gives the reference's answer with no duplicate
    index in the scatter."""
    s = slots.long()
    order = torch.arange(s.numel(), device=s.device)
    last = torch.full((t,), -1, dtype=torch.long, device=s.device) \
        .scatter_reduce(0, s, order, "amax", include_self=True)
    win = last[s] == order
    if keep is not None:
        win &= keep
    return torch.nonzero(win).squeeze(1)


def put_rows(x: torch.Tensor, index: torch.Tensor, values,
             inplace: bool = False) -> torch.Tensor:
    """``x`` with x[index] = values (``index`` without duplicates): a copy,
    or ``x`` itself written in place when ``inplace``."""
    out = x if inplace else x.clone()
    out[index] = values.to(x.dtype) if isinstance(values, torch.Tensor) \
        else values
    return out


def insert_batch(state: GraphState,
                 slots: torch.Tensor,       # [B] int32 target slot per new txn
                 key_inc: torch.Tensor,     # [B, K] int8
                 ts: torch.Tensor,          # [B, 5] int32
                 txn_id: torch.Tensor,      # [B, 5] int32
                 kind: torch.Tensor,        # [B] int8
                 status: torch.Tensor,      # [B] int8
                 deps_mask: torch.Tensor,   # [B, T] int8 — adjacency rows
                 ) -> GraphState:
    """Scatter a batch of newly witnessed transactions into their slots
    (host-assigned).  A slot named twice takes the batch's last row."""
    rows = last_rows(slots, state.txn_slots)
    idx = slots.long()[rows]
    return GraphState(
        key_inc=put_rows(state.key_inc, idx, key_inc[rows]),
        ts=put_rows(state.ts, idx, ts[rows]),
        txn_id=put_rows(state.txn_id, idx, txn_id[rows]),
        kind=put_rows(state.kind, idx, kind[rows]),
        status=put_rows(state.status, idx, status[rows]),
        adj=put_rows(state.adj, idx, deps_mask[rows]),
        active=put_rows(state.active, idx, True),
    )


def set_status_batch(state: GraphState, slots: torch.Tensor,
                     status: torch.Tensor) -> GraphState:
    rows = last_rows(slots, state.txn_slots)
    return state._replace(
        status=put_rows(state.status, slots.long()[rows], status[rows]))


def set_execute_at_batch(state: GraphState, slots: torch.Tensor,
                         ts: torch.Tensor) -> GraphState:
    rows = last_rows(slots, state.txn_slots)
    return state._replace(ts=put_rows(state.ts, slots.long()[rows], ts[rows]))


def _mask_cols(adj: torch.Tensor, keep_i8: torch.Tensor) -> torch.Tensor:
    """``adj * keep_i8[None, :]`` for a [T, T] int8 ``adj`` and 0/1 ``keep``,
    as a new tensor.  When a row is whole 8-byte words it is ANDed a word at
    a time with 0x00/0xFF bytes: a broadcast over single bytes runs at a
    fraction of the memory rate (about a quarter on an H100)."""
    if adj.shape[1] % 8 == 0 and adj.is_contiguous():
        mask = (-keep_i8).view(torch.int64)        # 0/1 -> 0x00/0xFF bytes
        return (adj.view(torch.int64) & mask[None, :]).view(torch.int8)
    return adj * keep_i8[None, :]


def evict_mask(state: GraphState, keep: torch.Tensor) -> GraphState:
    """Clear every slot where keep[i] is False (GC/compaction: RedundantBefore
    advancing makes applied txns evictable, Cleanup.java semantics).  Also
    clears dependency edges *onto* evicted slots — an applied/GC'd dependency
    is no longer waiting-on (Commands.java:704-705).

    The adjacency is masked without a wider temporary: one read and one
    write of [T, T], then the evicted rows zeroed."""
    keep = keep.to(torch.bool)
    keep_i8 = keep.to(torch.int8)
    keep_i32 = keep[:, None].to(torch.int32)
    adj = _mask_cols(state.adj, keep_i8).index_fill_(
        0, torch.nonzero(~keep).squeeze(1), 0)
    return GraphState(
        key_inc=state.key_inc * keep_i8[:, None],
        ts=state.ts * keep_i32,
        txn_id=state.txn_id * keep_i32,
        kind=state.kind * keep_i8,
        status=state.status * keep_i8,
        adj=adj,
        active=state.active & keep,
    )


def to_host_deps(state: GraphState) -> np.ndarray:
    """Adjacency back to host as a dense bool matrix (for parity checks)."""
    return state.adj.cpu().numpy() != 0


def adj_edges(state: GraphState):
    """The adjacency as host (src, dst) int32 edge lists — the frontier
    tier's CSR ingress (ops.frontier_kernels): work proportional to edges,
    not slots.  Edge (i, j) = txn i waits on txn j, matching ``adj``."""
    src, dst = np.nonzero(state.adj.cpu().numpy())
    return src.astype(np.int32), dst.astype(np.int32)
