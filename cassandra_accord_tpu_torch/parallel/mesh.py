"""Multi-device sharding of the conflict-graph data plane, over torch.distributed.

Port of ``cassandra_accord_tpu/parallel/mesh.py``.  The reference shards one
command store's conflict graph, or many stores, over a ``jax.sharding.Mesh``
from a single controller (``shard_map``).  Here every rank is its own
process (``parallel/launch.py::run_ranks`` starts them), owns its shard on
its own device, and runs the same per-shard program; the reference's
``all_gather``/``psum`` over the mesh axis are ``torch.distributed``
collectives over the process group.

Layout (the reference's axis "shard", rank r owning block r of the rows):
- ``key_inc``  [T, K]   row-sharded over txn slots
- ``ts/txn_id`` [T, 5]  row-sharded
- ``kind/status/active`` [T] sharded
- ``adj``      [T, T]   row-sharded (each rank owns its txns' outgoing
                        dependency edges)
- incoming txn batches are REPLICATED (every rank joins them against its
  local slice)

Collectives (``all_gather_cat``, ``all_gather_stack``, ``any_over``):
- overlap_join: none — [B, K] against the local [T/n, K] rows keeps the
  output sharded by T (the join is kernel K1, per rank).
- conflict-max: a stacked gather of per-rank [B, 5] partial maxes, then a
  lane-lexicographic reduce (deterministic, rank-order independent).
- kahn frontier: a gather of the [T/n] done-vector slices (tiny), then the
  local rows of active STABLE slots against it.
- closure: a gather of the row-sharded reachability (the row-parallel
  boolean semiring squaring).

Bool tensors cross as uint8 (bool support differs between backends).  With
the ``gloo`` backend the collectives run through host memory whatever the
tensors' device; the compute stays on the rank's device.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.conflict_graph import TxnBatch
from ..ops import _kernels
from ..ops import deps_kernels as dk
from ..ops import graph_state as gs

SHARD = "shard"


class Mesh:
    """This rank's place in the process group: rank, world size, device,
    group, and the host seconds spent in collectives (``collective_s``,
    with the device synchronised around each collective while ``timed``)."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 group=None):
        self.rank = rank
        self.size = size
        self.device = device
        self.group = group
        self.timed = False
        self.collective_s = 0.0


def make_mesh(device="cuda", group=None) -> Mesh:
    """The Mesh of this process, inside an initialised process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.launch.run_ranks starts one per rank)")
    return Mesh(dist.get_rank(group), dist.get_world_size(group),
                resolve_device(device), group)


def state_specs() -> gs.GraphState:
    """Shard dim per GraphState field: 0 = row-sharded over txn slots (the
    reference's ``P(SHARD, ...)``)."""
    return gs.GraphState(key_inc=0, ts=0, txn_id=0, kind=0, status=0, adj=0,
                         active=0)


def batch_specs() -> TxnBatch:
    """Incoming batches are replicated on every rank (the reference's
    ``P()``)."""
    return TxnBatch(slots=None, key_inc=None, txn_id=None, kind=None,
                    valid=None)


class Coo(NamedTuple):
    """A 0/1 int8 array given by the coordinates of its ones: ``index`` is
    one int array per dim, ``shape`` the dense shape.  Lets a rank build
    only its own rows of an array too large to ship dense (the [T, T]
    adjacency at T = 65,536 is 4 GiB)."""
    index: Tuple[np.ndarray, ...]
    shape: Tuple[int, ...]


def _block(mesh: Mesh, n: int) -> Tuple[int, int]:
    if n % mesh.size:
        raise ValueError(f"dim of {n} rows does not split over "
                         f"{mesh.size} ranks")
    rows = n // mesh.size
    return mesh.rank * rows, rows


def shard_rows(x, mesh: Mesh, dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    """This rank's block of dim 0 of ``x`` (numpy array or ``Coo``), on
    the rank's device (a copy)."""
    if isinstance(x, Coo):
        first, rows = _block(mesh, x.shape[0])
        idx = [np.asarray(i, dtype=np.int64) for i in x.index]
        mine = (idx[0] >= first) & (idx[0] < first + rows)
        out = torch.zeros((rows,) + tuple(x.shape[1:]),
                          dtype=dtype or torch.int8, device=mesh.device)
        coords = [torch.from_numpy(i[mine]).to(mesh.device) for i in idx]
        coords[0] -= first
        out[tuple(coords)] = 1
        return out
    x = np.asarray(x)
    first, rows = _block(mesh, x.shape[0])
    t = torch.from_numpy(np.ascontiguousarray(x[first:first + rows]))
    return t.to(device=mesh.device, dtype=dtype, copy=True)


def shard_state(fields, mesh: Mesh) -> gs.GraphState:
    """This rank's rows of a host GraphState (a NamedTuple or mapping of
    numpy arrays; ``adj`` may be a ``Coo``), on the rank's device."""
    if not isinstance(fields, dict):
        fields = fields._asdict()
    return gs.GraphState(**{f: shard_rows(fields[f], mesh,
                                          gs.FIELD_DTYPES[f])
                            for f in gs.GraphState._fields})


def _lex_max_over_axis0(vals: torch.Tensor) -> torch.Tensor:
    """Lexicographic max over axis 0 of [n, B, 5] int32 lane arrays."""
    tie = torch.ones(vals.shape[:2], dtype=torch.bool, device=vals.device)
    out = []
    for lane in range(vals.shape[-1]):
        v = vals[..., lane]
        m = torch.where(tie, v, torch.full_like(v, -1))
        best = m.max(dim=0).values                  # [B]
        tie = tie & (v == best[None, :])
        out.append(best.clamp_min(0))
    return torch.stack(out, dim=-1)                 # [B, 5]


# ---------------------------------------------------------------------------
# the collectives: one torch.distributed call each
# ---------------------------------------------------------------------------

def _collective(mesh: Mesh, run):
    if mesh.timed and mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    out = run()
    if mesh.timed and mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    mesh.collective_s += time.perf_counter() - t0
    return out


def _gather(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    _collective(mesh, lambda: dist.all_gather(parts, send, group=mesh.group))
    if x.dtype == torch.bool:
        parts = [p.to(torch.bool) for p in parts]
    return parts


def all_gather_cat(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    reference's ``all_gather(x, SHARD, axis=dim, tiled=True)``)."""
    return torch.cat(_gather(x, mesh), dim=dim)


def all_gather_stack(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading dim, [n, ...] (the
    reference's ``all_gather(x, SHARD)``)."""
    return torch.stack(_gather(x, mesh))


def any_over(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise: ``x`` holds on some rank (the reference's
    ``psum(x.astype(int32), SHARD) > 0``), as an int32 sum."""
    s = x.to(torch.int32)
    _collective(mesh, lambda: dist.all_reduce(s, op=dist.ReduceOp.SUM,
                                              group=mesh.group))
    return s > 0


# ---------------------------------------------------------------------------
# the sharded programs
# ---------------------------------------------------------------------------

def _local_rows(mesh: Mesh, t_local: int, slots: torch.Tensor,
                valid: torch.Tensor):
    """(rows, local slots) of the batch rows this rank writes: valid, in
    its block, and the last row in batch order to name their slot (the
    reference scatters the others to the out-of-range slot ``t_local``,
    dropped, and its CPU scatter keeps the last duplicate)."""
    first = mesh.rank * t_local
    s = slots.long()
    mine = valid.to(torch.bool) & (s >= first) & (s < first + t_local)
    lslot = torch.where(mine, s - first, t_local)
    rows = gs.last_rows(lslot, t_local + 1, keep=mine)
    return rows, lslot[rows]


def build_sharded_step(mesh: Mesh):
    """The full training-step analog over the ranks: witness a replicated
    batch against the sharded graph, stabilise, run one execution wave.
    batch.slots are GLOBAL slot ids; each rank claims the ones in its
    block.  The local state is taken over and written in place (as the
    single-card ``txn_step``).

    Returns step(state, batch) -> (state', conflict_max [B,5], applied [T])."""

    def step(state: gs.GraphState, batch: TxnBatch):
        valid = batch.valid.to(torch.bool)
        # ---- join against the local row slice (no collective) -------------
        deps_local = dk.overlap_join(state.key_inc, state.txn_id, state.kind,
                                     state.status, state.active,
                                     batch.key_inc, batch.txn_id, batch.kind)
        deps_local = deps_local & valid[:, None]                # [B, T/n]

        # ---- conflict max: combine per-rank partial maxes -----------------
        cmax_local, any_dep_local = dk.max_conflict_ts(state.ts, deps_local)
        conflict_max = _lex_max_over_axis0(all_gather_stack(cmax_local, mesh))
        any_dep = any_over(any_dep_local, mesh)

        # adjacency rows are GLOBAL width: gather the full deps row for the
        # owner of each batch txn
        deps_full = all_gather_cat(deps_local, mesh, dim=1)      # [B, T]

        fast = ~any_dep | gs.ts_less(conflict_max, batch.txn_id)
        exec_at = torch.where(fast[:, None], batch.txn_id,
                              gs.ts_next(conflict_max, 0))

        # ---- insert: each rank writes the batch rows it owns --------------
        rows, dst = _local_rows(mesh, state.txn_slots, batch.slots, valid)
        put = gs.put_rows
        state = gs.GraphState(
            key_inc=put(state.key_inc, dst, batch.key_inc[rows], True),
            ts=put(state.ts, dst, exec_at[rows], True),
            txn_id=put(state.txn_id, dst, batch.txn_id[rows], True),
            kind=put(state.kind, dst, batch.kind[rows], True),
            status=put(state.status, dst, gs.STABLE, True),
            adj=put(state.adj, dst, deps_full[rows], True),
            active=put(state.active, dst, True, True),
        )

        # ---- one execution wave: frontier over the sharded adjacency ------
        dep_done_local = ((state.status == gs.APPLIED)
                          | (state.status == gs.INVALIDATED)
                          | ~state.active)                        # [T/n]
        dep_done = all_gather_cat(dep_done_local, mesh)           # [T]
        # only the rows of active STABLE slots can be ready, so only those
        # rows of the local adjacency are read (dk.kahn_frontier's kernel)
        ready = _kernels.frontier_rows(
            state.adj, ~dep_done, state.active & (state.status == gs.STABLE))
        state = state._replace(
            status=state.status.masked_fill_(ready, gs.APPLIED))
        applied = all_gather_cat(ready, mesh)                     # [T]
        return state, conflict_max, applied

    return step


def build_sharded_store_consult(mesh: Mesh):
    """The PROTOCOL data plane over the ranks: command-store parallelism.

    Each rank owns a block of stores' conflict indexes and answers their
    consults locally (``ops.deps_kernels.consult``: K1 and K2, one store at
    a time, where the reference vmaps); the coordinator-side timestamp
    proposal takes the lexicographic max of the per-store max-conflicts
    ACROSS stores — a gather + lane-lex reduce (the device analog of
    SafeCommandStore.max_conflict merged over CommandStores.map_reduce).

    Inputs are this rank's store-stacked blocks: index arrays [Sl, T, K] /
    [Sl, T, 5] / [Sl, T] and query batches [Sl, B, K] / [Sl, B, 5] /
    [Sl, B].  Returns (deps [Sl, B, T], global_max [B, 5] replicated,
    max_lanes [Sl, B, 5]): the reference's pair, then the per-store maxes
    the reduce started from."""

    def consult(live_inc, key_inc, ts, txn_id, kind, status, active,
                q, before, qkind):
        answers = [dk.consult(*(x[s] for x in (
            live_inc, key_inc, ts, txn_id, kind, status, active, q, before,
            qkind))) for s in range(live_inc.shape[0])]
        deps = torch.stack([d for d, _ in answers])              # [Sl, B, T]
        max_lanes = torch.stack([m for _, m in answers])         # [Sl, B, 5]
        # reduce the LOCAL store axis first (a rank may own several stores
        # when S > ranks), then combine across ranks
        local_max = _lex_max_over_axis0(max_lanes)
        global_max = _lex_max_over_axis0(all_gather_stack(local_max, mesh))
        return deps, global_max, max_lanes

    return consult


def build_sharded_frontier(mesh: Mesh):
    """Per-store execution frontier over the ranks: each rank runs
    kahn_frontier on its own stores' wait graphs (no collective — stores'
    frontiers are independent; cross-store ordering flows through deps)."""

    def frontier(adj, status, active):                      # [Sl, T, T] ...
        return torch.stack([dk.kahn_frontier(adj[s], status[s], active[s])
                            for s in range(adj.shape[0])])

    return frontier


def build_sharded_closure(mesh: Mesh):
    """Row-parallel transitive closure over the ranks: ceil(log2(T)) rounds
    of (gather rows) then the local [T/n, T] @ [T, T] product."""

    def closure(adj_local: torch.Tensor) -> torch.Tensor:       # [T/n, T]
        t = adj_local.shape[1]
        iters = max(1, int(t - 1).bit_length())
        reach = adj_local.to(torch.bool)
        for _ in range(iters):
            reach_full = all_gather_cat(reach, mesh)             # [T, T]
            reach = reach | dk._bool_matmul(reach, reach_full)
        return reach

    return closure

