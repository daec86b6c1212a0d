"""Batched dependency-graph kernels, in torch: join, closure, elision, Kahn, SCC.

Port of ``cassandra_accord_tpu/ops/deps_kernels.py`` with the same public
signatures: ``[T, K]`` int8 index incidence, ``[B, K]`` int8 query
incidence, ``[*, 5]`` int32 timestamp lanes, ``[T, T]`` int8 adjacency.

- ``overlap_join``      <- ``CommandsForKey.mapReduceActive`` per-key scans
                          (cfk/CommandsForKey.java:925-1000) + KeyDeps
                          builder merges: every in-flight txn a new txn must
                          depend on (shares a key, witness hit, active, not
                          invalidated, started before the bound).
- ``max_conflict_keys`` <- the per-key MaxConflicts consult of the replica
                          timestamp proposal (MaxConflicts.java:32).
- ``consult``/``consult_packed`` <- both halves fused per query batch.
- ``max_conflict_ts``   <- MaxConflicts over a deps mask (PreAccept.java).
- ``transitive_closure``/``elide`` <- the reachability the reference keeps
                          by deps-by-omission (CommandsForKey.java:101-157).
- ``kahn_frontier``/``kahn_levels`` <- the WaitingOn execution frontier
                          (Commands.maybeExecute, Commands.java:617).
- ``scc_condense``      <- cycle handling (Commands.java:707-775).

The incidences are the reference's int8 values (bool read as 0/1), and the
key overlap is its test, the signed sum of the products > 0.  Every join
entry takes one route (``_consult``): the dense kernels on the ``[T, K]``
index and the ``[B, K]`` query as they lie (``_kernels.deps_join_tk`` /
``max_conflict_tk``, csrc/dense_join_tk.cu) unless ``_kernels.tk_refusal``
refuses them (K % 16 != 0, or a base not 16-byte aligned); then the
``[K, T]`` wrappers' layout — the incidence transposed to ``[K, T]`` int8
bytes, the query to CSR with its values beside the columns, at a capacity
fixed by its shape (``query_csr``: nothing read back) — and the CSR
kernels K1 (``_kernels.deps_join``) and/or K2 (``_kernels.max_conflict``,
csrc/consult.cu) with those values, which sum the signed products as the
[T, K] kernels do.  ``max_conflict_ts`` is one kernel,
``_kernels.lex_max_deps`` (csrc/lex_max.cu).  On CPU tensors every wrapper
runs its plain torch version.
The graph functions are ``jax.jit`` code in the reference, not Pallas, so
they are torch ops on the tensors' device, but for ``kahn_frontier``'s row
test (``_kernels.frontier_rows``); their while loops are Python loops with
the reference's bounds, reading one flag back from the device per round.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels
from ._kernels import witness_table as _witness_table
from .graph_state import APPLIED, INVALIDATED, STABLE
from ..observe.profiler import span

WITNESSES = torch.as_tensor(_witness_table())

# rows of a [T, T] operand handled per step of ``_bool_matvec``: about 32 MB
# of int8, so the step's temporaries stay small beside the 50 MB L2 of an
# H100 and no full-size wide copy of the adjacency is ever made
MATVEC_CHUNK_ELEMS = 1 << 25


def _bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean matrix product (a @ b) > 0 of 0/1 operands.

    One torch.matmul on float copies: bf16 on CUDA (the tensor cores), f32
    elsewhere.  Either is exact for this test: every product is 0 or 1 and
    the sum accumulates in f32 (or rounds to bf16), so it is > 0 iff some
    product is 1 — a positive count stays positive in any float rounding,
    and TF32's 10-bit mantissa holds 0 and 1 exactly.  Never an int8 or
    uint8 sum, which would wrap to 0 at 256."""
    dt = torch.bfloat16 if a.device.type == "cuda" else torch.float32
    return torch.matmul(a.to(dt), b.to(dt)) > 0


def _bool_matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[T] bool: row r of the [T, N] 0/1 matrix ``a`` meets the [N] bool
    ``v``, i.e. ``_bool_matmul(a, v[:, None])[:, 0]`` — on ``a``'s own
    int8/bool elements in row chunks, never as a full-size float copy (at
    T = 65,536 the adjacency is 4 GiB of int8)."""
    r, n = a.shape
    out = torch.empty((r,), dtype=torch.bool, device=a.device)
    vv = v.to(torch.bool).to(a.dtype)[None, :]
    step = max(1, MATVEC_CHUNK_ELEMS // max(1, n))
    for r0 in range(0, r, step):
        torch.any(a[r0:r0 + step] * vv, dim=1, out=out[r0:r0 + step])
    return out


def incidence_T(inc: torch.Tensor) -> torch.Tensor:
    """[T, K] incidence -> the kernels' [K, T] uint8 layout, each byte the
    value's int8 (K1/K2 read them signed when the query brings values)."""
    return _s8(inc).t().contiguous().view(torch.uint8)


def query_csr(batch_key_inc: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense [B, K] query -> CSR over its nonzero entries, row-major:
    offsets [B+1] int32, and cols int32 and their int8 values at a capacity
    of B*K, the first offsets[B] of them the entries (the kernels and plain
    versions read no further; the rest are 0).  Fixed shapes throughout, so
    nothing is read back from the card: each entry's place is its count of
    nonzero entries before it, and the others go to one spare place past
    the capacity, dropped."""
    b, k = batch_key_inc.shape
    q = _s8(batch_key_inc).reshape(-1)
    dev = q.device
    nz = q != 0
    at = torch.cumsum(nz, 0)                            # [B*K] int64
    offsets = torch.zeros((b + 1,), dtype=torch.int32, device=dev)
    if k:
        offsets[1:] = at.view(b, k)[:, -1]
    place = torch.where(nz, at - 1, b * k)
    col = torch.arange(k, dtype=torch.int32, device=dev).repeat(b)
    cols = torch.zeros((b * k + 1,), dtype=torch.int32, device=dev) \
        .scatter_(0, place, col)
    vals = torch.zeros((b * k + 1,), dtype=torch.int8, device=dev) \
        .scatter_(0, place, q)
    return offsets, cols[:-1], vals[:-1]


def _i8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int8).contiguous()


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _bool(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bool).contiguous()


def _s8(x: torch.Tensor) -> torch.Tensor:
    """An incidence as the kernels read it: int8 values, the reference's
    operand type (it multiplies them as bf16).  int8 and bool tensors are
    viewed, not copied; others are converted (``.to(torch.int8)``, so
    values outside [-128, 127] lie outside the contract)."""
    x = x.contiguous()
    if x.dtype == torch.int8:
        return x
    if x.dtype == torch.bool:
        return x.view(torch.int8)
    return x.to(torch.int8)


def _consult(index_live_inc, index_key_inc, index_ts, index_txn_id,
             index_kind, index_status, index_active, batch_key_inc,
             batch_before, batch_kind, packed=False):
    """The [T, K] route of every join entry: (deps, max_lanes), the deps
    half over ``index_live_inc`` and the max half over ``index_key_inc``,
    either one skipped (None) where its index is None.  The ``_tk`` kernels
    take the index and the query as they lie unless ``tk_refusal`` refuses
    them; then each index is transposed (``incidence_T``), the query turns
    into one CSR query with values (``query_csr``) and K1/K2 run on those."""
    live, key, query = (None if x is None else _s8(x) for x in (
        index_live_inc, index_key_inc, batch_key_inc))
    on_card = query.device.type == "cuda"
    tk = _kernels.tk_refusal(query.shape[1], *(
        x for x in (live, key, query) if on_card and x is not None)) is None
    if not tk:
        offsets, cols, vals = query_csr(query)
    txn_id, active = _i32(index_txn_id), _bool(index_active)
    deps = max_lanes = None
    if live is not None:
        slots = (txn_id, _i8(index_kind), _i8(index_status), active)
        if tk:
            # the [T, K] route's one launch (the span tells the routes apart)
            with span("accord.kernel.join_tk"):
                deps = _kernels.deps_join_tk(
                    live, *slots, query, _i32(batch_before), _i8(batch_kind),
                    packed=packed)
        else:
            deps = _kernels.deps_join(
                incidence_T(live), *slots, offsets, cols, _i32(batch_before),
                _i8(batch_kind), packed=packed, vals=vals)
    if key is not None:
        ts = _i32(index_ts)
        max_lanes = _kernels.max_conflict_tk(key, ts, txn_id, active, query) \
            if tk else _kernels.max_conflict(incidence_T(key), ts, txn_id,
                                             active, offsets, cols, vals=vals)
    return deps, max_lanes


def overlap_join(index_key_inc: torch.Tensor,   # [T, K] int8 — in-flight txns
                 index_txn_id: torch.Tensor,    # [T, 5] int32 — their TxnIds
                 index_kind: torch.Tensor,      # [T] int8
                 index_status: torch.Tensor,    # [T] int8
                 index_active: torch.Tensor,    # [T] bool
                 batch_key_inc: torch.Tensor,   # [B, K] int8 — new txns' keys
                 batch_before: torch.Tensor,    # [B, 5] int32 — started-before bound
                 batch_kind: torch.Tensor,      # [B] int8
                 ) -> torch.Tensor:
    """For each of B new transactions, the set of in-flight txns it must
    depend on: shares >=1 key, witness-matrix hit, active, not invalidated,
    and STARTED BEFORE the query bound (mapReduceActive's
    TestStartedAt.STARTED_BEFORE, SafeCommandStore.java:65-72).

    Returns deps: [B, T] bool."""
    return _consult(index_key_inc, None, None, index_txn_id, index_kind,
                    index_status, index_active, batch_key_inc, batch_before,
                    batch_kind)[0]


def max_conflict_keys(index_key_inc: torch.Tensor,  # [T, K] int8
                      index_ts: torch.Tensor,       # [T, 5] int32 executeAt
                      index_txn_id: torch.Tensor,   # [T, 5] int32
                      index_active: torch.Tensor,   # [T] bool
                      batch_key_inc: torch.Tensor,  # [B, K] int8
                      ) -> torch.Tensor:
    """Per query, the lexicographic max of max(executeAt, txnId) over every
    active indexed txn sharing a key.  Returns [B, 5] int32 (zero lanes =
    none)."""
    return _consult(None, index_key_inc, index_ts, index_txn_id, None, None,
                    index_active, batch_key_inc, None, None)[1]


def consult(index_live_inc: torch.Tensor,  # [T, K] int8 — covered bits zeroed
            index_key_inc: torch.Tensor,   # [T, K] int8 — full incidence
            index_ts: torch.Tensor,        # [T, 5] int32 executeAt
            index_txn_id: torch.Tensor,    # [T, 5] int32
            index_kind: torch.Tensor,      # [T] int8
            index_status: torch.Tensor,    # [T] int8
            index_active: torch.Tensor,    # [T] bool
            batch_key_inc: torch.Tensor,   # [B, K] int8
            batch_before: torch.Tensor,    # [B, 5] int32
            batch_kind: torch.Tensor,      # [B] int8
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused replica consult: the dependency calculation over the LIVE
    incidence (covered bits implement cfk transitive elision,
    CommandsForKey.java:144-157) and the timestamp-proposal max over the
    FULL incidence (elision never applies to MaxConflicts).

    Returns (deps [B, T] bool, max_lanes [B, 5] int32)."""
    return _consult(index_live_inc, index_key_inc, index_ts, index_txn_id,
                    index_kind, index_status, index_active, batch_key_inc,
                    batch_before, batch_kind)


def consult_packed(index_live_inc: torch.Tensor, index_key_inc: torch.Tensor,
                   index_ts: torch.Tensor, index_txn_id: torch.Tensor,
                   index_kind: torch.Tensor, index_status: torch.Tensor,
                   index_active: torch.Tensor, batch_key_inc: torch.Tensor,
                   batch_before: torch.Tensor, batch_kind: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``consult`` with the deps mask BIT-PACKED ([B, T/8] uint8,
    little-endian bit order, T a multiple of 8): the [B, T] bool result is
    8x larger than the answer it carries, and at T = 64k it is most of what
    crosses back to the host.  Hosts unpack with np.unpackbits."""
    return _consult(index_live_inc, index_key_inc, index_ts, index_txn_id,
                    index_kind, index_status, index_active, batch_key_inc,
                    batch_before, batch_kind, packed=True)


def max_conflict_ts(index_exec_at: torch.Tensor,  # [T, 5] int32
                    deps: torch.Tensor,           # [B, T] bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per new txn, the lexicographic max executeAt over its conflict set —
    the ``maxConflicts`` input to the replica-side timestamp proposal
    (PreAccept.java:245-267, MaxConflicts.java:32).  The proposal itself
    stays on the host (its HLC register is host clock state).

    Both come from one pass over the deps rows
    (``_kernels.lex_max_deps``, csrc/lex_max.cu on the card).

    Returns (conflict_max [B, 5] int32, any_dep [B] bool)."""
    return _kernels.lex_max_deps(_i32(index_exec_at), _bool(deps))


# ---------------------------------------------------------------------------
# Transitive closure / elision
# ---------------------------------------------------------------------------

def transitive_closure(adj: torch.Tensor) -> torch.Tensor:
    """Reachability closure of a [T, T] 0/1 adjacency by repeated squaring:
    R_{k+1} = R_k | R_k @ R_k, log2(T)+1 iterations.  Returns [T, T] bool."""
    t = adj.shape[0]
    iters = max(1, int(t - 1).bit_length())
    reach = adj.to(torch.bool)
    for _ in range(iters):
        reach = reach | _bool_matmul(reach, reach)
    return reach


def elide(adj: torch.Tensor) -> torch.Tensor:
    """Transitive reduction on DAG edges: drop i->j if a path i->k->..->j
    exists (CommandsForKey.java:144-157).  Edges inside a cycle are kept.
    Returns [T, T] bool."""
    a = adj.to(torch.bool)
    reach = transitive_closure(a)
    implied = _bool_matmul(a, reach)   # path of length >= 2
    in_cycle = reach & reach.T
    return a & (~implied | in_cycle)


# ---------------------------------------------------------------------------
# Execution frontier (Kahn) and full schedule
# ---------------------------------------------------------------------------

def kahn_frontier(adj: torch.Tensor, status: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """Which txns are ready to execute NOW: stable, active, and every
    dependency already applied/invalidated/evicted (Commands.maybeExecute,
    Commands.java:617-652).  Returns [T] bool.

    Only the rows of active STABLE slots can be ready, so only those rows of
    the adjacency are read (``_kernels.frontier_rows``: one launch on the
    card, nothing read back; the reference's product covers every row and
    masks the others out after: the same answer)."""
    dep_done = (status == APPLIED) | (status == INVALIDATED) | ~active
    return _kernels.frontier_rows(adj, ~dep_done, active & (status == STABLE))


def peel_levels(ready, active: torch.Tensor) -> torch.Tensor:
    """The level-peeling loop shared by the Kahn and SCC schedules:
    ``ready(done)`` says which slots may take the current level.  Stops
    when every active slot is done, after T levels, or on a round with no
    progress (a cycle), exactly as the reference's while loop.
    Returns [T] int32 levels, -1 where never peeled."""
    t = active.shape[0]
    level = torch.full((t,), -1, dtype=torch.int32, device=active.device)
    done = ~active
    it = 0
    while it < t and bool(torch.any(active & ~done)):
        newly = active & ~done & ready(done)
        if not bool(torch.any(newly)):
            break                               # no progress => cycle: stop
        level[newly] = it
        done = done | newly
        it += 1
    return level


def kahn_levels(adj: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Full topological schedule: level[i] = longest dependency chain below i;
    executing levels in order respects every edge.  Peels zero-indegree txns
    one level per round.  Cycle members never peel and keep level -1 (route
    them through scc_condense).  Returns [T] int32."""
    a = adj.to(torch.bool) & active[:, None] & active[None, :]
    return peel_levels(lambda done: ~_bool_matvec(a, ~done), active)


# ---------------------------------------------------------------------------
# SCC condensation (cycle-heavy adversarial graphs, BASELINE config 5)
# ---------------------------------------------------------------------------

def comp_any(labels: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """[T] bool: some slot of i's component has ``flag`` — the per-component
    max of the reference's ``zeros.at[labels].max(flag, mode="drop")``
    read back at ``labels``.  Inactive slots carry label -1 and a flag of
    0; JAX sends -1 to slot T-1, where a 0 changes nothing, and torch
    refuses -1, so those entries go to slot 0 with their 0 instead."""
    lab = labels.long().clamp_min(0)
    blocked = torch.zeros(labels.shape, dtype=torch.int32,
                          device=labels.device).scatter_reduce(
        0, lab, flag.to(torch.int32), "amax", include_self=True)
    return blocked[lab] != 0


def scc_condense(adj: torch.Tensor,
                 active: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strongly-connected-component labels via matmul reachability:
    i ~ j iff reach[i,j] & reach[j,i].  Label = smallest member slot (-1 on
    inactive slots).

    Returns (labels [T] int32, level [T] int32): level is a topological level
    over the condensation, shared by all members of an SCC."""
    t = adj.shape[0]
    a = adj.to(torch.bool) & active[:, None] & active[None, :]
    reach = transitive_closure(a)
    same = (reach & reach.T) | torch.eye(t, dtype=torch.bool, device=a.device)
    same = same & active[:, None] & active[None, :]
    idx = torch.arange(t, dtype=torch.int32, device=a.device)
    labels = torch.where(same, idx[None, :], t).amin(dim=1).to(torch.int32)
    labels = torch.where(active, labels, -1)

    cond_edge = a & (labels[:, None] != labels[None, :])

    def ready(done):
        blocked = _bool_matvec(cond_edge, ~done)
        # whole components move together: ready iff NO undone member has a
        # blocked cross-component dependency
        return ~comp_any(labels, blocked & active & ~done)

    return labels, peel_levels(ready, active)
