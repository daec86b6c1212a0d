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
key overlap is its test, the signed sum of the products > 0.  The join
functions hand the ``[T, K]`` index and the ``[B, K]`` query as they lie
to the dense kernels K1d/K2d on that layout (``_kernels.deps_join_tk`` /
``max_conflict_tk``, csrc/dense_join_tk.cu) when
``_kernels.join_form(..., layout="tk")`` says dense (K % 16 == 0 and
aligned bases) or ``form="dense"`` forces it (a shape they refuse then
raises); otherwise (or with ``form="csr"``) they convert to the ``[K, T]``
wrappers' layout — the incidence transposed to ``[K, T]`` int8 bytes, the
query to CSR with its values beside the columns, whose size is read back —
and call the CSR kernels K1 (``_kernels.deps_join``) and/or K2
(``_kernels.max_conflict``, csrc/consult.cu) with those values, which sum
the signed products as the [T, K] kernels do.  On CPU tensors every
wrapper runs its plain torch version.
The graph functions are ``jax.jit`` code in the reference, not Pallas, so
they are torch ops on the tensors' device; their while loops are Python
loops with the reference's bounds, reading one flag back from the device
per round.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from ._kernels import lex_max_masked as _lex_max_masked
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


def _bool_matvec(a: torch.Tensor, v: torch.Tensor,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[R] bool: row r of the [T, N] 0/1 matrix ``a`` (row ``rows[r]`` when
    ``rows`` is given) meets the [N] bool ``v``, i.e. the rows of
    ``_bool_matmul(a, v[:, None])[:, 0]`` — on ``a``'s own int8/bool
    elements in row chunks, never as a full-size float copy (at T = 65,536
    the adjacency is 4 GiB of int8)."""
    n = a.shape[1]
    r = a.shape[0] if rows is None else rows.numel()
    out = torch.empty((r,), dtype=torch.bool, device=a.device)
    vv = v.to(torch.bool).to(a.dtype)[None, :]
    step = max(1, MATVEC_CHUNK_ELEMS // max(1, n))
    for r0 in range(0, r, step):
        block = a[r0:r0 + step] if rows is None \
            else a.index_select(0, rows[r0:r0 + step])
        torch.any(block * vv, dim=1, out=out[r0:r0 + step])
    return out


def incidence_T(inc: torch.Tensor) -> torch.Tensor:
    """[T, K] incidence -> the kernels' [K, T] uint8 layout, each byte the
    value's int8 (K1/K2 read them signed when the query brings values)."""
    return _s8(inc).t().contiguous().view(torch.uint8)


def query_csr(batch_key_inc: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense [B, K] query -> CSR over its nonzero entries, row-major:
    offsets [B+1] and cols [N] int32, and their int8 values [N]."""
    b = batch_key_inc.shape[0]
    q = _s8(batch_key_inc)
    with span("accord.sync.query_csr"):
        nz = torch.nonzero(q)                                       # [N, 2]
    # two host syncs on the card: torch reads the rows' min and max back
    with span("accord.sync.bincount"):
        counts = torch.bincount(nz[:, 0], minlength=b)
    offsets = torch.zeros((b + 1,), dtype=torch.int32,
                          device=batch_key_inc.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return (offsets, nz[:, 1].to(torch.int32).contiguous(),
            q[nz[:, 0], nz[:, 1]].contiguous())


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


def _tk_dense(form: str, *incidences: torch.Tensor) -> bool:
    """Whether a call over these [T, K] incidences (the query last, as
    ``_s8`` gives them) goes to the [T, K] kernels: by the rule for
    "auto" (an index or query they cannot take goes to CSR), always for a
    forced "dense" (which raises on such a one), never for "csr"."""
    _kernels._check_form(form)
    if form == "csr":
        return False
    t, k = incidences[0].shape
    on_card = incidences[0].device.type == "cuda"
    why = _kernels.tk_refusal(k, *(incidences if on_card else ()))
    if form == "dense":
        if why is not None:
            raise ValueError(f"the [T, K] kernels take {why}")
        return True
    b = incidences[-1].shape[0]
    return why is None and _kernels.join_form(b, t, k, layout="tk") == "dense"


def _join(index_key_inc, index_txn_id, index_kind, index_status, index_active,
          batch_key_inc, batch_before, batch_kind, packed=False, form="auto"):
    inc, query = _s8(index_key_inc), _s8(batch_key_inc)
    if _tk_dense(form, inc, query):
        # the [T, K] route's one launch; the CSR route's syncs have spans
        # of their own in ``query_csr``
        with span("accord.kernel.join_tk"):
            return _kernels.deps_join_tk(
                inc, _i32(index_txn_id), _i8(index_kind), _i8(index_status),
                _bool(index_active), query, _i32(batch_before),
                _i8(batch_kind), packed=packed)
    offsets, cols, vals = query_csr(query)
    return _kernels.deps_join(
        incidence_T(inc), _i32(index_txn_id), _i8(index_kind),
        _i8(index_status), _bool(index_active), offsets, cols,
        _i32(batch_before), _i8(batch_kind), packed=packed, form="csr",
        vals=vals)


def overlap_join(index_key_inc: torch.Tensor,   # [T, K] int8 — in-flight txns
                 index_txn_id: torch.Tensor,    # [T, 5] int32 — their TxnIds
                 index_kind: torch.Tensor,      # [T] int8
                 index_status: torch.Tensor,    # [T] int8
                 index_active: torch.Tensor,    # [T] bool
                 batch_key_inc: torch.Tensor,   # [B, K] int8 — new txns' keys
                 batch_before: torch.Tensor,    # [B, 5] int32 — started-before bound
                 batch_kind: torch.Tensor,      # [B] int8
                 form: str = "auto",
                 ) -> torch.Tensor:
    """For each of B new transactions, the set of in-flight txns it must
    depend on: shares >=1 key, witness-matrix hit, active, not invalidated,
    and STARTED BEFORE the query bound (mapReduceActive's
    TestStartedAt.STARTED_BEFORE, SafeCommandStore.java:65-72).  ``form``
    picks K1's kernel (``_kernels.join_form`` with ``layout="tk"``).

    Returns deps: [B, T] bool."""
    return _join(index_key_inc, index_txn_id, index_kind, index_status,
                 index_active, batch_key_inc, batch_before, batch_kind,
                 form=form)


def max_conflict_keys(index_key_inc: torch.Tensor,  # [T, K] int8
                      index_ts: torch.Tensor,       # [T, 5] int32 executeAt
                      index_txn_id: torch.Tensor,   # [T, 5] int32
                      index_active: torch.Tensor,   # [T] bool
                      batch_key_inc: torch.Tensor,  # [B, K] int8
                      form: str = "auto",
                      ) -> torch.Tensor:
    """Per query, the lexicographic max of max(executeAt, txnId) over every
    active indexed txn sharing a key.  Returns [B, 5] int32 (zero lanes =
    none)."""
    inc, query = _s8(index_key_inc), _s8(batch_key_inc)
    if _tk_dense(form, inc, query):
        return _kernels.max_conflict_tk(inc, _i32(index_ts),
                                        _i32(index_txn_id),
                                        _bool(index_active), query)
    offsets, cols, vals = query_csr(query)
    return _kernels.max_conflict(
        incidence_T(inc), _i32(index_ts), _i32(index_txn_id),
        _bool(index_active), offsets, cols, form="csr", vals=vals)


def _consult(index_live_inc, index_key_inc, index_ts, index_txn_id,
             index_kind, index_status, index_active, batch_key_inc,
             batch_before, batch_kind, packed, form):
    live, key, query = (_s8(x) for x in (index_live_inc, index_key_inc,
                                         batch_key_inc))
    if _tk_dense(form, live, key, query):
        txn_id, active = _i32(index_txn_id), _bool(index_active)
        deps = _kernels.deps_join_tk(
            live, txn_id, _i8(index_kind), _i8(index_status), active, query,
            _i32(batch_before), _i8(batch_kind), packed=packed)
        return deps, _kernels.max_conflict_tk(key, _i32(index_ts), txn_id,
                                              active, query)
    offsets, cols, vals = query_csr(query)
    deps = _kernels.deps_join(
        incidence_T(live), _i32(index_txn_id), _i8(index_kind),
        _i8(index_status), _bool(index_active), offsets, cols,
        _i32(batch_before), _i8(batch_kind), packed=packed, form="csr",
        vals=vals)
    max_lanes = _kernels.max_conflict(
        incidence_T(key), _i32(index_ts), _i32(index_txn_id),
        _bool(index_active), offsets, cols, form="csr", vals=vals)
    return deps, max_lanes


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
            form: str = "auto",
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused replica consult: the dependency calculation over the LIVE
    incidence (covered bits implement cfk transitive elision,
    CommandsForKey.java:144-157) and the timestamp-proposal max over the
    FULL incidence (elision never applies to MaxConflicts).  ``form`` picks
    K1's and K2's kernels (``_kernels.join_form``).

    Returns (deps [B, T] bool, max_lanes [B, 5] int32)."""
    return _consult(index_live_inc, index_key_inc, index_ts, index_txn_id,
                    index_kind, index_status, index_active, batch_key_inc,
                    batch_before, batch_kind, packed=False, form=form)


def consult_packed(index_live_inc: torch.Tensor, index_key_inc: torch.Tensor,
                   index_ts: torch.Tensor, index_txn_id: torch.Tensor,
                   index_kind: torch.Tensor, index_status: torch.Tensor,
                   index_active: torch.Tensor, batch_key_inc: torch.Tensor,
                   batch_before: torch.Tensor, batch_kind: torch.Tensor,
                   form: str = "auto",
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``consult`` with the deps mask BIT-PACKED ([B, T/8] uint8,
    little-endian bit order, T a multiple of 8): the [B, T] bool result is
    8x larger than the answer it carries, and at T = 64k it is most of what
    crosses back to the host.  Hosts unpack with np.unpackbits."""
    return _consult(index_live_inc, index_key_inc, index_ts, index_txn_id,
                    index_kind, index_status, index_active, batch_key_inc,
                    batch_before, batch_kind, packed=True, form=form)


def max_conflict_ts(index_exec_at: torch.Tensor,  # [T, 5] int32
                    deps: torch.Tensor,           # [B, T] bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per new txn, the lexicographic max executeAt over its conflict set —
    the ``maxConflicts`` input to the replica-side timestamp proposal
    (PreAccept.java:245-267, MaxConflicts.java:32).  The proposal itself
    stays on the host (its HLC register is host clock state).

    Returns (conflict_max [B, 5] int32, any_dep [B] bool)."""
    deps = deps.to(torch.bool)
    return (_lex_max_masked(index_exec_at[None, :, :], deps),
            torch.any(deps, dim=1))


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
    the adjacency are read (the reference's product covers every row and
    masks the others out after: the same answer)."""
    dep_done = (status == APPLIED) | (status == INVALIDATED) | ~active
    ready = active & (status == STABLE)
    with span("accord.sync.frontier"):
        rows = torch.nonzero(ready).squeeze(1)
    ready[rows] = ~_bool_matvec(adj, ~dep_done, rows)
    return ready


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
