"""Inputs shared by the CPU and the card tests of the conflict-graph step's
kernels (``_kernels.write_rows``, ``_kernels.frontier_rows``,
``_kernels.lex_max_deps``) and of the join's CSR query (``deps_kernels.query_csr``), and the CSR form it
replaced, as plain torch (this module imports no JAX, so the card's tests use it).
"""
import numpy as np
import torch

from cassandra_accord_tpu_torch.ops import graph_state as gs

# batch slots and valid flags, as functions of T
WRITE_CASES = {
    "slot_named_twice": lambda t: ([3, 5, 3, 7, 5], [1, 1, 1, 1, 1]),
    "wrapped_slots": lambda t: ([-1, -t, 2, t - 1, -2], [1, 1, 1, 1, 1]),
    "slots_outside_dropped": lambda t: ([t, -t - 1, 10 * t, 4, -t - 7],
                                        [1, 1, 1, 1, 1]),
    "padding_after_last_slot": lambda t: ([t - 1, 0, 0], [1, 0, 0]),
    "valid_after_padding_at_last_slot": lambda t: ([0, 0, t - 1], [0, 0, 1]),
    "all_padding": lambda t: ([1, 2, t - 1], [0, 0, 0]),
    "one_row": lambda t: ([t // 2], [1]),
    "300_rows_with_collisions": None,
}


def write_case(name, t, k=24, seed=0):
    """(state fields, batch fields, execute_at) as numpy arrays: a live
    random state of T slots and K keys, and a batch aimed as ``name`` says
    (the last case: 300 rows with slots drawn from [-T - 3, T + 3) with
    repeats, a fifth of them padding)."""
    rng = np.random.default_rng(seed)
    if WRITE_CASES[name] is None:
        slots = rng.integers(-t - 3, t + 3, 300)
        valid = rng.random(300) < 0.8
    else:
        slots, valid = WRITE_CASES[name](t)
    slots = np.asarray(slots, np.int32)
    valid = np.asarray(valid, bool)
    b = slots.size
    active = rng.random(t) < 0.5
    lanes = rng.integers(0, 1000, (t, gs.TS_LANES)).astype(np.int32)
    fields = dict(
        key_inc=(rng.integers(-2, 3, (t, k)) * active[:, None]).astype(np.int8),
        ts=lanes + 3, txn_id=lanes,
        kind=rng.integers(0, 6, t).astype(np.int8),
        status=rng.integers(0, 7, t).astype(np.int8),
        adj=((rng.random((t, t)) < 0.1) * rng.integers(1, 4, (t, t)))
        .astype(np.int8),
        active=active)
    batch = dict(slots=slots,
                 key_inc=rng.integers(-3, 4, (b, k)).astype(np.int8),
                 txn_id=rng.integers(0, 2000, (b, 5)).astype(np.int32),
                 kind=rng.integers(0, 6, b).astype(np.int8),
                 valid=valid)
    deps = rng.random((b, t)) < 0.3
    exec_at = rng.integers(0, 3000, (b, 5)).astype(np.int32)
    return fields, batch, deps, exec_at


# (adj, status, active) builders, as functions of (rng, T)
def _frontier_none_ready(rng, t):
    status = rng.choice([gs.PREACCEPTED, gs.APPLIED, gs.COMMITTED], t)
    return rng.random((t, t)) < 0.05, status, np.ones(t, bool)


def _frontier_all_ready(rng, t):
    return np.zeros((t, t), bool), np.full(t, gs.STABLE), np.ones(t, bool)


def _frontier_blocked_by_last_column(rng, t):
    """Every row but the last has one edge, onto the last column; the last
    slot is stable (blocked) and so blocks them all; the last row is
    ready."""
    adj = np.zeros((t, t), bool)
    adj[:-1, -1] = True
    return adj, np.full(t, gs.STABLE), np.ones(t, bool)


def _frontier_done_deps(rng, t):
    """Edges only onto inactive slots and INVALIDATED or APPLIED ones: every
    active stable row is ready."""
    active = rng.random(t) < 0.7
    status = np.where(rng.random(t) < 0.5, gs.STABLE,
                      rng.choice([gs.INVALIDATED, gs.APPLIED], t))
    done = ~active | (status != gs.STABLE)
    adj = (rng.random((t, t)) < 0.2) & done[None, :]
    return adj, status, active


def _frontier_mixed(rng, t):
    adj = (rng.random((t, t)) < 0.01) * rng.integers(-128, 128, (t, t))
    return (adj, rng.choice([gs.STABLE, gs.APPLIED, gs.INVALIDATED,
                             gs.PREACCEPTED], t), rng.random(t) < 0.9)


FRONTIER_CASES = {
    "no_ready_row": _frontier_none_ready,
    "every_row_ready": _frontier_all_ready,
    "blocked_only_by_last_column": _frontier_blocked_by_last_column,
    "inactive_and_invalidated_deps": _frontier_done_deps,
    "mixed_signed_bytes": _frontier_mixed,
}


def frontier_case(name, t, seed=0):
    """(adj int8 [T, T], status int8 [T], active bool [T]) as numpy."""
    adj, status, active = FRONTIER_CASES[name](np.random.default_rng(seed), t)
    return (np.asarray(adj).astype(np.int8), np.asarray(status, np.int8),
            np.asarray(active, bool))


# [B, K] int8 queries, as functions of (rng, B, K)
CSR_CASES = {
    "rows_without_keys": lambda rng, b, k: (
        (rng.random((b, k)) < 0.05) * (rng.random((b, 1)) < 0.5)),
    "no_key_at_all": lambda rng, b, k: np.zeros((b, k)),
    "row_with_all_keys": lambda rng, b, k: np.concatenate(
        [np.ones((1, k)), rng.random((b - 1, k)) < 0.1]),
    "signed_values": lambda rng, b, k: (
        (rng.random((b, k)) < 0.2) * rng.integers(-128, 128, (b, k))),
}


def csr_query(name, b, k, seed=0):
    return np.asarray(CSR_CASES[name](np.random.default_rng(seed), b, k)) \
        .astype(np.int8)


def nonzero_csr(q):
    """The CSR query ``query_csr`` built before, sized by a ``nonzero``
    read back: offsets [B+1], cols [N] int32 and their int8 values [N]."""
    nz = torch.nonzero(q)
    offsets = torch.zeros((q.shape[0] + 1,), dtype=torch.int32,
                          device=q.device)
    offsets[1:] = torch.cumsum(torch.bincount(nz[:, 0],
                                              minlength=q.shape[0]), 0)
    return (offsets, nz[:, 1].to(torch.int32).contiguous(),
            q[nz[:, 0], nz[:, 1]].contiguous())


# the lex max's rows: all-false, all-true, then by density
LEX_ROWS = ("none", "all", 0.001, 0.05, 0.9)
MAXL = 0x7FFFFFFF
# lanes as int32 draws: the whole range with its edges and -1, -2, 0 mixed
# in; ties on the first three lanes; or every slot equal on lanes 0 and 1,
# so an all-true row sees no seed until lane 2 (csrc/lex_max.cu's rule)
LEX_LANES = ("wide", "ties", "uniform")
_EDGES = np.array([-2 ** 31, -2, -1, 0, 1, MAXL], dtype=np.int64)


def lex_case(lanes, b, t, start=0, seed=0):
    """(ts [T, 5] int32, deps [B, T] bool) as numpy arrays: row i takes
    ``LEX_ROWS[(i + start) % 5]``, the lanes as ``lanes`` says."""
    rng = np.random.default_rng(seed)
    ts = rng.integers(-2 ** 31, 2 ** 31, (t, gs.TS_LANES), dtype=np.int64)
    edge = rng.random((t, gs.TS_LANES)) < 0.3
    ts[edge] = rng.choice(_EDGES, int(edge.sum()))
    if lanes == "ties":
        ts[:, :3] = rng.choice(np.array([-2, -1, 0, 1, MAXL]), (t, 3))
    elif lanes == "uniform":
        ts[:, 0] = 7
        ts[:, 1] = -5
        ts[:, 2:] = rng.choice(np.array([-3, -1, 0, 2, MAXL]),
                               (t, gs.TS_LANES - 2))
    deps = np.zeros((b, t), dtype=bool)
    for i in range(b):
        kind = LEX_ROWS[(i + start) % len(LEX_ROWS)]
        if kind == "all":
            deps[i] = True
        elif kind != "none":
            deps[i] = rng.random(t) < kind
    return ts.astype(np.int32), deps
