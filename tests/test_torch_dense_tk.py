"""The consult on the [T, K] index on the CPU: the plain [T, K] versions
(K1d/K2d _tk) and the one-shot consults by each route equal the JAX
reference bit for bit, the rule for [T, K] callers (``tk_refusal``), and
the shapes the [T, K] kernels refuse.

On the CPU the wrappers run their plain versions, so these tests hold the
arithmetic and the routing; the kernels themselves are held against the
plain versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Inputs are made with numpy from fixed seeds and handed to both packages; the
reference's Pallas join runs in interpret mode, as
``tests/test_ops_kernels.py`` runs it.  Run with

    JAX_PLATFORMS=cpu ACCORD_DEVICE=cpu python -m pytest tests/test_torch_dense_tk.py -q
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cassandra_accord_tpu.ops import deps_kernels as ref_dk
from cassandra_accord_tpu.ops.pallas_join import \
    overlap_join_fused as ref_overlap_join_fused

from cassandra_accord_tpu_torch.ops import _kernels
from cassandra_accord_tpu_torch.ops import deps_kernels as dk
from cassandra_accord_tpu_torch.ops import graph_state as gs
from cassandra_accord_tpu_torch.ops.pallas_join import overlap_join_fused

# the one-shot consults' routes: the public entry as the rule sends it
# ("auto"), the entry sent down the CSR route (transpose, CSR query with
# values, K1/K2) by a rule that refuses every shape, and the dense [T, K]
# kernels' wrappers called directly
ROUTES = ("auto", "csr", "dense")

# (T, K, B, keys per query row): config 4's shape cut to size (64 of 128
# keys a row), a T tail, a K tail the kernels take (80) and one they refuse
# (72, not a multiple of 16), one row, nine rows (the wide row's batch) and
# 300 rows (more than one 256-row tile), at a T tail and at T % 8 == 0
SHAPES = {
    "config4_like_T256_K128_B16": (256, 128, 16, 64),
    "T_tail_T1003_K64_B13": (1003, 64, 13, 8),
    "K_tail_K80": (512, 80, 9, 10),
    "K72_goes_to_csr": (512, 72, 9, 10),
    "B1": (1024, 64, 1, 12),
    "B9": (2048, 128, 9, 20),
    "B300_T1003": (1003, 64, 300, 6),
    "B300_T1024": (1024, 64, 300, 6),
}


def _case_arrays(t, k, b, per_row, seed):
    rng = np.random.default_rng(seed)
    key = (rng.random((t, k)) < 0.1).astype(np.int8)
    live = key.copy()
    live[rng.random((t, k)) < 0.2] = 0                  # covered incidences
    txn_id = np.zeros((t, gs.TS_LANES), dtype=np.int32)
    txn_id[:, 0] = 1
    txn_id[:, 2] = rng.integers(1, 500, t)
    txn_id[:, 4] = rng.integers(1, 8, t)
    ts = txn_id.copy()
    ts[:, 2] += rng.integers(0, 40, t).astype(np.int32)
    kind = rng.choice([0, 1, 3, 4], t).astype(np.int8)
    status = rng.integers(gs.PREACCEPTED, gs.INVALIDATED + 1, t).astype(np.int8)
    active = rng.random(t) < 0.9
    q = np.zeros((b, k), dtype=np.int8)
    for i in range(b):
        q[i, rng.choice(k, per_row, replace=False)] = 1
    before = np.zeros((b, gs.TS_LANES), dtype=np.int32)
    before[:, 0] = 1
    before[:, 2] = rng.integers(1, 520, b)
    before[:, 4] = rng.integers(1, 8, b)
    qkind = rng.choice([0, 1, 3, 4], b).astype(np.int8)
    return (live, key, ts, txn_id, kind, status, active, q, before, qkind)


def _ref(fn, *arrays, **kw):
    out = fn(*(jnp.asarray(a) for a in arrays), **kw)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) \
        else np.asarray(out)


def _port(fn, *arrays, **kw):
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) \
        else out.numpy()


def _assert_equal(a, b):
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _case(shape):
    """The shape's inputs (consult, join and max argument tuples) and the
    reference's answers, once per shape."""
    t, k, b, per_row = SHAPES[shape]
    c = _case_arrays(t, k, b, per_row, seed=t * 7 + k * 3 + b)
    live, key, ts, txn_id, kind, status, active, q, before, qkind = c
    join = (live, txn_id, kind, status, active, q, before, qkind)
    mc = (key, ts, txn_id, active, q)
    want = {"consult": _ref(ref_dk.consult, *c),
            "overlap_join": _ref(ref_dk.overlap_join, *join),
            "max_conflict_keys": _ref(ref_dk.max_conflict_keys, *mc)}
    if t % 8 == 0:
        want["consult_packed"] = _ref(ref_dk.consult_packed, *c)
    assert want["overlap_join"].any() and want["max_conflict_keys"].any()
    return dict(consult=c, join=join, mc=mc), want


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_tk_versions_equal_reference(shape):
    """deps_join_tk_plain (bool, and bit-packed where T % 8 == 0) on the
    live incidence and max_conflict_tk_plain on the full one equal the
    reference's consult, consult_packed, overlap_join and
    max_conflict_keys bit for bit."""
    args, want = _case(shape)
    live, key, ts, txn_id, kind, status, active, q, before, qkind = (
        torch.from_numpy(np.ascontiguousarray(a)) for a in args["consult"])
    jargs = (live, txn_id, kind, status, active, q, before, qkind)
    deps = _kernels.deps_join_tk_plain(*jargs).numpy()
    lanes = _kernels.max_conflict_tk_plain(key, ts, txn_id, active, q).numpy()
    _assert_equal(deps, want["consult"][0])
    _assert_equal(lanes, want["consult"][1])
    _assert_equal(deps, want["overlap_join"])
    _assert_equal(lanes, want["max_conflict_keys"])
    if "consult_packed" in want:
        packed = _kernels.deps_join_tk_plain(*jargs, packed=True).numpy()
        _assert_equal(packed, want["consult_packed"][0])


def _count_csr(monkeypatch, route):
    """Count the CSR route's query builds; send every call down that route
    for ``route`` "csr"."""
    built = []
    query_csr = dk.query_csr
    monkeypatch.setattr(dk, "query_csr",
                        lambda q: built.append(q.shape) or query_csr(q))
    if route == "csr":
        monkeypatch.setattr(_kernels, "tk_refusal",
                            lambda k, *tensors: "the CSR route")
    return built


def _tk_consult(live, key, ts, txn_id, kind, status, active, q, before,
                qkind, packed=False):
    return (_kernels.deps_join_tk(live, txn_id, kind, status, active, q,
                                  before, qkind, packed=packed),
            _kernels.max_conflict_tk(key, ts, txn_id, active, q))


TK_CALLS = {"consult": _tk_consult,
            "consult_packed": functools.partial(_tk_consult, packed=True),
            "overlap_join": _kernels.deps_join_tk,
            "max_conflict_keys": _kernels.max_conflict_tk}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_one_shot_consults_equal_reference(shape, route, monkeypatch):
    """consult, consult_packed (T % 8 == 0), overlap_join and
    max_conflict_keys on the CPU by ``route``: equal the reference bit for
    bit.  The entry takes the CSR route exactly where the rule refuses K
    (K = 72)."""
    monkeypatch.setenv("ACCORD_DEVICE", "cpu")
    args, want = _case(shape)
    k = SHAPES[shape][1]
    built = _count_csr(monkeypatch, route)
    calls = {"consult": (dk.consult, "consult"),
             "overlap_join": (dk.overlap_join, "join"),
             "max_conflict_keys": (dk.max_conflict_keys, "mc")}
    if "consult_packed" in want:
        calls["consult_packed"] = (dk.consult_packed, "consult")
    for name, (fn, which) in calls.items():
        got = _port(TK_CALLS[name] if route == "dense" else fn, *args[which])
        for a, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want[name]))):
            _assert_equal(a, w)
    csr = route == "csr" or (route == "auto" and k % 16 != 0)
    assert len(built) == (len(calls) if csr else 0)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_overlap_join_fused_equals_pallas_join(shape, monkeypatch):
    """The port's overlap_join_fused (its [T, K] route where the rule takes
    the shape, the CSR route at K = 72, and the CSR route where a rule that
    refuses every shape sends it) equals the reference's Pallas join in
    interpret mode bit for bit."""
    args, want = _case(shape)
    ref = _ref(ref_overlap_join_fused, *args["join"], interpret=True)
    _assert_equal(ref, want["overlap_join"])
    _assert_equal(_port(overlap_join_fused, *args["join"]), ref)
    built = _count_csr(monkeypatch, "csr")
    _assert_equal(_port(overlap_join_fused, *args["join"]), ref)
    assert len(built) == 1


# (B, T, K, the route the rule picks for a [T, K] caller: "dense" for the
# [T, K] kernels): every shape of
# PERF.md's kernel tables (the sweep measured the [T, K] kernels faster at
# each), and K outside what they take
TABLE_TK = {
    "burn_largest": (8, 256, 16, "dense"),
    "cli_largest": (8, 128, 16, "dense"),
    "odd_T": (13, 1003, 64, "dense"),
    "two_tiles": (13, 2049, 64, "dense"),
    "bench_phase_largest": (256, 4096, 512, "dense"),
    "graph_step": (256, 65536, 512, "dense"),
    "shape_A": (256, 65536, 512, "dense"),
    "mesh_rank_step": (256, 16384, 512, "dense"),
    "mesh_store_consult": (256, 65536, 512, "dense"),
    "replay_largest": (256, 65536, 1024, "dense"),
    "wide_replay_largest": (256, 4096, 8192, "dense"),
    "config4": (64, 65536, 2048, "dense"),
    "wide_row": (9, 65536, 512, "dense"),
    "K_max": (64, 4096, _kernels.DENSE_MAX_K, "dense"),
    "K_80": (33, 4096, 80, "dense"),
    "K_72": (9, 512, 72, "csr"),
    "K_8": (9, 512, 8, "csr"),
    "K_above_max": (64, 4096, _kernels.DENSE_MAX_K + 16, "csr"),
}


@pytest.mark.parametrize("shape", sorted(TABLE_TK))
def test_join_form_for_tk_callers(shape):
    """The [T, K] callers' rule, ``tk_refusal``: the [T, K] kernels for
    every K they take, whatever B and T."""
    b, t, k, want = TABLE_TK[shape]
    assert (_kernels.tk_refusal(k) is None) == (want == "dense")


@pytest.mark.parametrize("k", [72, _kernels.DENSE_MAX_K + 16])
def test_a_refused_k_takes_the_csr_route(k, monkeypatch):
    """K % 16 != 0 or K > DENSE_MAX_K: the [T, K] kernels cannot take the
    index, so the consult takes the CSR route and equals the plain [T, K]
    versions."""
    t, b = 64, 3
    c = _case_arrays(t, k, b, 4, seed=k)
    assert _kernels.tk_refusal(k) is not None
    built = _count_csr(monkeypatch, "auto")
    got = _port(dk.consult, *c)
    assert len(built) == 1
    for a, w in zip(got, _port(_tk_consult, *c)):
        _assert_equal(a, w)


def test_tk_dense_views_without_copy():
    """The [T, K] route reads an incidence as the reference does, as int8
    values: int8 and bool tensors as they lie (a view, no copy), others
    converted with their signs kept, so a -1 stays -1 and is no member."""
    x = torch.zeros((4, 16), dtype=torch.int8)
    x[1, 2] = -1
    assert dk._s8(x).data_ptr() == x.data_ptr()
    assert dk._s8(x).dtype == torch.int8
    m = x.bool()
    assert dk._s8(m).data_ptr() == m.data_ptr()
    assert dk._s8(m).dtype == torch.int8 and int(dk._s8(m)[1, 2]) == 1
    y = dk._s8(x.to(torch.int32))
    assert y.dtype == torch.int8 and int(y[1, 2]) == -1
