"""The port's consult and frontier ops against the JAX reference, bit for bit.

Inputs are made with numpy from fixed seeds and handed to both packages:
the reference runs as its own tests run it (JAX on the CPU, the Pallas join
in interpret mode), the port on the CPU by asking for it — its kernel
wrappers then run their plain torch versions.  Every output is a boolean
mask or int32 lanes, so every comparison is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cassandra_accord_tpu import ops as ref_ops
from cassandra_accord_tpu.device_service.kernel import consult_t as ref_consult_t
from cassandra_accord_tpu.ops import deps_kernels as ref_dk
from cassandra_accord_tpu.ops import frontier_kernels as ref_fk
from cassandra_accord_tpu.ops.pallas_join import \
    overlap_join_fused as ref_overlap_join_fused

from cassandra_accord_tpu_torch.device import resolve_device
from cassandra_accord_tpu_torch.device_service.batch import build_batch
from cassandra_accord_tpu_torch.device_service.kernel import ragged_consult_t
from cassandra_accord_tpu_torch.ops import _kernels
from cassandra_accord_tpu_torch.ops import deps_kernels as dk
from cassandra_accord_tpu_torch.ops import frontier_kernels as fk
from cassandra_accord_tpu_torch.ops import graph_state as gs
from cassandra_accord_tpu_torch.ops.pallas_join import overlap_join_fused
from cassandra_accord_tpu_torch.primitives.timestamp import (Domain, TxnId,
                                                             TxnKind)

T, K, B = 64, 32, 16
MAXL = 0x7FFFFFFF


def _mk_txns(rng, n, k=K):
    """n random txns touching 1-4 of k keys (tests/test_ops_kernels.py
    shape): (key_inc [n, k] int8, lanes [n, 5] int32, kinds [n] int8)."""
    key_inc = np.zeros((n, k), dtype=np.int8)
    kinds = np.zeros(n, dtype=np.int8)
    lanes = np.zeros((n, gs.TS_LANES), dtype=np.int32)
    for i in range(n):
        key_inc[i, rng.choice(k, rng.integers(1, 5), replace=False)] = 1
        kind = TxnKind(rng.choice([0, 1, 3, 4]))
        tid = TxnId(epoch=1, hlc=int(rng.integers(1, 500)),
                    node=int(rng.integers(1, 8)), kind=kind, domain=Domain.KEY)
        kinds[i] = int(kind)
        lanes[i] = tid.pack_lanes()
    return key_inc, lanes, kinds


def _mk_index(rng, t=T, k=K):
    key_inc, lanes, kinds = _mk_txns(rng, t, k)
    live = key_inc.copy()
    live[rng.random((t, k)) < 0.2] = 0                  # covered incidences
    ts = lanes.copy()
    ts[:, 2] += rng.integers(-3, 40, t).astype(np.int32).clip(-ts[:, 2])
    status = rng.integers(gs.PREACCEPTED, gs.INVALIDATED + 1, t).astype(np.int8)
    active = rng.random(t) < 0.9
    return dict(live=live, key=key_inc, ts=ts, txn_id=lanes, kind=kinds,
                status=status, active=active)


def _mk_batch(rng, b=B, k=K):
    key_inc, lanes, kinds = _mk_txns(rng, b, k)
    key_inc[rng.random(b) < 0.15] = 0                   # empty rows
    return dict(q=key_inc, before=lanes, kind=kinds)


def _ref(fn, *arrays):
    out = fn(*(jnp.asarray(a) for a in arrays))
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) \
        else np.asarray(out)


def _port(fn, *arrays):
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) \
        else out.numpy()


def _consult_args(ix, bt):
    return (ix["live"], ix["key"], ix["ts"], ix["txn_id"], ix["kind"],
            ix["status"], ix["active"], bt["q"], bt["before"], bt["kind"])


def _assert_equal(a, b):
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the witness table
# ---------------------------------------------------------------------------

def test_witness_table_equals_reference():
    _assert_equal(dk.WITNESSES.numpy(), np.asarray(ref_dk.WITNESSES))
    _assert_equal(dk._witness_table(), ref_dk._witness_table())
    # the kernels' bit mask encodes the same table
    w = dk._witness_table()
    for a in range(w.shape[0]):
        for b in range(w.shape[1]):
            assert bool((_kernels._WIT_BITS >> (8 * a + b)) & 1) == w[a, b]


# ---------------------------------------------------------------------------
# the join and the consult on the reference's random index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 8, 9])
def test_overlap_join_and_fused_equal_reference(seed):
    rng = np.random.default_rng(seed)
    ix, bt = _mk_index(rng), _mk_batch(rng)
    args = (ix["key"], ix["txn_id"], ix["kind"], ix["status"], ix["active"],
            bt["q"], bt["before"], bt["kind"])
    want = _ref(ref_ops.overlap_join, *args)
    _assert_equal(_port(dk.overlap_join, *args), want)
    _assert_equal(_port(overlap_join_fused, *args), want)
    _assert_equal(np.asarray(ref_overlap_join_fused(
        *(jnp.asarray(a) for a in args), interpret=True)), want)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_consult_packed_and_max_equal_reference(seed):
    rng = np.random.default_rng(seed)
    ix, bt = _mk_index(rng), _mk_batch(rng)
    args = _consult_args(ix, bt)
    deps, lanes = _ref(ref_dk.consult, *args)
    got_deps, got_lanes = _port(dk.consult, *args)
    _assert_equal(got_deps, deps)
    _assert_equal(got_lanes, lanes)
    packed, lanes_p = _ref(ref_dk.consult_packed, *args)
    got_packed, got_lanes_p = _port(dk.consult_packed, *args)
    _assert_equal(got_packed, packed)
    _assert_equal(got_lanes_p, lanes_p)
    mc_args = (ix["key"], ix["ts"], ix["txn_id"], ix["active"], bt["q"])
    _assert_equal(_port(dk.max_conflict_keys, *mc_args),
                  _ref(ref_dk.max_conflict_keys, *mc_args))


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------

def _edge_index(rng, t, k, case):
    ix = _mk_index(rng, t, k)
    if case == "all_inactive":
        ix["active"][:] = False
    elif case == "all_invalidated":
        ix["status"][:] = gs.INVALIDATED
    elif case == "max_lanes":
        # lanes at the int32 ceiling on both sides of the compare
        hi = rng.random(t) < 0.5
        ix["txn_id"][hi] = MAXL
        ix["ts"][hi] = MAXL
        ix["ts"][~hi, 2] = MAXL
    return ix


@pytest.mark.parametrize("case", ["all_inactive", "all_invalidated",
                                  "max_lanes"])
@pytest.mark.parametrize("t", [61, 1003])
def test_consult_edge_cases_equal_reference(case, t):
    """Inactive and INVALIDATED slots, lanes at 0x7FFFFFFF, and T that is
    not a multiple of 8 (the kernels' byte-load path) or of a tile."""
    rng = np.random.default_rng(t)
    ix = _edge_index(rng, t, K, case)
    bt = _mk_batch(rng, 13)
    if case == "max_lanes":
        bt["before"][::2] = MAXL
        bt["q"][0] = 1                                   # a full-width row
    args = _consult_args(ix, bt)
    deps, lanes = _ref(ref_dk.consult, *args)
    got_deps, got_lanes = _port(dk.consult, *args)
    _assert_equal(got_deps, deps)
    _assert_equal(got_lanes, lanes)
    if case == "all_inactive":
        assert not got_deps.any() and not got_lanes.any()


def test_packed_needs_t_multiple_of_8():
    rng = np.random.default_rng(3)
    ix, bt = _mk_index(rng, 61), _mk_batch(rng)
    with pytest.raises(ValueError):
        _port(dk.consult_packed, *_consult_args(ix, bt))


def test_packed_t_not_multiple_of_tile_equals_reference():
    """T a multiple of 8 but not of the kernels' 2048-slot tile."""
    rng = np.random.default_rng(4)
    ix, bt = _mk_index(rng, 2056, 48), _mk_batch(rng, 9, 48)
    args = _consult_args(ix, bt)
    packed, lanes = _ref(ref_dk.consult_packed, *args)
    got_packed, got_lanes = _port(dk.consult_packed, *args)
    _assert_equal(got_packed, packed)
    _assert_equal(got_lanes, lanes)


# ---------------------------------------------------------------------------
# the ragged (CSR) consult of the service against the reference's kernel
# ---------------------------------------------------------------------------

def _ragged_pair(ix, rows, before, kind, packed):
    """(reference, port) answers of the service consult for ragged rows."""
    batch = build_batch(rows, before, kind)
    live_T = np.ascontiguousarray(ix["live"].T).astype(np.float32)
    key_T = np.ascontiguousarray(ix["key"].T).astype(np.float32)
    ref = ref_consult_t()(
        jnp.asarray(live_T), jnp.asarray(key_T), jnp.asarray(ix["ts"]),
        jnp.asarray(ix["txn_id"]), jnp.asarray(ix["kind"]),
        jnp.asarray(ix["status"]), jnp.asarray(ix["active"]),
        jnp.asarray(batch.flat_cols), jnp.asarray(batch.row_ids),
        jnp.asarray(batch.weights), jnp.asarray(batch.before),
        jnp.asarray(batch.kind), packed=packed)
    t = torch.from_numpy
    port = ragged_consult_t(
        t(np.ascontiguousarray(ix["live"].T != 0).astype(np.uint8)),
        t(np.ascontiguousarray(ix["key"].T != 0).astype(np.uint8)),
        t(ix["ts"]), t(ix["txn_id"]), t(ix["kind"]), t(ix["status"]),
        t(ix["active"]), t(batch.flat_cols), t(batch.offsets),
        t(batch.before), t(batch.kind), packed=packed)
    return [np.asarray(x) for x in ref], [x.numpy() for x in port]


@pytest.mark.parametrize("packed", [False, True])
def test_ragged_consult_equals_reference(packed):
    """Empty rows, duplicate columns, max-width rows, padding rows."""
    rng = np.random.default_rng(21)
    ix = _mk_index(rng, 128, K)
    rows = [(), (3, 3), tuple(range(K)), (1, 5, 1, 9), (0,), (K - 1,) * 3]
    before = [tuple(int(v) for v in rng.integers(0, 400, 5)) for _ in rows]
    kind = [int(rng.choice([0, 1, 3, 4])) for _ in rows]
    ref, port = _ragged_pair(ix, rows, before, kind, packed)
    for a, b in zip(port, ref):
        _assert_equal(a, b)


def test_ragged_consult_300_duplicate_columns():
    """>= 256 duplicates of one column in a row: the reference densifies in
    f32 and never wraps; an int8 or uint8 sum would wrap to 0 at 256."""
    rng = np.random.default_rng(22)
    ix = _mk_index(rng, 64, K)
    ix["active"][:] = True
    ix["status"][:] = gs.PREACCEPTED
    col = int(np.argmax(ix["live"].sum(0)))
    rows = [(col,) * 256, (col,) * 300, (col,) * 300 + (2,)]
    before = [(MAXL,) * 5] * 3
    ref, port = _ragged_pair(ix, rows, before, [1, 1, 4], False)
    for a, b in zip(port, ref):
        _assert_equal(a, b)
    assert port[0][:3].any(axis=1).all()
    batch = build_batch(rows, before, [1, 1, 4])
    q = _kernels.dense_query(torch.from_numpy(batch.offsets),
                             torch.from_numpy(batch.flat_cols), K)
    assert int(q[1, col]) == 300 and int(q[2, col]) == 300


# ---------------------------------------------------------------------------
# the release frontier
# ---------------------------------------------------------------------------

def _random_graph(rng, t):
    e = int(rng.integers(0, 3 * t))
    src = rng.integers(0, t, e).astype(np.int32)
    dst = rng.integers(0, t, e).astype(np.int32)
    loops = rng.integers(0, t, 3).astype(np.int32)       # self-loops
    src = np.concatenate([src, loops, [0, 1]]).astype(np.int32)
    dst = np.concatenate([dst, loops, [1, 0]]).astype(np.int32)   # a cycle
    status = rng.integers(0, 7, t).astype(np.int8)
    status[rng.random(t) < 0.4] = gs.STABLE
    active = rng.random(t) < 0.85
    return src, dst, status, active


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_frontier_equals_reference(seed):
    rng = np.random.default_rng(seed)
    t = int(rng.integers(2, 90))
    src, dst, status, active = _random_graph(rng, t)
    want = ref_fk.frontier_ready_from_edges(src, dst, status, active)
    got = fk.frontier_ready_from_edges(src, dst, status, active, device="cpu")
    _assert_equal(got, want)
    # and the edge kernel itself on the padded arrays
    s, d, v = fk._pad_edges(src, dst, fk._pow2(len(src)))
    _assert_equal(_port(fk.kahn_frontier_edges, s, d, v, status, active),
                  _ref(ref_fk.kahn_frontier_edges, s, d, v, status, active))
    assert fk._pow2(len(src)) == ref_fk._pow2(len(src))
    adj = np.zeros((t, t), dtype=np.int8)
    adj[src, dst] = 1
    for a, b in zip(fk.edges_from_dense(adj), ref_fk.edges_from_dense(adj)):
        _assert_equal(a, b)


def test_frontier_no_edges_equals_reference():
    status = np.full((5,), gs.STABLE, dtype=np.int8)
    active = np.array([1, 1, 0, 1, 1], dtype=bool)
    e = np.zeros((0,), dtype=np.int32)
    _assert_equal(fk.frontier_ready_from_edges(e, e, status, active,
                                               device="cpu"),
                  ref_fk.frontier_ready_from_edges(e, e, status, active))


# ---------------------------------------------------------------------------
# no silent fallback
# ---------------------------------------------------------------------------

def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        fk.frontier_ready_from_edges(np.zeros(0, np.int32),
                                     np.zeros(0, np.int32),
                                     np.zeros(2, np.int8), np.ones(2, bool))
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_raise_off_cpu_and_cuda():
    """A wrapper takes its plain version only for CPU tensors; any other
    device gets the kernel or an error, never a silent CPU path."""
    m = torch.device("meta")
    z = torch.zeros
    args = (z((4, 8), dtype=torch.uint8, device=m),
            z((8, 5), dtype=torch.int32, device=m),
            z((8,), dtype=torch.int8, device=m),
            z((8,), dtype=torch.int8, device=m),
            z((8,), dtype=torch.bool, device=m),
            z((3,), dtype=torch.int32, device=m),
            z((2,), dtype=torch.int32, device=m),
            z((2, 5), dtype=torch.int32, device=m),
            z((2,), dtype=torch.int8, device=m))
    with pytest.raises(ValueError):
        _kernels.deps_join(*args)
    with pytest.raises(ValueError):
        _kernels.max_conflict(args[0], args[1], args[1], args[4], args[5],
                              args[6])
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_out_of_range_codes_and_columns_equal_reference():
    """Kind codes outside the witness table read as the reference's gather
    reads them: a negative code wraps once (+6), then every code clamps
    into the table (9 -> 5, -1 -> 5, -6 -> 0, -7 -> 0, -128 -> 0), in the
    service's consult, the one-shot consult and the fused join; query
    columns at or past K, or below -K, are dropped, and a column in [-K, -1]
    names column + K (as its scatter does)."""
    rng = np.random.default_rng(41)
    ix = _mk_index(rng, 64, K)
    for i, code in enumerate((9, -1, -6, -7, -128)):
        ix["kind"][i::7] = code
    rows = [(1, K + 3), (K,), (2, 3), (-1,), (-K,), (-K - 1,), (-1, K - 1),
            (4, 5, 6), (7, 8), (9, 10), (11, 12, 13)]
    before = [(400, 400, 400, 400, 400)] * len(rows)
    qkind = [9, 1, 4, 1, 1, 1, 4, -1, -6, -7, -128]
    ref, port = _ragged_pair(ix, rows, before, qkind, False)
    for a, b in zip(port, ref):
        _assert_equal(a, b)
    deps, cmax = port
    # the wrapped columns name real keys; the one below -K names none
    assert deps[3].any() and deps[4].any() and cmax[3].any()
    assert not deps[5].any() and not cmax[5].any()
    # the one-shot consult and the fused join on the same kinds
    bt = _mk_batch(rng, len(qkind))
    bt["kind"] = np.asarray(qkind, dtype=np.int8)
    args = _consult_args(ix, bt)
    for got, want in zip(_port(dk.consult, *args), _ref(ref_dk.consult, *args)):
        _assert_equal(got, want)
    jargs = (ix["key"], ix["txn_id"], ix["kind"], ix["status"], ix["active"],
             bt["q"], bt["before"], bt["kind"])
    _assert_equal(_port(overlap_join_fused, *jargs),
                  np.asarray(ref_overlap_join_fused(
                      *(jnp.asarray(a) for a in jargs), interpret=True)))
