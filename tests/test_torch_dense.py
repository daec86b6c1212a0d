"""The dense form of the consult kernels (K1d, K2d) on the CPU: the rule that
picks CSR or dense, and the one-shot and service consults down each of
their routes held against the JAX reference bit for bit.

On the CPU every wrapper runs its plain version, so these tests hold the
routing and the answers at the shapes the dense kernels take;
the kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Inputs are made with
numpy from fixed seeds and handed to both packages; the reference's Pallas
join runs in interpret mode, as ``tests/test_ops_kernels.py`` runs it.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cassandra_accord_tpu.device_service.kernel import consult_t as ref_consult_t
from cassandra_accord_tpu.ops import deps_kernels as ref_dk
from cassandra_accord_tpu.ops.pallas_join import \
    overlap_join_fused as ref_overlap_join_fused

from cassandra_accord_tpu_torch.device_service.batch import build_batch
from cassandra_accord_tpu_torch.device_service.kernel import ragged_consult_t
from cassandra_accord_tpu_torch.ops import _kernels
from cassandra_accord_tpu_torch.ops import deps_kernels as dk
from cassandra_accord_tpu_torch.ops import graph_state as gs
from cassandra_accord_tpu_torch.ops.pallas_join import overlap_join_fused

K, B = 64, 13

# ---------------------------------------------------------------------------
# (a) the rule, at every shape of PERF.md's kernel table and its sweep
# ---------------------------------------------------------------------------

# (B, T, K, n_cols = cols.numel() as the path passes it, measured form).
# The service pads flat_cols to a power-of-two bucket (floor 16), so its
# n_cols is at most twice the keys its rows name.
TABLE = {
    "burn_largest": (8, 256, 16, 16, "csr"),
    "burn_window": (8, 256, 16, 16, "csr"),
    "cli_largest": (8, 128, 16, 16, "csr"),
    "maelstrom_largest": (8, 128, 16, 16, "csr"),
    "verify_largest": (8, 256, 16, 16, "csr"),
    "bench_phase_largest": (256, 4096, 512, 512, "csr"),
    "graph_step": (256, 65536, 512, 512, "csr"),
    "shape_A": (256, 65536, 512, 512, "csr"),
    "mesh_rank_step": (256, 16384, 512, 512, "csr"),
    "mesh_store_consult": (256, 65536, 512, 512, "csr"),
    "odd_T": (13, 1003, 64, 26, "csr"),
    "two_tiles": (13, 2049, 64, 26, "csr"),
    "pr3_replay_largest": (256, 65536, 1024, 2048, "csr"),
    "six_key_replay_largest": (256, 65536, 1024, 512, "csr"),
    "wide_replay_largest": (256, 4096, 8192, 256, "csr"),
    "wide_replay_largest_runs_5_6": (256, 4096, 8192, 512, "csr"),
    "config4": (64, 65536, 2048, 64 * 1024, "dense"),
    "wide_row": (9, 65536, 512, 5000 + 8 * 2, "dense"),
    # the sweep: config 4's index with 8 to 128 keys a row, and its
    # 1,024-key rows over the first T slots (dense-faster at every T)
    "sweep_config4_8keys": (64, 65536, 2048, 512, "csr"),
    "sweep_config4_32keys": (64, 65536, 2048, 2048, "csr"),
    "sweep_config4_128keys": (64, 65536, 2048, 8192, "dense"),
    "sweep_config4_rows_T256": (64, 256, 2048, 65536, "dense"),
    "sweep_config4_rows_T4096": (64, 4096, 2048, 65536, "dense"),
    # rows naming every key of a 16-key index (the protocol paths'): CSR;
    # of a 64- and a 256-key index: dense
    "sweep_full_rows_K16_T4096": (8, 4096, 16, 128, "csr"),
    "sweep_full_rows_K64_T256": (8, 256, 64, 512, "dense"),
    "sweep_full_rows_K256_T128": (8, 128, 256, 2048, "dense"),
    # shape A's index with 256 rows (one pass of the dense kernel) of 2 to
    # 128 keys each: CSR-faster to 8 keys a row, dense from 32
    "sweep_rows256_2keys": (256, 65536, 512, 512, "csr"),
    "sweep_rows256_8keys": (256, 65536, 512, 2048, "csr"),
    "sweep_rows256_32keys": (256, 65536, 512, 8192, "dense"),
    "sweep_rows256_128keys": (256, 65536, 512, 32768, "dense"),
    # the dense kernel takes T % 16 == 0 only
    "config4_T_not_multiple_of_16": (64, 65544, 2048, 65536, "csr"),
}


@pytest.mark.parametrize("shape", sorted(TABLE))
def test_join_form_at_the_kernel_table_shapes(shape):
    b, t, k, n_cols, want = TABLE[shape]
    assert _kernels.join_form(b, t, k, n_cols) == want
    # the same form whether the service's bucket padded the columns or not
    padded = max(16, 1 << (n_cols - 1).bit_length())
    assert _kernels.join_form(b, t, k, padded) == want


# ---------------------------------------------------------------------------
# (b) the consults down either route against the reference
# ---------------------------------------------------------------------------

def _index(rng, t, k=K):
    key = (rng.random((t, k)) < 0.3).astype(np.int8)
    live = key.copy()
    live[rng.random((t, k)) < 0.2] = 0                  # covered incidences
    txn_id = np.zeros((t, gs.TS_LANES), dtype=np.int32)
    txn_id[:, 0] = 1
    txn_id[:, 2] = rng.integers(1, 500, t)
    txn_id[:, 4] = rng.integers(1, 8, t)
    ts = txn_id.copy()
    ts[:, 2] += rng.integers(-3, 40, t).astype(np.int32).clip(-ts[:, 2])
    kind = rng.choice([0, 1, 3, 4], t).astype(np.int8)
    status = rng.integers(gs.PREACCEPTED, gs.INVALIDATED + 1, t).astype(np.int8)
    active = rng.random(t) < 0.9
    return dict(live=live, key=key, ts=ts, txn_id=txn_id, kind=kind,
                status=status, active=active)


def _wide_rows(rng, b=B, k=K):
    """Rows of 32-64 distinct keys each, as [B, K] int8 and as lists."""
    rows = [sorted(int(c) for c in rng.choice(k, int(rng.integers(32, k + 1)),
                                              replace=False))
            for _ in range(b)]
    q = np.zeros((b, k), dtype=np.int8)
    for i, r in enumerate(rows):
        q[i, r] = 1
    before = np.zeros((b, gs.TS_LANES), dtype=np.int32)
    before[:, 0] = 1
    before[:, 2] = rng.integers(1, 520, b)
    before[:, 4] = rng.integers(1, 8, b)
    kind = rng.choice([0, 1, 3, 4], b).astype(np.int8)
    return q, rows, before, kind


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
def _one_shot_case(t):
    """Inputs and the reference's answers at T = t, once per t."""
    rng = np.random.default_rng(t)
    ix = _index(rng, t)
    q, _rows, before, kind = _wide_rows(rng)
    consult = (ix["live"], ix["key"], ix["ts"], ix["txn_id"], ix["kind"],
               ix["status"], ix["active"], q, before, kind)
    join = (ix["live"], ix["txn_id"], ix["kind"], ix["status"], ix["active"],
            q, before, kind)
    mc = (ix["key"], ix["ts"], ix["txn_id"], ix["active"], q)
    want = {"consult": _ref(ref_dk.consult, *consult),
            "overlap_join": _ref(ref_dk.overlap_join, *join),
            "overlap_join_fused": _ref(ref_overlap_join_fused, *join,
                                       interpret=True),
            "max_conflict_keys": _ref(ref_dk.max_conflict_keys, *mc)}
    if t % 8 == 0:
        want["consult_packed"] = _ref(ref_dk.consult_packed, *consult)
    return dict(consult=consult, join=join, mc=mc), want


@pytest.mark.parametrize("route", ["csr", "dense"])
@pytest.mark.parametrize("t", [61, 1003, 2049, 2056])
def test_one_shot_consults_equal_reference(t, route, monkeypatch):
    """consult, consult_packed (T % 8 == 0), overlap_join,
    max_conflict_keys and overlap_join_fused down ``route`` (the dense
    [T, K] kernels, which the rule picks at K = 64, or the CSR route with values,
    where a rule that refuses every shape sends them), on rows of 32-64 of
    64 keys, equal the reference's answers bit for bit (the reference's
    Pallas join in interpret mode); equal to each other too, as the Pallas
    join equals the XLA join."""
    args, want = _one_shot_case(t)
    built = []
    query_csr = dk.query_csr
    monkeypatch.setattr(dk, "query_csr",
                        lambda q: built.append(q.shape) or query_csr(q))
    if route == "csr":
        monkeypatch.setattr(_kernels, "tk_refusal",
                            lambda k, *tensors: "the CSR route")
    got = {"consult": _port(dk.consult, *args["consult"]),
           "overlap_join": _port(dk.overlap_join, *args["join"]),
           "overlap_join_fused": _port(overlap_join_fused, *args["join"]),
           "max_conflict_keys": _port(dk.max_conflict_keys, *args["mc"])}
    if t % 8 == 0:
        got["consult_packed"] = _port(dk.consult_packed, *args["consult"])
    assert set(got) == set(want)
    assert len(built) == (len(got) if route == "csr" else 0)
    for name, w in want.items():
        for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got[name], w))):
            _assert_equal(a, b)
    _assert_equal(want["overlap_join_fused"], want["overlap_join"])
    assert want["overlap_join"].any()


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


@pytest.mark.parametrize("route", ["csr", "dense"])
@pytest.mark.parametrize("t", [61, 1003, 2049, 2056])
def test_ragged_consult_wide_rows_equal_reference(t, route, monkeypatch):
    """The service consult down ``route`` (K12, ``fused_consult``, or
    ``deps_join_dense`` and ``max_conflict_dense``, where a rule that
    answers ``route`` sends it): rows of 32-64 keys, one row of 300
    duplicates of one column (a u8 operand summed would wrap at 256), and
    rows with columns -1 and -K (wrapped once) and K and -K-1 (dropped),
    equal the reference's kernel bit for bit; packed too where T % 8 ==
    0."""
    monkeypatch.setattr(_kernels, "join_form", lambda *sizes: route)
    fused = []
    fused_consult = _kernels.fused_consult
    monkeypatch.setattr(_kernels, "fused_consult",
                        lambda *a, **kw: fused.append(1)
                        or fused_consult(*a, **kw))
    rng = np.random.default_rng(t + 1)
    ix = _index(rng, t)
    _q, rows, before, kind = _wide_rows(rng)
    col = int(np.argmax(ix["live"].sum(0)))
    rows[1] = [col] * 300
    rows[2] = rows[2] + [-1, -K, K, -K - 1]
    rows[3] = [K, -K - 1]
    before[1, 2] = 600                                   # after every txn
    before_rows = [tuple(int(v) for v in r) for r in before]
    for packed in ((False, True) if t % 8 == 0 else (False,)):
        ref, port = _ragged_pair(ix, rows, before_rows, [int(x) for x in kind],
                                 packed)
        for a, b in zip(port, ref):
            _assert_equal(a, b)
    assert bool(fused) == (route == "csr")
    deps, cmax = port
    assert cmax[1].any() and not cmax[3].any()
    assert not deps[3].any()


# ---------------------------------------------------------------------------
# (c) the [K, T] kernel's stage addresses (csrc/common.cuh), in Python
# ---------------------------------------------------------------------------

def _cuh_function(name):
    """The one-line return expression of a constexpr helper in
    csrc/common.cuh, as a Python function of its integer arguments (the
    expression uses only integer operators that Python shares)."""
    import re
    src = (_kernels.CSRC / "common.cuh").read_text()
    m = re.search(rf"constexpr int {name}\(int (\w+)(?:, int (\w+))?\) \{{\s*"
                  rf"return (.*?);\s*\}}", src, re.S)
    assert m, name
    args = [a for a in m.groups()[:2] if a]
    return eval(f"lambda {', '.join(args)}: {' '.join(m.group(3).split())}")


def test_kt_stage_addresses_follow_the_tma_swizzle_and_meet_32_banks():
    """kt_key_row is a permutation of the 128 keys of a stage and kt_key_pos
    its inverse; kt_stage_offset is where TMA's 128-byte swizzle puts (key
    row r, slot s) of a [128][128] box (bits 4-6 of the offset XOR bits
    7-9); and each of a thread's fragment loads (k32 step ks, half h,
    byte j; lane = 4g + c reads the word of slots 32w + 4g of key row
    kt_key_row(32 ks + 16 h + 4 c + j)) puts the 32 lanes of a warp on 32
    distinct banks, for every warp w of the warpgroup."""
    row, pos = _cuh_function("kt_key_row"), _cuh_function("kt_key_pos")
    offset = _cuh_function("kt_stage_offset")
    assert sorted(row(p) for p in range(128)) == list(range(128))
    assert all(pos(row(p)) == p and row(pos(p)) == p for p in range(1024))
    for r in range(128):
        for s in range(128):
            linear = r * 128 + s
            assert offset(r, s) == linear ^ (((linear >> 7) & 7) << 4)
    for w in range(4):
        for ks in range(4):
            for h in range(2):
                for j in range(4):
                    banks = {offset(row(32 * ks + 16 * h + 4 * c + j),
                                    32 * w + 4 * g) // 4 % 32
                             for g in range(8) for c in range(4)}
                    assert len(banks) == 32, (w, ks, h, j)
    # read in key order instead, the same loads meet only 16 banks
    banks = {offset(4 * c, 4 * g) // 4 % 32 for g in range(8) for c in range(4)}
    assert len(banks) == 16
