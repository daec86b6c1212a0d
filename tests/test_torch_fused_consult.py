"""The service's window as one program: K12 (``_kernels.fused_consult``, both
halves of the consult in one launch) and its one read-back, against the JAX
reference, bit for bit.

The reference computes a window with one jitted function
(``cassandra_accord_tpu/device_service/kernel.py::consult_t``) and reads both
answers back with one ``device_get``; the port's ``ragged_consult_t`` returns
them as views of one buffer and ``to_host`` reads that buffer back once.
Inputs are made with numpy from fixed seeds and handed to both packages; the
reference runs JAX on the CPU, the port the plain versions of its kernels
(its wrappers are asked for the CPU by the tensors they get).  Every output
is a mask or int32 lanes, so every comparison is exact.  The kernel itself
is held on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s
kernels phase).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cassandra_accord_tpu.device_service.kernel import consult_t as ref_consult_t

from cassandra_accord_tpu_torch.device_service.batch import build_batch
from cassandra_accord_tpu_torch.device_service.kernel import (
    ragged_consult_t, to_host)
from cassandra_accord_tpu_torch.ops import _kernels
from cassandra_accord_tpu_torch.ops import graph_state as gs

ODD_KINDS = (-1, -6, -7, -128, 9, 100, 127)


def _index(rng, t, k, odd_kinds=False):
    """A random [T, K] index (1-3 keys a txn, a fifth of them covered in the
    live copy) and its slot data; with ``odd_kinds`` about half the kind
    codes lie outside the witness table."""
    key = np.zeros((t, k), dtype=np.int8)
    for i in range(t):
        key[i, rng.choice(k, rng.integers(1, 4), replace=False)] = 1
    live = key.copy()
    live[rng.random((t, k)) < 0.2] = 0
    lanes = rng.integers(0, 60, (t, gs.TS_LANES)).astype(np.int32)
    ts = lanes + rng.integers(0, 3, (t, gs.TS_LANES)).astype(np.int32)
    kind = rng.choice([0, 1, 3, 4], t).astype(np.int8)
    if odd_kinds:
        odd = rng.random(t) < 0.5
        kind[odd] = rng.choice(ODD_KINDS, int(odd.sum()))
    status = rng.integers(gs.PREACCEPTED, gs.INVALIDATED + 1, t).astype(np.int8)
    active = rng.random(t) < 0.9
    return dict(live=live, key=key, ts=ts, txn_id=lanes, kind=kind,
                status=status, active=active)


def _rows(rng, b, k, width=2, odd_kinds=False, wild_cols=False):
    """``b`` ragged rows of 0..``width`` keys with their bounds and kinds;
    with ``wild_cols`` the rows also carry columns -1 and -K (wrapped once
    to K - 1 and 0) and K and -K-1 (dropped)."""
    rows = [[int(c) for c in rng.integers(0, k, rng.integers(0, width + 1))]
            for _ in range(b)]
    if wild_cols:
        rows = [r + [[-1, -k, k, -k - 1][i % 4]] for i, r in enumerate(rows)]
        rows[0] = [k, -k - 1]
    before = [tuple(int(v) for v in rng.integers(0, 60, 5)) for _ in rows]
    kind = [int(rng.choice([0, 1, 3, 4])) for _ in rows]
    if odd_kinds:
        kind = [int(rng.choice(ODD_KINDS)) if i % 2 else c
                for i, c in enumerate(kind)]
    return rows, before, kind


def _both(ix, batch, packed):
    """(reference, port) answers of one window: the reference's
    ``consult_t()`` (f32 [K, T] index, the batch densified by scatter) and
    the port's ``ragged_consult_t`` read back with ``to_host``."""
    ref = ref_consult_t()(
        jnp.asarray(np.ascontiguousarray(ix["live"].T).astype(np.float32)),
        jnp.asarray(np.ascontiguousarray(ix["key"].T).astype(np.float32)),
        jnp.asarray(ix["ts"]), jnp.asarray(ix["txn_id"]),
        jnp.asarray(ix["kind"]), jnp.asarray(ix["status"]),
        jnp.asarray(ix["active"]), jnp.asarray(batch.flat_cols),
        jnp.asarray(batch.row_ids), jnp.asarray(batch.weights),
        jnp.asarray(batch.before), jnp.asarray(batch.kind), packed=packed)
    t = torch.from_numpy
    port = to_host(*ragged_consult_t(
        t(np.ascontiguousarray(ix["live"].T != 0).astype(np.uint8)),
        t(np.ascontiguousarray(ix["key"].T != 0).astype(np.uint8)),
        t(ix["ts"]), t(ix["txn_id"]), t(ix["kind"]), t(ix["status"]),
        t(ix["active"]), t(batch.flat_cols), t(batch.offsets),
        t(batch.before), t(batch.kind), packed=packed))
    return [np.asarray(x) for x in ref], list(port)


def _assert_equal(a, b):
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


# (T, K, B, keyword arguments of _rows and _index): the burn's window, odd
# T, two of K12's 2,048-slot tiles (the second of one slot), T % 8 == 0
# for the packed form, kind codes outside the table, columns in [-K, -1]
# and outside [-K, K), wide rows
CASES = {
    "burn_window": (256, 16, 8, {}),
    "cli_window": (128, 16, 8, {"width": 1}),
    "odd_T": (1003, 64, 13, {}),
    "two_tiles": (2049, 64, 13, {}),
    "two_tiles_multiple_of_8": (2056, 64, 13, {}),
    "K_tail": (512, 80, 33, {"width": 2}),
    "negative_kinds": (256, 16, 8, {"odd_kinds": True}),
    "wild_columns": (264, 32, 9, {"wild_cols": True}),
    "wide_rows": (320, 128, 5, {"width": 30}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_consult_equals_reference_consult_t(case):
    """The window through K12's plain version (the CSR form, which the
    rule picks for these rows), bool and, where T % 8 == 0, bit-packed,
    equal to the reference's program; padding rows (the batch's bucket
    past its real rows) answer nothing."""
    t, k, b, kw = CASES[case]
    rng = np.random.default_rng(t + k + b)
    ix = _index(rng, t, k, odd_kinds=kw.get("odd_kinds", False))
    rows, before, kind = _rows(rng, b, k, **kw)
    batch = build_batch(rows, before, kind)
    assert _kernels.join_form(batch.before.shape[0], t, k,
                              batch.flat_cols.size) == "csr"
    for packed in ((False, True) if t % 8 == 0 else (False,)):
        ref, port = _both(ix, batch, packed)
        for a, w in zip(port, ref):
            _assert_equal(a, w)
        deps, lanes = port
        assert not deps[batch.rows:].any() and not lanes[batch.rows:].any()
    if case == "negative_kinds":
        assert deps[:batch.rows].any()
    if case == "wild_columns":
        assert not deps[0].any() and not lanes[0].any()


@pytest.mark.parametrize("form", ["csr", "dense"])
def test_ragged_consult_forced_forms_equal_reference(form, monkeypatch):
    """Both branches of the window (K12; K1d and K2d into one buffer), each
    taken where a rule that answers ``form`` sends it, give the reference's
    answers."""
    monkeypatch.setattr(_kernels, "join_form", lambda *sizes: form)
    rng = np.random.default_rng(41)
    ix = _index(rng, 512, 64)
    rows, before, kind = _rows(rng, 12, 64, width=40)
    batch = build_batch(rows, before, kind)
    for packed in (False, True):
        ref, port = _both(ix, batch, packed)
        for a, w in zip(port, ref):
            _assert_equal(a, w)


def test_empty_batch_equals_reference():
    """B = 0: empty answers of the reference's shapes."""
    rng = np.random.default_rng(43)
    ix = _index(rng, 256, 16)
    z32 = np.zeros((0,), dtype=np.int32)
    batch = type("Empty", (), dict(
        flat_cols=z32, row_ids=z32, weights=np.zeros((0,), dtype=np.int8),
        offsets=np.zeros((1,), dtype=np.int32),
        before=np.zeros((0, gs.TS_LANES), dtype=np.int32),
        kind=np.zeros((0,), dtype=np.int8)))
    for packed in (False, True):
        ref, port = _both(ix, batch, packed)
        for a, w in zip(port, ref):
            _assert_equal(a, w)
        assert port[0].shape == ((0, 32) if packed else (0, 256))


def _kernel_args(rng, t, k, b, width=3):
    ix = _index(rng, t, k, odd_kinds=True)
    rows, before, kind = _rows(rng, b, k, width=width, wild_cols=True)
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    cols = np.asarray([c for r in rows for c in r] + [3, 1], dtype=np.int32)
    t_ = torch.from_numpy
    return (t_(np.ascontiguousarray(ix["live"].T != 0).astype(np.uint8)),
            t_(np.ascontiguousarray(ix["key"].T != 0).astype(np.uint8)),
            t_(ix["ts"]), t_(ix["txn_id"]), t_(ix["kind"]), t_(ix["status"]),
            t_(ix["active"]), t_(offsets.astype(np.int32)), t_(cols),
            t_(np.asarray(before, dtype=np.int32)),
            t_(np.asarray(kind, dtype=np.int8)))


def _halves(args, packed):
    live_T, key_T, ts, txn_id, kind, status, active, offsets, cols, before, \
        qkind = args
    return (_kernels.deps_join_plain(live_T, txn_id, kind, status, active,
                                     offsets, cols, before, qkind, packed),
            _kernels.max_conflict_plain(key_T, ts, txn_id, active, offsets,
                                        cols))


@pytest.mark.parametrize("t,k,b", [(256, 16, 8), (1003, 64, 13),
                                   (2056, 64, 13), (64, 8, 1)])
def test_fused_consult_plain_equals_k1_and_k2_plain(t, k, b):
    """K12's plain version is K1's and K2's over one densified query; flat
    columns past offsets[B] are never read."""
    args = _kernel_args(np.random.default_rng(t), t, k, b)
    for packed in ((False, True) if t % 8 == 0 else (False,)):
        got = _kernels.fused_consult_plain(*args, packed=packed)
        want = _halves(args, packed)
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and torch.equal(a, w)
        wrapped = _kernels.fused_consult(*args, packed=packed)
        for a, w in zip(wrapped, want):
            assert a.dtype == w.dtype and torch.equal(a, w)


@pytest.mark.parametrize("t,packed", [(256, False), (256, True),
                                      (1003, False)])
@pytest.mark.parametrize("form", ["csr", "dense"])
def test_answers_are_views_of_one_buffer(packed, form, t, monkeypatch):
    """The lanes lie at offset 0 of one buffer and the deps from the next
    16-byte boundary, on both branches of the window."""
    monkeypatch.setattr(_kernels, "join_form", lambda *sizes: form)
    args = _kernel_args(np.random.default_rng(5), t, 16, 5)
    live_T, key_T, ts, txn_id, kind, status, active, offsets, cols, before, \
        qkind = args
    deps, lanes = ragged_consult_t(live_T, key_T, ts, txn_id, kind, status,
                                   active, cols, offsets, before, qkind,
                                   packed=packed)
    assert deps.untyped_storage().data_ptr() == \
        lanes.untyped_storage().data_ptr()
    assert lanes.storage_offset() == 0 and lanes.dtype == torch.int32
    start = deps.storage_offset() * deps.element_size()
    assert start % 16 == 0 and start >= lanes.numel() * 4
    assert deps.dtype == (torch.uint8 if packed else torch.bool)
    assert 0 <= deps.untyped_storage().nbytes() - start - deps.numel() < 4


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("b", [0, 1, 3, 8])
def test_to_host_equals_two_reads(packed, b):
    """One read of the buffer gives what reading each answer gives."""
    args = _kernel_args(np.random.default_rng(b), 256, 16, max(b, 1))
    if b == 0:
        args = (*args[:7], args[7][:1].clone(), args[8], args[9][:0],
                args[10][:0])
    deps, lanes = _kernels.fused_consult(*args, packed=packed)
    got_deps, got_lanes = to_host(deps, lanes)
    for a, w in ((got_deps, deps.cpu().numpy()),
                 (got_lanes, lanes.cpu().numpy())):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert np.array_equal(a, w)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rows", [0, 1, 5, 8])
def test_to_host_of_first_rows_equals_those_rows(packed, rows):
    """The first rows of both views (a window's real rows) come back as
    those rows of each answer, and no more."""
    args = _kernel_args(np.random.default_rng(20 + rows), 256, 16, 8)
    deps, lanes = _kernels.fused_consult(*args, packed=packed)
    got_deps, got_lanes = to_host(deps[:rows], lanes[:rows])
    for a, w in ((got_deps, deps[:rows].cpu().numpy()),
                 (got_lanes, lanes[:rows].cpu().numpy())):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert np.array_equal(a, w)


def test_to_host_takes_only_one_buffer():
    args = _kernel_args(np.random.default_rng(9), 64, 8, 3)
    deps, lanes = _halves(args, False)
    with pytest.raises(ValueError):
        to_host(deps, lanes)


def test_fused_consult_refuses_a_device_neither_cuda_nor_cpu():
    """The wrapper runs its plain version for CPU tensors only; tensors on
    any other device that is not CUDA are refused, not answered."""
    args = tuple(x.to("meta") for x in
                 _kernel_args(np.random.default_rng(3), 64, 8, 3))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        _kernels.fused_consult(*args)
    assert _kernels.LAUNCHES["fused_consult"] == 0
