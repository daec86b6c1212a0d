"""Two inputs on which the port once differed from the JAX reference, held
bit for bit on the CPU through every consult entry point:

- kind codes outside the witness table: the reference gathers
  ``WITNESSES[kind.astype(int32)]``, and a JAX gather wraps a negative index
  once and then clamps it into the table (six kinds: -1 -> 5, -6 -> 0,
  -7 -> 0, -128 -> 0, 100 -> 5);
- signed incidence bytes: the reference multiplies the [B, K] query by the
  [T, K] index as bf16 and tests the f32 sum > 0, so a -1 cancels a +1.
  Its f32 sum is exact while every partial sum stays below 2^24 in
  magnitude; the inputs here stay far inside that (K <= 72 keys of values
  in [-128, 127]: |sum| <= 72 * 2^14 < 2^21), where the port's exact int
  sums must equal it.

K = 32 runs the [T, K] route's plain version, K = 72 (not a multiple of
16) the CSR route's, with the query's values beside its columns.  The
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cassandra_accord_tpu.models import conflict_graph as ref_cg
from cassandra_accord_tpu.ops import deps_kernels as ref_dk
from cassandra_accord_tpu.ops import graph_state as ref_gs
from cassandra_accord_tpu.ops.pallas_join import \
    overlap_join_fused as ref_overlap_join_fused

from cassandra_accord_tpu_torch.device_service.index import (
    DoubleBufferedIndex, front_from_host)
from cassandra_accord_tpu_torch.models import conflict_graph as cg
from cassandra_accord_tpu_torch.ops import _kernels
from cassandra_accord_tpu_torch.ops import deps_kernels as dk
from cassandra_accord_tpu_torch.ops import graph_state as gs
from cassandra_accord_tpu_torch.ops.pallas_join import overlap_join_fused

ODD_KINDS = (-1, -6, -7, -128, 9, 100, 127)
KS = (32, 72)


def _assert_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


def _slots(t, rng):
    txn_id = np.zeros((t, gs.TS_LANES), dtype=np.int32)
    txn_id[:, 0] = 1
    txn_id[:, 2] = rng.permutation(t) + 1
    txn_id[:, 4] = rng.integers(1, 8, t)
    ts = txn_id.copy()
    ts[:, 2] += rng.integers(0, 40, t).astype(np.int32)
    return dict(ts=ts, txn_id=txn_id,
                kind=rng.choice([0, 1, 3, 4], t).astype(np.int8),
                status=np.full(t, gs.PREACCEPTED, dtype=np.int8),
                active=np.ones(t, dtype=bool))


def _probe_kinds(k):
    """ROADMAP's first probe: every slot on key 0, the index's and the
    query's kinds in and out of the table."""
    ix = _slots(16, np.random.default_rng(1))
    inc = np.zeros((16, k), dtype=np.int8)
    inc[:, 0] = 1
    ix.update(live=inc, key=inc.copy(), kind=np.array(
        [-1, -2, -7, 0, 1, 2, 3, 4, -128, 5, 6, 7, 100, -3, 1, 2], np.int8))
    q = np.zeros((4, k), dtype=np.int8)
    q[:, 0] = 1
    bt = dict(q=q, before=np.full((4, gs.TS_LANES), 1000, np.int32),
              kind=np.array([-1, 1, -5, 3], np.int8))
    return ix, bt


def _random_kinds(k, seed):
    """A random 0/1 index and query whose kinds are drawn half from the
    table and half from ``ODD_KINDS``."""
    rng = np.random.default_rng(seed)
    t, b = 64, 24
    ix = _slots(t, rng)
    key = (rng.random((t, k)) < 0.2).astype(np.int8)
    live = key.copy()
    live[rng.random((t, k)) < 0.2] = 0
    odd = rng.random(t) < 0.5
    ix["kind"][odd] = rng.choice(ODD_KINDS, int(odd.sum()))
    ix.update(live=live, key=key)
    q = (rng.random((b, k)) < 0.2).astype(np.int8)
    before = np.zeros((b, gs.TS_LANES), dtype=np.int32)
    before[:, 0] = 1
    before[:, 2] = rng.integers(1, t + 2, b)
    kind = np.where(rng.random(b) < 0.5, rng.choice(ODD_KINDS, b),
                    rng.choice([0, 1, 3, 4], b)).astype(np.int8)
    return ix, dict(q=q, before=before, kind=kind)


def _probe_signed(k):
    """ROADMAP's second probe: slots 0-7 hold 1 at keys 0 and 1 and 2 at
    key 2; row 0 holds -1 at key 0, row 1 +1 at key 0 and -1 at key 1
    (sums -1 and 0: no dependency), row 2 +1 at key 0 (a dependency)."""
    ix = _slots(8, np.random.default_rng(2))
    inc = np.zeros((8, k), dtype=np.int8)
    inc[:, :2] = 1
    inc[:, 2] = 2
    ix.update(live=inc, key=inc.copy(), kind=np.ones(8, np.int8))
    q = np.zeros((3, k), dtype=np.int8)
    q[0, 0] = -1
    q[1, 0], q[1, 1] = 1, -1
    q[2, 0] = 1
    bt = dict(q=q, before=np.full((3, gs.TS_LANES), 1000, np.int32),
              kind=np.ones(3, np.int8))
    return ix, bt


def _random_signed(k, seed):
    """Index and query bytes mostly 0, else -2..2, with -128 and 127 mixed
    in: sums of every sign, zero sums included."""
    rng = np.random.default_rng(seed)
    t, b = 64, 24

    def signed(shape, p):
        x = rng.integers(-2, 3, shape) * (rng.random(shape) < p)
        ext = rng.random(shape) < 0.01
        x[ext] = rng.choice([-128, 127], int(ext.sum()))
        return x.astype(np.int8)
    ix = _slots(t, rng)
    key = signed((t, k), 0.3)
    live = key.copy()
    live[rng.random((t, k)) < 0.2] = 0
    ix.update(live=live, key=key)
    before = np.zeros((b, gs.TS_LANES), dtype=np.int32)
    before[:, 0] = 1
    before[:, 2] = rng.integers(1, t + 2, b)
    return ix, dict(q=signed((b, k), 0.15), before=before,
                    kind=rng.choice([0, 1, 3, 4], b).astype(np.int8))


ENTRIES = ("overlap_join", "overlap_join_fused", "max_conflict_keys",
           "consult", "consult_packed")


def _both(entry, ix, bt):
    """(port, reference) answers of one entry point on the same arrays."""
    join = (ix["key"], ix["txn_id"], ix["kind"], ix["status"], ix["active"],
            bt["q"], bt["before"], bt["kind"])
    full = (ix["live"], ix["key"], ix["ts"], ix["txn_id"], ix["kind"],
            ix["status"], ix["active"], bt["q"], bt["before"], bt["kind"])
    args, port, ref = {
        "overlap_join": (join, dk.overlap_join, ref_dk.overlap_join),
        "overlap_join_fused": (join, overlap_join_fused,
                               lambda *a: ref_overlap_join_fused(
                                   *a, interpret=True)),
        "max_conflict_keys": ((ix["key"], ix["ts"], ix["txn_id"],
                               ix["active"], bt["q"]), dk.max_conflict_keys,
                              ref_dk.max_conflict_keys),
        "consult": (full, dk.consult, ref_dk.consult),
        "consult_packed": (full, dk.consult_packed, ref_dk.consult_packed),
    }[entry]
    got = port(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    want = ref(*(jnp.asarray(a) for a in args))
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _check(entry, ix, bt):
    got, want = _both(entry, ix, bt)
    for g, w in zip(got, want):
        _assert_equal(g, w)
    return got


# ---------------------------------------------------------------------------
# kind codes
# ---------------------------------------------------------------------------

def test_kind_index_wraps_once_then_clamps():
    """The worked examples, and every int8 code, against the reference's
    own gather of its witness table."""
    n = _kernels.witness_table().shape[0]
    assert n == 6
    got = _kernels._kind_index(torch.tensor([-1, -6, -7, -128, 100],
                                            dtype=torch.int8))
    assert got.tolist() == [5, 0, 0, 0, 5]
    codes = np.arange(-128, 128, dtype=np.int8)
    want = np.asarray(ref_dk.WITNESSES[jnp.asarray(codes).astype(jnp.int32)])
    _assert_equal(dk.WITNESSES[_kernels._kind_index(torch.from_numpy(codes))]
                  .numpy(), want)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("entry", [e for e in ENTRIES
                                   if e != "max_conflict_keys"])
def test_negative_kind_codes_equal_reference(entry, k):
    got = _check(entry, *_probe_kinds(k))
    if entry != "consult_packed":
        assert got[0].any()             # the probe finds dependencies
    _check(entry, *_random_kinds(k, seed=k))


def _state(rng, t, k):
    """A live state whose kinds are drawn half from ``ODD_KINDS``."""
    lanes = np.zeros((t, gs.TS_LANES), dtype=np.int32)
    lanes[:, 0] = 1
    lanes[:, 2] = rng.permutation(t) + 10
    lanes[:, 4] = rng.integers(1, 5, t)
    active = rng.random(t) < 0.5
    kind = np.where(rng.random(t) < 0.5, rng.choice(ODD_KINDS, t),
                    rng.choice([0, 1, 3, 4], t)).astype(np.int8)
    return dict(key_inc=((rng.random((t, k)) < 0.3) & active[:, None])
                .astype(np.int8),
                ts=lanes * active[:, None], txn_id=lanes * active[:, None],
                kind=kind * active,
                status=(rng.choice([1, 2, 3, 4], t) * active).astype(np.int8),
                adj=np.zeros((t, t), dtype=np.int8), active=active)


@pytest.mark.parametrize("k", KS)
def test_negative_kind_codes_in_txn_step_equal_reference(k):
    """Three model steps whose states and batches carry kinds outside the
    table: every state, deps mask and applied mask equal."""
    rng = np.random.default_rng(k)
    t, b = 64, 6
    fields = _state(rng, t, k)
    port = gs.state_from_numpy(fields, device="cpu")
    ref = ref_gs.GraphState(**{f: jnp.asarray(v) for f, v in fields.items()})
    free = np.flatnonzero(~fields["active"])
    assert free.size >= 3 * b
    for step in range(3):
        key_inc = (rng.random((b, k)) < 0.3).astype(np.int8)
        lanes = np.zeros((b, gs.TS_LANES), dtype=np.int32)
        lanes[:, 0] = 1
        lanes[:, 2] = 1000 + 10 * step + np.arange(b)
        lanes[:, 4] = 1
        bt = dict(slots=free[step * b:(step + 1) * b].astype(np.int32),
                  key_inc=key_inc, txn_id=lanes,
                  kind=np.asarray(rng.choice(ODD_KINDS + (0, 1), b), np.int8),
                  valid=np.ones(b, dtype=bool))
        port, deps, applied = cg.txn_step(port, cg.TxnBatch(
            **{f: torch.from_numpy(v) for f, v in bt.items()}))
        ref, r_deps, r_applied = ref_cg.txn_step(ref, ref_cg.TxnBatch(
            **{f: jnp.asarray(v) for f, v in bt.items()}))
        _assert_equal(deps.numpy(), r_deps)
        _assert_equal(applied.numpy(), r_applied)
        got = gs.state_to_numpy(port)
        for f in ref_gs.GraphState._fields:
            _assert_equal(got[f], np.asarray(getattr(ref, f)))


# ---------------------------------------------------------------------------
# signed incidence bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_signed_bytes_equal_reference(entry, k):
    got = _check(entry, *_probe_signed(k))
    if entry in ("overlap_join", "overlap_join_fused", "consult"):
        # rows 0 and 1 sum to -1 and 0 at every slot, row 2 to +1
        assert not got[0][:2].any() and got[0][2].all()
    _check(entry, *_random_signed(k, seed=k + 1))


@pytest.mark.parametrize("k", KS)
def test_signed_csr_route_equals_tk_route(k):
    """The [K, T] wrappers' plain versions with the query's values beside
    its columns (the CSR route) equal the [T, K] ones on the same bytes."""
    ix, bt = _random_signed(k, seed=3 * k)
    t = torch.from_numpy
    inc, q = t(ix["key"]), t(bt["q"])
    offsets, cols, vals = dk.query_csr(q)
    inc_T = dk.incidence_T(inc)
    assert inc_T.dtype == torch.uint8
    assert torch.equal(inc_T.view(torch.int8), inc.t())
    jargs = (t(ix["txn_id"]), t(ix["kind"]), t(ix["status"]),
             t(ix["active"]))
    assert torch.equal(
        _kernels.deps_join(inc_T, *jargs, offsets, cols, t(bt["before"]),
                           t(bt["kind"]), vals=vals),
        _kernels.deps_join_tk(inc, *jargs, q, t(bt["before"]), t(bt["kind"])))
    margs = (t(ix["ts"]), t(ix["txn_id"]), t(ix["active"]))
    assert torch.equal(
        _kernels.max_conflict(inc_T, *margs, offsets, cols, vals=vals),
        _kernels.max_conflict_tk(inc, *margs, q))
    # without the values the same columns read every byte as a member
    assert not torch.equal(
        _kernels.max_conflict(inc_T, *margs, offsets, cols),
        _kernels.max_conflict(inc_T, *margs, offsets, cols, vals=vals))


def test_service_index_holds_no_negative_byte():
    """The service's [K, T] index is 0/1 whatever bytes the host index
    holds (built with != 0, on the full upload and the row refresh), and
    its query is a list of columns, so the signed-byte fault cannot reach
    it."""
    rng = np.random.default_rng(9)
    t, k = 64, 32
    host = dict(_slots(t, rng),
                live_inc=rng.integers(-128, 128, (t, k)).astype(np.int8),
                key_inc=rng.integers(-128, 128, (t, k)).astype(np.int8))
    want = {n: (host[n[:-2] + "_inc"] != 0).T.astype(np.uint8)
            for n in ("live_T", "key_T")}
    front = front_from_host(host, t, k, "cpu")
    idx = DoubleBufferedIndex("cpu")
    idx.refresh(host, None, t, k)                   # the full upload
    rows = [3, 17, 40]
    host["live_inc"][rows] = -rng.integers(1, 128, (len(rows), k))
    host["key_inc"][rows] = -rng.integers(1, 128, (len(rows), k))
    idx.refresh(host, rows, t, k)                   # the row refresh
    assert idx.full_uploads == 1 and idx.incremental_refreshes == 1
    for n in ("live_T", "key_T"):
        for x in (front[n], idx.front[n]):
            assert x.dtype == torch.uint8
            assert int(x.min()) >= 0 and int(x.max()) <= 1
        _assert_equal(front[n].numpy(), want[n])
        _assert_equal(idx.front[n].numpy(),
                      (host[n[:-2] + "_inc"] != 0).T.astype(np.uint8))
