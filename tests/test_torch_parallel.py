"""The port's multi-device data plane (parallel/) against the JAX reference's,
bit for bit.

The port runs four ranks over gloo on the CPU (``device="cpu"``), one
process each (``parallel.launch.run_ranks``); the reference runs on four of
the conftest's eight virtual JAX CPU devices.  The inputs are the numpy
draws of ``tests/test_parallel.py`` at T = 64, K = 32, B = 16.  The ranks
are spawned once for the module: the fixture runs every rank program in
one process group and each test compares one result.  Every output is bool
or int32, so every comparison is exact.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cassandra_accord_tpu import ops as ref_ops
from cassandra_accord_tpu import parallel as ref_parallel
from cassandra_accord_tpu.models import TxnBatch as RefTxnBatch
from cassandra_accord_tpu.ops import deps_kernels as ref_dk
from cassandra_accord_tpu.parallel import live_dryrun as ref_ld

from cassandra_accord_tpu_torch.entry import dryrun_multichip
from cassandra_accord_tpu_torch.ops import graph_state as gs
from cassandra_accord_tpu_torch.parallel import launch
from cassandra_accord_tpu_torch.parallel import live_dryrun as ld
from cassandra_accord_tpu_torch.parallel.mesh import Coo
from cassandra_accord_tpu_torch.primitives.timestamp import (Domain, TxnId,
                                                             TxnKind)

N = 4
T, K, B = 64, 32, 16
RANK_TIMEOUT_S = 60.0


def _batch(rng, base_hlc, slots):
    """test_parallel.py's batch draw, as numpy fields."""
    key_inc = np.zeros((B, K), dtype=np.int8)
    kinds = np.zeros(B, dtype=np.int8)
    lanes = np.zeros((B, gs.TS_LANES), dtype=np.int32)
    for i in range(B):
        key_inc[i, rng.choice(K, rng.integers(1, 5), replace=False)] = 1
        kind = TxnKind(rng.choice([0, 1, 3, 4]))
        tid = TxnId(epoch=1, hlc=base_hlc + int(rng.integers(0, 200)),
                    node=int(rng.integers(1, 8)), kind=kind, domain=Domain.KEY)
        kinds[i] = int(kind)
        lanes[i] = tid.pack_lanes()
    return dict(slots=np.asarray(slots, dtype=np.int32), key_inc=key_inc,
                txn_id=lanes, kind=kinds, valid=np.ones((B,), dtype=bool))


def _round_batches():
    return [_batch(np.random.default_rng(100 + r), 1000 * (r + 1),
                   np.arange(r * B, (r + 1) * B)) for r in range(3)]


def _dup_batches():
    """Round 0, then a batch with a duplicated slot (rows 2 and 5) and two
    invalid rows (7, and 11, which names row 3's slot after it)."""
    b = _batch(np.random.default_rng(7), 5000, np.arange(B) + 24)
    b["slots"][5] = b["slots"][2]
    b["slots"][11] = b["slots"][3]
    b["valid"][[7, 11]] = False
    return [_round_batches()[0], b]


def _empty_state():
    return gs.state_to_numpy(gs.init_state(T, K, device="cpu"))


def _store_arrays():
    """test_parallel.py's store-consult draw (S = 8), first four stores."""
    S, Ts, Ks, Bq = 8, 16, 8, 4
    rng = np.random.default_rng(17)
    key_inc = (rng.random((S, Ts, Ks)) < 0.3).astype(np.int8)
    ts = np.zeros((S, Ts, 5), dtype=np.int32)
    ts[..., 0] = 1
    ts[..., 2] = rng.integers(1, 1000, (S, Ts))
    ts[..., 4] = rng.integers(1, 8, (S, Ts))
    txn_id = ts.copy()
    kind = rng.integers(0, 2, (S, Ts)).astype(np.int8)
    status = rng.integers(1, 6, (S, Ts)).astype(np.int8)
    active = np.ones((S, Ts), dtype=bool)
    q = (rng.random((S, Bq, Ks)) < 0.3).astype(np.int8)
    before = np.zeros((S, Bq, 5), dtype=np.int32)
    before[..., 0] = 1
    before[..., 2] = 2000
    qkind = rng.integers(0, 2, (S, Bq)).astype(np.int8)
    return tuple(x[:N] for x in (key_inc, key_inc, ts, txn_id, kind, status,
                                 active, q, before, qkind))


def _frontier_arrays():
    S, Ts = 8, 16
    rng = np.random.default_rng(23)
    adj = (rng.random((S, Ts, Ts)) < 0.15).astype(np.int8)
    status = rng.integers(1, 7, (S, Ts)).astype(np.int8)
    active = rng.random((S, Ts)) < 0.9
    return adj[:N], status[:N], active[:N]


def _closure_adj():
    rng = np.random.default_rng(5)
    return np.tril(rng.random((T, T)) < 0.08, k=-1).astype(np.int8)


def _live_arrays(module):
    stores, recorder, _snaps = module.collect_live_state(N, seed=11, ops=40)
    assert len(stores) == N
    st = module.stack_store_indexes(stores)
    q, before, qkind, n_real = module.build_query_batches(
        stores, recorder, st["key_inc"].shape[2])
    assert n_real > 0 and st["active"].any()
    return (st["live_inc"], st["key_inc"], st["ts"], st["txn_id"], st["kind"],
            st["status"], st["active"], q, before, qkind)


@pytest.fixture(scope="module")
def ref_mesh():
    if jax.device_count() < N:
        pytest.skip(f"needs {N} JAX devices, have {jax.device_count()}")
    return ref_parallel.make_mesh(devices=jax.devices()[:N])


@pytest.fixture(scope="module")
def port_live():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ACCORD_DEVICE", "cpu")
        return _live_arrays(ld)


@pytest.fixture(scope="module")
def ranks(port_live):
    """Every rank program, in one spawn of four gloo CPU ranks."""
    calls = [
        (launch.steps_rank, (_empty_state(), _round_batches())),
        (launch.steps_rank, (_empty_state(), _dup_batches())),
        (launch.closure_rank, (_closure_adj(),)),
        (launch.store_consult_rank, (_store_arrays(),)),
        (launch.frontier_rank, _frontier_arrays()),
        (launch.store_consult_rank, (port_live,)),
    ]
    results = launch.run_ranks(N, launch.sequence, (calls,), device="cpu",
                               timeout_s=RANK_TIMEOUT_S)
    assert len(results) == N
    names = ("steps", "dup", "closure", "consult", "frontier", "live")
    out = {name: [r.value[i] for r in results]
           for i, name in enumerate(names)}
    out["launches"] = [r.launches for r in results]
    return out


def _assert_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


def _state_of(rank_values):
    """The ranks' final local states, concatenated into the full state."""
    out = {}
    for f in gs.GraphState._fields:
        if f == "adj":
            parts = []
            for v in rank_values:
                s = v["state"]
                a = np.zeros(s["adj_shape"], np.int8)
                a[s["adj_index"][:, 0], s["adj_index"][:, 1]] = s["adj_values"]
                parts.append(a)
        else:
            parts = [v["state"][f] for v in rank_values]
        out[f] = np.concatenate(parts)
    return out


def _ref_steps(ref_mesh, batches):
    step = ref_parallel.build_sharded_step(ref_mesh)
    state = ref_parallel.shard_state(ref_ops.init_state(T, K), ref_mesh)
    outs = []
    for b in batches:
        state, cmax, applied = step(state, RefTxnBatch(
            **{k: jnp.asarray(v) for k, v in b.items()}))
        outs.append((np.asarray(cmax), np.asarray(applied)))
    return state, outs


def _check_steps(rank_values, ref_state, ref_outs):
    for i, (cmax, applied) in enumerate(ref_outs):
        for v in rank_values:               # replicated on every rank
            _assert_equal(v["conflict_max"][i], cmax)
            _assert_equal(v["applied"][i], applied)
    got = _state_of(rank_values)
    for f in gs.GraphState._fields:
        _assert_equal(got[f], getattr(ref_state, f))


def test_sharded_step_equals_reference(ranks, ref_mesh):
    """Three rounds: conflict_max, applied and every GraphState field."""
    state, outs = _ref_steps(ref_mesh, _round_batches())
    assert any(a.any() for _, a in outs)
    _check_steps(ranks["steps"], state, outs)


def test_sharded_step_duplicate_slot_and_invalid_rows_equal_reference(
        ranks, ref_mesh):
    """A slot named twice takes the later row; invalid rows write nothing,
    also when they name a valid row's slot after it (the reference sends
    both to an out-of-range slot and drops them)."""
    batches = _dup_batches()
    state, outs = _ref_steps(ref_mesh, batches)
    _check_steps(ranks["dup"], state, outs)
    got = _state_of(ranks["dup"])
    b = batches[1]
    s2, s3, s7 = (int(b["slots"][i]) for i in (2, 3, 7))
    assert np.array_equal(got["txn_id"][s2], b["txn_id"][5])
    assert np.array_equal(got["txn_id"][s3], b["txn_id"][3])
    assert not got["active"][s7]


def test_sharded_closure_equals_reference(ranks, ref_mesh):
    adj = _closure_adj()
    want = np.asarray(ref_parallel.build_sharded_closure(ref_mesh)(
        jnp.asarray(adj)))
    _assert_equal(np.concatenate([v["reach"] for v in ranks["closure"]]),
                  want)
    _assert_equal(want, np.asarray(ref_ops.transitive_closure(
        jnp.asarray(adj))))


def _check_consult(rank_values, ref_mesh, arrays):
    deps, gmax = ref_parallel.build_sharded_store_consult(ref_mesh)(
        *(jnp.asarray(x) for x in arrays))
    _assert_equal(np.concatenate([v["deps"] for v in rank_values]), deps)
    for v in rank_values:
        _assert_equal(v["global_max"], gmax)
    lanes = np.concatenate([v["max_lanes"] for v in rank_values])
    for s in range(N):
        _d, m = ref_dk.consult(*(jnp.asarray(x[s]) for x in arrays))
        _assert_equal(lanes[s], m)


def test_sharded_store_consult_equals_reference(ranks, ref_mesh):
    _check_consult(ranks["consult"], ref_mesh, _store_arrays())


def test_sharded_frontier_equals_reference(ranks, ref_mesh):
    adj, status, active = _frontier_arrays()
    want = ref_parallel.build_sharded_frontier(ref_mesh)(
        jnp.asarray(adj), jnp.asarray(status), jnp.asarray(active))
    _assert_equal(np.concatenate([v["ready"] for v in ranks["frontier"]]),
                  want)


def test_live_state_sharded_consult_equals_reference(ranks, ref_mesh,
                                                     port_live):
    """A same-seed burn builds equal live indexes and query batches in both
    packages; the burn's own recorded consults over the ranks equal the
    reference's mesh-sharded answers."""
    ref_live = _live_arrays(ref_ld)
    for a, b in zip(port_live, ref_live):
        _assert_equal(a, b)
    _check_consult(ranks["live"], ref_mesh, ref_live)


def test_rank_launches_are_reported(ranks):
    """On the CPU the kernels' plain versions answer, so no rank launched
    a kernel; each rank still reports its counts."""
    assert ranks["launches"] == [{"deps_join": 0, "max_conflict": 0}] * N


def test_dryrun_multichip_on_cpu_ranks():
    env = os.environ.get("ACCORD_DEVICE")
    out = dryrun_multichip(N, device="cpu", timeout_s=RANK_TIMEOUT_S)
    assert out["backend"] == "gloo" and out["ranks"] == N
    assert out["queries"] >= 1000 and out["frames"] >= 1
    assert out["launches"] == [{"deps_join": 0, "max_conflict": 0}] * N
    assert os.environ.get("ACCORD_DEVICE") == env   # the burn's is undone


def test_dryrun_multichip_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(N)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.run_ranks(N, launch.sequence, ([],))


def test_nccl_with_fewer_cards_than_ranks_raises():
    with pytest.raises((RuntimeError, ValueError), match="nccl"):
        launch.run_ranks(N, launch.sequence, ([],), device="cpu",
                         backend="nccl")
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="one card per rank"):
        launch.resolve_backend("nccl", torch.device("cuda"), have + 1)


def test_failed_rank_fails_the_run_promptly():
    """Rank 3's rows name a column past the array, so it raises while the
    other ranks wait in the closure's gather: every rank is killed and the
    run raises, long before the timeout."""
    import time
    bad = Coo((np.array([T - 1]), np.array([T + 5])), (T, T))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 3"):
        launch.run_ranks(N, launch.closure_rank, (bad,), device="cpu",
                         timeout_s=RANK_TIMEOUT_S)
    assert time.monotonic() - t0 < RANK_TIMEOUT_S / 2


def test_ranks_past_their_deadline_are_killed():
    with pytest.raises(TimeoutError):
        launch.run_ranks(N, launch.sequence, ([],), device="cpu",
                         timeout_s=0.2)
