"""The port's conflict-graph model (models.conflict_graph) and its entry
point against the JAX reference, bit for bit.

The reference runs as its own tests run it (JAX on the CPU); the port on the
CPU by asking for it, with kernel K1's plain version answering the join.
States, deps masks, applied masks and counts are bool or int32, so every
comparison is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as ref_entry
from cassandra_accord_tpu import models as ref_models
from cassandra_accord_tpu.models import conflict_graph as ref_cg
from cassandra_accord_tpu.ops import graph_state as ref_gs

from cassandra_accord_tpu_torch import models
from cassandra_accord_tpu_torch.entry import entry
from cassandra_accord_tpu_torch.models import conflict_graph as cg
from cassandra_accord_tpu_torch.ops import graph_state as gs
from cassandra_accord_tpu_torch.primitives.timestamp import (Domain, TxnId,
                                                             TxnKind)


def _assert_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


def _assert_state_equal(port_state, ref_state):
    got = gs.state_to_numpy(port_state)
    for f in ref_gs.GraphState._fields:
        _assert_equal(got[f], np.asarray(getattr(ref_state, f)))


def _ref_state(fields):
    return ref_gs.GraphState(**{f: jnp.asarray(v) for f, v in fields.items()})


def _port_state(fields):
    return gs.state_from_numpy(fields, device="cpu")


def _batch_np(rng, b, k, hlc0, slots, n_valid=None):
    """A batch as numpy fields: txns touching 1-3 keys, increasing TxnIds
    from ``hlc0``; rows past ``n_valid`` are padding."""
    key_inc = np.zeros((b, k), dtype=np.int8)
    lanes = np.zeros((b, gs.TS_LANES), dtype=np.int32)
    kinds = np.zeros(b, dtype=np.int8)
    for i in range(b):
        key_inc[i, rng.choice(k, int(rng.integers(1, 4)), replace=False)] = 1
        kind = TxnKind(rng.choice([0, 1, 3, 4]))
        tid = TxnId(epoch=1, hlc=hlc0 + i, node=int(rng.integers(1, 5)),
                    kind=kind, domain=Domain.KEY)
        lanes[i] = tid.pack_lanes()
        kinds[i] = int(kind)
    valid = np.arange(b) < (b if n_valid is None else n_valid)
    return dict(slots=np.asarray(slots, dtype=np.int32), key_inc=key_inc,
                txn_id=lanes, kind=kinds, valid=valid)


def _ref_batch(fields):
    return ref_cg.TxnBatch(**{f: jnp.asarray(v) for f, v in fields.items()})


def _port_batch(fields):
    return cg.TxnBatch(**{f: torch.from_numpy(np.ascontiguousarray(v))
                          for f, v in fields.items()})


def _mk_state(rng, t, k, occupied=0.6):
    """A live random state: a share ``occupied`` of active slots with
    STABLE/APPLIED/other statuses, a sparse adjacency among them, TxnIds
    below 1000 and a fifth of executeAts above 2000 (a batch that conflicts
    with one takes the slow path)."""
    lanes = np.zeros((t, gs.TS_LANES), dtype=np.int32)
    lanes[:, 0] = 1
    lanes[:, 2] = rng.permutation(t) + 10
    lanes[:, 4] = rng.integers(1, 5, t)
    active = rng.random(t) < occupied
    adj = ((rng.random((t, t)) < 0.05) & active[:, None]
           & active[None, :]).astype(np.int8)
    status = rng.choice([1, 2, 3, 4, 5, 6], t).astype(np.int8) * active
    ts = lanes.copy()
    ts[:, 2] += rng.integers(0, 3, t).astype(np.int32)
    ts[rng.random(t) < 0.2, 2] += 2000
    return dict(key_inc=((rng.random((t, k)) < 0.2) & active[:, None])
                .astype(np.int8),
                ts=ts * active[:, None], txn_id=lanes * active[:, None],
                kind=rng.choice([0, 1, 3, 4], t).astype(np.int8) * active,
                status=status.astype(np.int8), adj=adj, active=active)


# ---------------------------------------------------------------------------
# each step against the reference; the non-donating steps leave their input
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2])
def test_steps_equal_reference_and_leave_input(seed):
    rng = np.random.default_rng(seed)
    t, k, b = 48, 12, 10
    fields = _mk_state(rng, t, k)
    free = np.flatnonzero(~fields["active"])
    slots = free[:b].copy()
    slots[8] = t - 1                                  # padding rows below
    bt = _batch_np(rng, b, k, 1000, slots, n_valid=7)
    bt["slots"][4] = bt["slots"][2]                   # a duplicate slot
    port_in, before = _port_state(fields), fields

    got = cg.preaccept_step(port_in, _port_batch(bt))
    want = ref_cg.preaccept_step(_ref_state(fields), _ref_batch(bt))
    _assert_state_equal(got[0], want[0])
    for a, c in zip(got[1:], want[1:]):
        _assert_equal(a.numpy(), c)

    exec_at = bt["txn_id"] + 3
    args = (bt["slots"], exec_at, bt["valid"])
    got = cg.stabilise_step(port_in, *(torch.from_numpy(a) for a in args))
    want = ref_cg.stabilise_step(_ref_state(fields),
                                 *(jnp.asarray(a) for a in args))
    _assert_state_equal(got, want)

    got = cg.execute_step(port_in)
    want = ref_cg.execute_step(_ref_state(fields))
    _assert_state_equal(got[0], want[0])
    _assert_equal(got[1].numpy(), want[1])
    assert got[1].any()

    wm = np.array([1, 0, 10 + t // 2, 0, 0], dtype=np.int32)
    got = cg.gc_step(port_in, torch.from_numpy(wm))
    _assert_state_equal(got, ref_cg.gc_step(_ref_state(fields),
                                            jnp.asarray(wm)))
    _assert_state_equal(port_in, _ref_state(before))


def test_padding_row_after_valid_row_at_last_slot_equals_reference():
    """The reference's padding collision: padding rows scatter to slot T-1
    and write its old value back, so a valid row aimed at slot T-1 followed
    by padding rows is lost (status 0, no keys, inactive).  The port keeps
    that answer."""
    t, k = 8, 4
    bt = dict(slots=np.array([7, 0, 0], dtype=np.int32),
              key_inc=np.ones((3, k), dtype=np.int8),
              txn_id=np.ones((3, 5), dtype=np.int32),
              kind=np.ones(3, dtype=np.int8),
              valid=np.array([True, False, False]))
    got = cg.preaccept_step(gs.init_state(t, k, device="cpu"),
                            _port_batch(bt))
    want = ref_cg.preaccept_step(ref_gs.init_state(t, k), _ref_batch(bt))
    _assert_state_equal(got[0], want[0])
    assert not got[0].active.any()
    assert int(got[0].status[7]) == 0 and not got[0].key_inc[7].any()
    # the same valid row last in batch order is inserted
    bt2 = {f: v[::-1].copy() for f, v in bt.items()}
    got = cg.preaccept_step(gs.init_state(t, k, device="cpu"),
                            _port_batch(bt2))
    want = ref_cg.preaccept_step(ref_gs.init_state(t, k), _ref_batch(bt2))
    _assert_state_equal(got[0], want[0])
    assert bool(got[0].active[7]) and int(got[0].status[7]) == gs.PREACCEPTED


# ---------------------------------------------------------------------------
# txn_step trajectories
# ---------------------------------------------------------------------------

def _trajectory_batches(rng, t, k, b, n):
    """``n`` batches for a host slot allocator that hands out the lowest
    free slots; some batches are partial (padded), and slots freed by the gc
    step after batch 6 are reused."""
    out = []
    for step in range(n):
        n_valid = b if step % 3 else int(rng.integers(1, b))
        out.append((n_valid, _batch_np(rng, b, k, 1000 + step * b,
                                       np.zeros(b, np.int32), n_valid)))
    return out


def test_txn_step_trajectory_equals_reference():
    """12 batches (partial and padded ones among them), a gc step after the
    sixth and slot reuse: every step's deps and applied mask and the state
    after every step equal the reference's."""
    rng = np.random.default_rng(11)
    t, k, b = 128, 16, 8
    fields = _mk_state(rng, t, k, occupied=0.3)
    port, ref = _port_state(fields), _ref_state(fields)
    reused, evicted = set(), set()
    applied_total = slow = 0
    for step, (n_valid, bt) in enumerate(_trajectory_batches(rng, t, k, b,
                                                              12)):
        free = np.flatnonzero(~gs.state_to_numpy(port)["active"])
        assert len(free) >= n_valid
        bt["slots"][:n_valid] = free[:n_valid]
        bt["slots"][n_valid:] = rng.integers(0, t, b - n_valid)
        reused |= set(free[:n_valid].tolist()) & evicted
        port, deps, applied = cg.txn_step(port, _port_batch(bt))
        ref, r_deps, r_applied = ref_cg.txn_step(ref, _ref_batch(bt))
        _assert_equal(deps.numpy(), r_deps)
        _assert_equal(applied.numpy(), r_applied)
        _assert_state_equal(port, ref)
        applied_total += int(applied.sum())
        mine = bt["slots"][:n_valid]
        slow += int((port.ts[mine] != port.txn_id[mine]).any(1).sum())
        if step == 5:
            wm = np.array([1, 0, 1000 + 4 * b, 0, 0], dtype=np.int32)
            was = gs.state_to_numpy(port)["active"]
            port = cg.gc_step(port, torch.from_numpy(wm))
            ref = ref_cg.gc_step(ref, jnp.asarray(wm))
            _assert_state_equal(port, ref)
            evicted = set(np.flatnonzero(
                was & ~gs.state_to_numpy(port)["active"]).tolist())
            assert evicted
    assert reused, "no evicted slot was reused"
    assert applied_total > 0 and slow > 0, (applied_total, slow)


def test_txn_step_scan_equals_reference():
    rng = np.random.default_rng(12)
    t, k, b, n = 96, 16, 8, 5
    fields = _mk_state(rng, t, k, occupied=0.3)
    free = np.flatnonzero(~fields["active"])
    stack = {f: [] for f in ("slots", "key_inc", "txn_id", "kind", "valid")}
    for i, (n_valid, bt) in enumerate(_trajectory_batches(rng, t, k, b, n)):
        bt["slots"][:] = free[i * b:(i + 1) * b]
        for f in stack:
            stack[f].append(bt[f])
    stacked = {f: np.stack(v) for f, v in stack.items()}
    port, counts = cg.txn_step_scan(_port_state(fields), _port_batch(stacked))
    ref, r_counts = ref_cg.txn_step_scan(_ref_state(fields),
                                         _ref_batch(stacked))
    _assert_equal(counts.numpy(), r_counts)
    _assert_state_equal(port, ref)
    assert counts.sum() > 0
    empty = {f: v[:0] for f, v in stacked.items()}
    _, none = cg.txn_step_scan(_port_state(fields), _port_batch(empty))
    assert none.dtype == torch.int32 and none.shape == (0,)


# ---------------------------------------------------------------------------
# the entry point and the exports
# ---------------------------------------------------------------------------

def test_entry_on_cpu_equals_reference_entry():
    fn, (state, batch) = entry(device="cpu")
    r_fn, (r_state, r_batch) = ref_entry.entry()
    _assert_state_equal(state, r_state)
    for f in ref_cg.TxnBatch._fields:
        _assert_equal(getattr(batch, f).numpy(), getattr(r_batch, f))
    got, want = fn(state, batch), r_fn(r_state, r_batch)
    _assert_state_equal(got[0], want[0])
    _assert_equal(got[1].numpy(), want[1])
    _assert_equal(got[2].numpy(), want[2])


def test_entry_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError):
        entry()


def test_models_export_reference_names():
    assert set(ref_models.__all__) <= set(models.__all__)
    for name in models.__all__:
        assert hasattr(models, name), name
