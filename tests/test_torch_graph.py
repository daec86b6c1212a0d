"""The port's graph state, dense graph ops and edge-frontier tier against the
JAX reference, bit for bit.

Inputs are made with numpy from fixed seeds and handed to both packages:
the reference runs as its own tests run it (JAX on the CPU), the port on
the CPU by asking for it.  Every output is a boolean mask or int32 values,
so every comparison is exact (dtype, shape and values).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cassandra_accord_tpu import ops as ref_ops
from cassandra_accord_tpu.ops import deps_kernels as ref_dk
from cassandra_accord_tpu.ops import frontier_kernels as ref_fk
from cassandra_accord_tpu.ops import graph_state as ref_gs

from cassandra_accord_tpu_torch import ops
from cassandra_accord_tpu_torch.ops import _kernels
from cassandra_accord_tpu_torch.ops import deps_kernels as dk
from cassandra_accord_tpu_torch.ops import frontier_kernels as fk
from cassandra_accord_tpu_torch.ops import graph_state as gs

import step_cases

MAXL = 0x7FFFFFFF


def _ref(fn, *arrays):
    out = fn(*(jnp.asarray(a) for a in arrays))
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) \
        else np.asarray(out)


def _port(fn, *arrays):
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) \
        else out.numpy()


def _assert_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


def _assert_state_equal(port_state, ref_state):
    got = gs.state_to_numpy(port_state)
    for f in ref_gs.GraphState._fields:
        _assert_equal(got[f], np.asarray(getattr(ref_state, f)))


def _mk_state(rng, t, k):
    """A random GraphState as numpy fields (reference field order)."""
    lanes = rng.integers(0, 500, (t, gs.TS_LANES)).astype(np.int32)
    return dict(
        key_inc=(rng.random((t, k)) < 0.2).astype(np.int8),
        ts=lanes + rng.integers(0, 3, (t, gs.TS_LANES)).astype(np.int32),
        txn_id=lanes,
        kind=rng.choice([0, 1, 3, 4], t).astype(np.int8),
        status=rng.integers(0, 7, t).astype(np.int8),
        adj=(rng.random((t, t)) < 0.1).astype(np.int8),
        active=rng.random(t) < 0.8)


def _ref_state(fields):
    return ref_gs.GraphState(**{f: jnp.asarray(v) for f, v in fields.items()})


def _random_graph(rng, t, shape):
    """An adjacency in one of the adversarial shapes of the reference's
    tests (cyclic, DAG, self-loops), with inactive slots and statuses."""
    adj = (rng.random((t, t)) < rng.uniform(0.01, 0.2)).astype(np.int8)
    if shape == "dag":
        adj = np.tril(adj, k=-1)
    elif shape == "cyclic":
        np.fill_diagonal(adj, 0)
    adj[0, 1] = adj[1, 0] = 1                          # at least one cycle
    active = rng.random(t) < 0.85
    status = np.full(t, gs.STABLE, dtype=np.int8)
    status[rng.random(t) < 0.3] = gs.APPLIED
    status[rng.random(t) < 0.1] = gs.INVALIDATED
    return adj, status, active


# ---------------------------------------------------------------------------
# graph state
# ---------------------------------------------------------------------------

def test_init_state_equals_reference():
    got = gs.init_state(24, 8, device="cpu")
    _assert_state_equal(got, ref_gs.init_state(24, 8))
    assert got.txn_slots == 24 and got.key_slots == 8


def test_state_numpy_round_trip():
    rng = np.random.default_rng(1)
    fields = _mk_state(rng, 16, 4)
    st = gs.state_from_numpy(_ref_state(fields), device="cpu")
    _assert_state_equal(st, _ref_state(fields))
    # a copy: the host arrays are not aliased
    fields["adj"][:] = 7
    assert int(st.adj.max()) <= 1


@pytest.mark.parametrize("seed", [2, 3])
def test_batch_updates_equal_reference_and_leave_input(seed):
    """insert/set_status/set_execute_at with duplicate slots (the last row
    wins, as the reference's CPU scatter) and the input state untouched."""
    rng = np.random.default_rng(seed)
    t, k, b = 32, 8, 9
    fields = _mk_state(rng, t, k)
    slots = rng.integers(0, t, b).astype(np.int32)
    slots[3] = slots[7] = slots[1]                    # duplicates
    key_inc = (rng.random((b, k)) < 0.3).astype(np.int8)
    ts = rng.integers(0, 500, (b, 5)).astype(np.int32)
    txn_id = rng.integers(0, 500, (b, 5)).astype(np.int32)
    kind = rng.integers(0, 5, b).astype(np.int8)
    status = rng.integers(0, 7, b).astype(np.int8)
    deps = (rng.random((b, t)) < 0.3).astype(np.int8)
    args = (slots, key_inc, ts, txn_id, kind, status, deps)
    port_in = gs.state_from_numpy(fields, device="cpu")
    before = gs.state_to_numpy(port_in)

    want = ref_gs.insert_batch(_ref_state(fields),
                               *(jnp.asarray(a) for a in args))
    got = gs.insert_batch(port_in, *(torch.from_numpy(a) for a in args))
    _assert_state_equal(got, want)
    want = ref_gs.set_status_batch(_ref_state(fields), jnp.asarray(slots),
                                   jnp.asarray(status))
    got = gs.set_status_batch(port_in, torch.from_numpy(slots),
                              torch.from_numpy(status))
    _assert_state_equal(got, want)
    want = ref_gs.set_execute_at_batch(_ref_state(fields), jnp.asarray(slots),
                                       jnp.asarray(ts))
    got = gs.set_execute_at_batch(port_in, torch.from_numpy(slots),
                                  torch.from_numpy(ts))
    _assert_state_equal(got, want)
    for f, v in gs.state_to_numpy(port_in).items():
        _assert_equal(v, before[f])


# two batch slots for T slots: out of range (T), wrapped once (-1 names
# T-1, also beside a row at T-1), out of range after the wrap (-T-1)
SLOT_CASES = {"T,1": lambda t: (t, 1), "-1,1": lambda t: (-1, 1),
              "-1,T-1": lambda t: (-1, t - 1), "-T-1,1": lambda t: (-t - 1, 1)}


@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_batch_updates_with_negative_and_out_of_range_slots_equal_reference(
        case):
    """The reference's ``.at[slots].set`` wraps a slot in [-T, -1] once and
    drops any other slot outside [0, T); a wrapped slot that names the same
    slot as another row keeps the batch's last row."""
    rng = np.random.default_rng(43)
    t, k = 8, 4
    fields = _mk_state(rng, t, k)
    fields["active"][:] = False
    slots = np.array(SLOT_CASES[case](t), np.int32)
    b = len(slots)
    key_inc = np.ones((b, k), np.int8)
    ts = (np.arange(b * 5, dtype=np.int32).reshape(b, 5) + 600)
    kind = np.array([1, 3], np.int8)
    status = np.array([3, 4], np.int8)
    deps = np.ones((b, t), np.int8)
    args = (slots, key_inc, ts, ts + 1, kind, status, deps)
    want = ref_gs.insert_batch(_ref_state(fields),
                               *(jnp.asarray(a) for a in args))
    got = gs.insert_batch(gs.state_from_numpy(fields, device="cpu"),
                          *(torch.from_numpy(a) for a in args))
    _assert_state_equal(got, want)
    assert int(got.active.sum()) == len({int(x) % t for x in slots
                                         if -t <= x < t})
    for fn, vals in ((gs.set_status_batch, status),
                     (gs.set_execute_at_batch, ts)):
        want = getattr(ref_gs, fn.__name__)(
            _ref_state(fields), jnp.asarray(slots), jnp.asarray(vals))
        got = fn(gs.state_from_numpy(fields, device="cpu"),
                 torch.from_numpy(slots), torch.from_numpy(vals))
        _assert_state_equal(got, want)


@pytest.mark.parametrize("t", [40, 37])
def test_evict_mask_equals_reference_and_leaves_input(t):
    """T = 40 masks the adjacency in 8-byte words, T = 37 byte by byte."""
    rng = np.random.default_rng(4)
    fields = _mk_state(rng, t, 8)
    keep = rng.random(t) < 0.6
    port_in = gs.state_from_numpy(fields, device="cpu")
    got = gs.evict_mask(port_in, torch.from_numpy(keep))
    _assert_state_equal(got, ref_gs.evict_mask(_ref_state(fields),
                                               jnp.asarray(keep)))
    _assert_state_equal(port_in, _ref_state(fields))


def test_host_views_equal_reference():
    rng = np.random.default_rng(5)
    fields = _mk_state(rng, 30, 4)
    st, ref = gs.state_from_numpy(fields, device="cpu"), _ref_state(fields)
    _assert_equal(gs.to_host_deps(st), ref_gs.to_host_deps(ref))
    for a, b in zip(gs.adj_edges(st), ref_gs.adj_edges(ref)):
        _assert_equal(a, b)


def test_ts_next_equals_reference_at_the_int32_boundary():
    """At hlc_lo = 0x7FFFFFFF the reference's int32 ``lo + 1`` wraps and the
    arithmetic shift carries -1: [1,5,MAX,0,3] -> [1,4,0,0,0], below its
    input.  The port keeps int32 and gives the same answer."""
    edge = np.array([[1, 5, MAXL, 0, 3]], dtype=np.int32)
    got = gs.ts_next(torch.from_numpy(edge), 0).numpy()
    _assert_equal(got, np.array([[1, 4, 0, 0, 0]], dtype=np.int32))
    _assert_equal(got, np.asarray(ref_gs.ts_next(jnp.asarray(edge), 0)))
    rng = np.random.default_rng(6)
    lanes = rng.integers(0, MAXL, (64, 5)).astype(np.int32)
    lanes[::4, 2] = MAXL
    lanes[1::4, 2] = MAXL - 1
    for node in (0, 7):
        _assert_equal(gs.ts_next(torch.from_numpy(lanes), node).numpy(),
                      np.asarray(ref_gs.ts_next(jnp.asarray(lanes), node)))


# ---------------------------------------------------------------------------
# dense graph ops
# ---------------------------------------------------------------------------

GRAPH_CASES = [(64, 1, "cyclic"), (64, 2, "dag"), (128, 3, "selfloops"),
               (128, 4, "cyclic")]


@pytest.mark.parametrize("t,seed,shape", GRAPH_CASES)
def test_dense_graph_ops_equal_reference(t, seed, shape):
    rng = np.random.default_rng(seed)
    adj, status, active = _random_graph(rng, t, shape)
    _assert_equal(_port(dk.transitive_closure, adj),
                  _ref(ref_dk.transitive_closure, adj))
    _assert_equal(_port(dk.elide, adj), _ref(ref_dk.elide, adj))
    _assert_equal(_port(dk.kahn_frontier, adj, status, active),
                  _ref(ref_dk.kahn_frontier, adj, status, active))
    _assert_equal(_port(dk.kahn_levels, adj, active),
                  _ref(ref_dk.kahn_levels, adj, active))
    got, want = _port(dk.scc_condense, adj, active), \
        _ref(ref_dk.scc_condense, adj, active)
    for a, b in zip(got, want):
        _assert_equal(a, b)
    assert (got[0][~active] == -1).all()


@pytest.mark.parametrize("seed", [5, 6])
def test_max_conflict_ts_equals_reference(seed):
    rng = np.random.default_rng(seed)
    t, b = 96, 12
    exec_at = rng.integers(0, 300, (t, 5)).astype(np.int32)
    exec_at[::7] = MAXL
    deps = rng.random((b, t)) < 0.2
    deps[0] = False                                   # no conflict: zeros
    got = _port(dk.max_conflict_ts, exec_at, deps)
    want = _ref(ref_dk.max_conflict_ts, exec_at, deps)
    for a, c in zip(got, want):
        _assert_equal(a, c)


def _single_pass(ts, deps):
    """csrc/lex_max.cu's rule in numpy: from each row's count of set slots,
    their plain lex max and their lane minima alone."""
    b, t = deps.shape
    out = np.zeros((b, gs.TS_LANES), np.int32)
    for i in range(b):
        rows = ts[deps[i]].astype(np.int64)
        if not len(rows):
            continue
        top = max(map(tuple, rows.tolist()))
        s = 0
        if len(rows) == t:
            low = rows.min(0)
            s = next((l + 1 for l in range(gs.TS_LANES) if low[l] != top[l]),
                     gs.TS_LANES)
        gone = False
        for lane in range(gs.TS_LANES):
            gone = gone or (lane >= s and top[lane] < -1)
            out[i, lane] = 0 if gone else max(top[lane], 0)
    return out, deps.any(1)


@pytest.mark.parametrize("lanes", step_cases.LEX_LANES)
@pytest.mark.parametrize("t", [1, 7, 61])
def test_lex_max_single_pass_rule_equals_reference(lanes, t):
    """The one-pass rule the lex max kernel states (a count, the plain lex
    max and the lane minima of the set slots) equals the reference's
    five-lane chain and the port's plain version for any int32 lanes: the
    -1 seeds of untied slots, negative lanes, MAXL, all-true rows whose
    slots agree on the first lanes, all-false rows."""
    for start in range(len(step_cases.LEX_ROWS)):
        ts, deps = step_cases.lex_case(lanes, 10, t, start, seed=t + start)
        want = _ref(ref_dk.max_conflict_ts, ts, deps)
        for got in (_single_pass(ts, deps), _port(dk.max_conflict_ts, ts, deps)):
            for a, c in zip(got, want):
                _assert_equal(a, c)


LEX_BAD = {
    "ts_int64": (lambda ts, d: (ts.long(), d), TypeError),
    "deps_uint8": (lambda ts, d: (ts, d.to(torch.uint8)), TypeError),
    "four_lanes": (lambda ts, d: (ts[:, :4].contiguous(), d), ValueError),
    "ts_one_slot_more": (lambda ts, d: (torch.cat([ts, ts[:1]]), d),
                         ValueError),
    "deps_one_row_1d": (lambda ts, d: (ts, d[0]), ValueError),
    "deps_not_contiguous": (lambda ts, d: (ts, d.t().contiguous().t()),
                            ValueError),
    "ts_not_contiguous": (lambda ts, d: (ts.t().contiguous().t(), d),
                          ValueError),
    "meta_device": (lambda ts, d: (ts.to("meta"), d.to("meta")), ValueError),
}


@pytest.mark.parametrize("case", sorted(LEX_BAD))
def test_lex_max_deps_refuses_what_it_does_not_take(case):
    """``_kernels.lex_max_deps`` checks its arguments on every device, the
    CPU's plain path too: [B, T] bool deps, [T, 5] int32 lanes, both
    contiguous, on the CPU or a CUDA card."""
    ts, deps = (torch.from_numpy(a) for a in step_cases.lex_case("wide", 6, 6))
    bad, err = LEX_BAD[case]
    with pytest.raises(err):
        _kernels.lex_max_deps(*bad(ts, deps))
    got = _kernels.lex_max_deps(ts, deps)
    want = _kernels.lex_max_deps_plain(ts, deps)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_lex_max_deps_empty_shapes_on_cpu():
    """No rows, or rows over no slots: zero lanes and no dependency."""
    for b, t in ((0, 5), (3, 0)):
        got = _kernels.lex_max_deps(torch.zeros((t, 5), dtype=torch.int32),
                                    torch.zeros((b, t), dtype=torch.bool))
        assert got[0].shape == (b, 5) and not got[0].any()
        assert got[1].shape == (b,) and not got[1].any()


def test_bool_matvec_chunks_equal_one_product(monkeypatch):
    """The row-chunked frontier product equals the unchunked one."""
    rng = np.random.default_rng(7)
    adj, status, active = _random_graph(rng, 100, "cyclic")
    want = _port(dk.kahn_frontier, adj, status, active)
    monkeypatch.setattr(dk, "MATVEC_CHUNK_ELEMS", 3 * 100 + 1)
    _assert_equal(_port(dk.kahn_frontier, adj, status, active), want)
    _assert_equal(_port(dk.kahn_levels, adj, active),
                  _ref(ref_dk.kahn_levels, adj, active))


# ---------------------------------------------------------------------------
# edge forms and host wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,seed,shape", GRAPH_CASES)
def test_edge_forms_equal_reference_and_dense_twins(t, seed, shape):
    rng = np.random.default_rng(seed)
    adj, status, active = _random_graph(rng, t, shape)
    src, dst = fk.edges_from_dense(adj)
    s, d, v = fk._pad_edges(src, dst, fk._pow2(len(src)))
    _assert_equal(_port(fk.kahn_levels_edges, s, d, v, active),
                  _ref(ref_fk.kahn_levels_edges, s, d, v, active))
    for a, b in zip(_port(fk.scc_condense_edges, s, d, v, active),
                    _ref(ref_fk.scc_condense_edges, s, d, v, active)):
        _assert_equal(a, b)

    cpu = {"device": "cpu"}
    pairs = [
        (fk.transitive_closure_csr(adj, **cpu),
         ref_fk.transitive_closure_csr(adj), _port(dk.transitive_closure, adj)),
        (fk.elide_csr(adj, **cpu), ref_fk.elide_csr(adj),
         _port(dk.elide, adj)),
        (fk.kahn_levels_csr(adj, active, **cpu),
         ref_fk.kahn_levels_csr(adj, active), _port(dk.kahn_levels, adj, active)),
        (fk.kahn_frontier_csr(adj, status, active, **cpu),
         ref_fk.kahn_frontier_csr(adj, status, active),
         _port(dk.kahn_frontier, adj, status, active)),
    ]
    for got, want, dense in pairs:
        _assert_equal(got, want)
        _assert_equal(got, dense)
    dense = _port(dk.scc_condense, adj, active)
    for got, want, twin in zip(fk.scc_condense_csr(adj, active, **cpu),
                               ref_fk.scc_condense_csr(adj, active), dense):
        _assert_equal(got, want)
        _assert_equal(got, twin)
    for a, b in zip(fk.closure_condensed(adj, **cpu),
                    ref_fk.closure_condensed(adj)):
        _assert_equal(a, b)


def test_scc_with_inactive_labels_equals_reference():
    """-1 labels in the component scatter: inactive slots with edges into
    and out of cycles, an inactive slot at T-1 (where JAX sends -1), and
    padding edges at slot 0."""
    t = 12
    adj = np.zeros((t, t), dtype=np.int8)
    for i, j in [(0, 1), (1, 2), (2, 0), (3, 0), (4, 3), (5, 4), (4, 5),
                 (6, 11), (11, 6), (7, 6), (8, 9), (9, 8), (10, 8),
                 (6, 7)]:
        adj[i, j] = 1
    active = np.ones(t, dtype=bool)
    active[[5, 11, 9]] = False
    got = _port(dk.scc_condense, adj, active)
    for a, b in zip(got, _ref(ref_dk.scc_condense, adj, active)):
        _assert_equal(a, b)
    assert (got[0][[5, 9, 11]] == -1).all() and got[0][2] == 0
    src, dst = fk.edges_from_dense(adj)
    s, d, v = fk._pad_edges(src, dst, 64)            # 50 padding edges
    for a, b in zip(_port(fk.scc_condense_edges, s, d, v, active),
                    _ref(ref_fk.scc_condense_edges, s, d, v, active)):
        _assert_equal(a, b)
    none = np.zeros(t, dtype=bool)
    for a, b in zip(_port(fk.scc_condense_edges, s, d, v, none),
                    _ref(ref_fk.scc_condense_edges, s, d, v, none)):
        _assert_equal(a, b)


def test_edge_wrappers_without_edges_equal_reference():
    adj = np.zeros((9, 9), dtype=np.int8)
    active = np.array([1, 0, 1, 1, 1, 0, 1, 1, 1], dtype=bool)
    _assert_equal(fk.transitive_closure_csr(adj, device="cpu"),
                  ref_fk.transitive_closure_csr(adj))
    _assert_equal(fk.elide_csr(adj, device="cpu"), ref_fk.elide_csr(adj))
    for a, b in zip(fk.scc_condense_csr(adj, active, device="cpu"),
                    ref_fk.scc_condense_csr(adj, active)):
        _assert_equal(a, b)


def test_exports_cover_reference():
    assert set(ref_ops.__all__) <= set(ops.__all__)
    for name in ops.__all__:
        assert hasattr(ops, name), name


def test_graph_entry_points_raise_without_cuda():
    """No silent CPU: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    adj = np.eye(4, dtype=np.int8)
    active = np.ones(4, dtype=bool)
    for call in (lambda: gs.init_state(8, 4),
                 lambda: gs.state_from_numpy(gs.state_to_numpy(
                     gs.init_state(8, 4, device="cpu"))),
                 lambda: fk.kahn_levels_csr(adj, active),
                 lambda: fk.scc_condense_csr(adj, active),
                 lambda: fk.kahn_frontier_csr(adj, active.astype(np.int8),
                                              active),
                 lambda: fk.transitive_closure_csr(adj),
                 lambda: fk.elide_csr(adj),
                 lambda: fk.elide_csr(np.zeros((4, 4), np.int8)),
                 lambda: fk.closure_condensed(adj)):
        with pytest.raises(RuntimeError):
            call()
