"""The hand-written CUDA consult kernels against their plain versions, and
the conflict-graph model and graph ops on the card against the CPU.

These need an NVIDIA card (sm_90a) and nvcc: without CUDA every test here
skips with that reason.  Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q

The whole port is also driven on the card by ``python3 chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import bench_torch
from cassandra_accord_tpu_torch.device_service.kernel import (
    ragged_consult_t, to_host)
from cassandra_accord_tpu_torch.entry import entry
from cassandra_accord_tpu_torch.models import conflict_graph as cg
from cassandra_accord_tpu_torch.ops import _kernels
from cassandra_accord_tpu_torch.ops import deps_kernels as dk
from cassandra_accord_tpu_torch.ops import frontier_kernels as fk
from cassandra_accord_tpu_torch.ops import graph_state as gs

import step_cases


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(rng, t, k, b, device, width=3, wide=0, oob=False, dups=0,
            inactive=False, invalidated=False):
    """Random index and CSR query.  Rows take 0..``width`` keys; with
    ``wide`` row 0 takes that many columns (duplicates included), with
    ``dups`` row 0 is that many copies of one column, and with ``oob``
    about a tenth of the columns fall outside [0, k).  ``inactive`` and
    ``invalidated`` make every slot so."""
    inc = (rng.random((k, t)) < 0.05).astype(np.uint8)
    lanes = rng.integers(0, 50, (t, 5)).astype(np.int32)
    ts = lanes + rng.integers(0, 3, (t, 5)).astype(np.int32)
    kind = rng.integers(0, 6, t).astype(np.int8)
    status = rng.integers(0, 7, t).astype(np.int8)
    active = rng.random(t) < 0.9
    if inactive:
        active[:] = False
    if invalidated:
        status[:] = gs.INVALIDATED
    lens = rng.integers(0, width + 1, b)
    if wide or dups:
        lens[0] = wide or dups
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = rng.integers(0, k, int(offsets[-1]) + 5).astype(np.int32)
    if dups:
        cols[:dups] = int(np.argmax(inc.sum(1)))
    if oob:
        bad = rng.random(cols.size) < 0.1
        cols[bad] = rng.choice([-7, -1, k, k + 100], int(bad.sum()))
    before = rng.integers(0, 50, (b, 5)).astype(np.int32)
    qkind = rng.integers(0, 6, b).astype(np.int8)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dict(inc=up(inc), txn_id=up(lanes), ts=up(ts), kind=up(kind),
                status=up(status), active=up(active), offsets=up(offsets),
                cols=up(cols), before=up(before), qkind=up(qkind))


def _args(g):
    return ((g["inc"], g["txn_id"], g["kind"], g["status"], g["active"],
             g["offsets"], g["cols"], g["before"], g["qkind"]),
            (g["inc"], g["ts"], g["txn_id"], g["active"], g["offsets"],
             g["cols"]))


# (t, k, b, keyword arguments of _inputs).  The CSR form: a block takes 8
# query rows and up to 2,048 slots (fewer threads when T is below that) and
# stages at most 4,096 query columns at a time.  The dense form: a block
# takes 16 or 64 query rows and tiles of 128 slots in 16-byte stages, so
# only T % 16 == 0 (other T raise), and stages keys 64 at a time.
CASES = {
    "64-16-8": (64, 16, 8, {}),
    "1003-64-13": (1003, 64, 13, {}),
    "4104-128-33": (4104, 128, 33, {}),
    "T_below_one_warp": (20, 8, 5, {}),
    "one_tile_burn_shape": (256, 16, 8, {"width": 2}),
    "two_tiles_last_has_one_slot": (2049, 64, 13, {}),
    "three_tiles_B_not_multiple_of_rows": (6147, 64, 21, {}),
    "one_row": (4096, 32, 1, {"wide": 3}),
    "rows_without_keys": (512, 16, 11, {"width": 0}),
    "row_wider_than_stage": (4096, 64, 9, {"wide": 5000}),
    "out_of_range_columns": (2048, 32, 16, {"width": 6, "oob": True}),
    "K_not_multiple_of_key_stage": (4096, 100, 20, {"width": 40}),
    "B_above_row_tile": (2048, 128, 256, {"width": 64}),
    "T_below_one_slot_tile": (96, 64, 13, {"width": 32}),
    "T_not_multiple_of_16": (4100, 64, 30, {"width": 32}),
    "T_multiple_of_16_not_of_slot_tile": (4112, 64, 30, {"width": 32}),
    "all_slots_inactive": (2048, 64, 13, {"width": 32, "inactive": True}),
    "all_slots_invalidated": (2048, 64, 13, {"width": 32,
                                             "invalidated": True}),
    "300_duplicate_columns": (2048, 64, 5, {"dups": 300}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deps_join_and_max_conflict_equal_plain(cuda, case):
    t, k, b, kw = CASES[case]
    g = _inputs(np.random.default_rng(t), t, k, b, cuda, **kw)
    args, margs = _args(g)
    before = dict(_kernels.LAUNCHES)
    assert torch.equal(_kernels.deps_join(*args),
                       _kernels.deps_join_plain(*args))
    if t % 8 == 0:
        assert torch.equal(_kernels.deps_join(*args, packed=True),
                           _kernels.deps_join_plain(*args, packed=True))
    assert torch.equal(_kernels.max_conflict(*margs),
                       _kernels.max_conflict_plain(*margs))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["deps_join"] > before["deps_join"]
    assert _kernels.LAUNCHES["max_conflict"] == before["max_conflict"] + 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_form_equals_plain_and_csr(cuda, case):
    """K1d (bool and bit-packed) and K2d, forced, on every case: equal to
    the plain versions and to the CSR form, one launch each counted under
    the dense names and none under the CSR names; at T % 16 != 0 both
    raise and launch nothing."""
    t, k, b, kw = CASES[case]
    g = _inputs(np.random.default_rng(t), t, k, b, cuda, **kw)
    args, margs = _args(g)
    if t % 16:
        before = dict(_kernels.LAUNCHES)
        with pytest.raises(ValueError):
            _kernels.deps_join_dense(*args)
        with pytest.raises(ValueError):
            _kernels.max_conflict_dense(*margs)
        assert _kernels.LAUNCHES == before
        assert _kernels.join_form(b, t, k, 10 ** 9) == "csr"
        return
    packs = (False, True) if t % 8 == 0 else (False,)
    csr = [_kernels.deps_join(*args, packed=pk) for pk in packs]
    csr_max = _kernels.max_conflict(*margs)
    torch.cuda.synchronize()
    before = dict(_kernels.LAUNCHES)
    for pk, want in zip(packs, csr):
        got = _kernels.deps_join_dense(*args, packed=pk)
        assert torch.equal(got, _kernels.deps_join_plain(*args, packed=pk))
        assert torch.equal(got, want)
    got = _kernels.max_conflict_dense(*margs)
    assert torch.equal(got, _kernels.max_conflict_plain(*margs))
    assert torch.equal(got, csr_max)
    torch.cuda.synchronize()
    after = dict(_kernels.LAUNCHES)
    assert after["deps_join_dense"] == before["deps_join_dense"] + len(packs)
    assert after["max_conflict_dense"] == before["max_conflict_dense"] + 1
    assert after["deps_join"] == before["deps_join"]
    assert after["max_conflict"] == before["max_conflict"]


@pytest.mark.parametrize("width", [3, 128])
def test_auto_form_follows_join_form(cuda, width):
    """The window (``ragged_consult_t``) launches the kernels join_form
    names for the call's sizes (narrow rows: CSR, K12; rows of ~64 keys at
    T = 8,192: dense, K1d and K2d), counted under their names, with the
    plain versions' answers."""
    t, k, b = 8192, 256, 64
    g = _inputs(np.random.default_rng(width), t, k, b, cuda, width=width)
    args, margs = _args(g)
    form = _kernels.join_form(b, t, k, g["cols"].numel())
    assert form == ("csr" if width == 3 else "dense")
    names = ({"fused_consult": 1} if form == "csr"
             else {"deps_join_dense": 1, "max_conflict_dense": 1})
    before = dict(_kernels.LAUNCHES)
    deps, lanes = ragged_consult_t(g["inc"], g["inc"], g["ts"], g["txn_id"],
                                   g["kind"], g["status"], g["active"],
                                   g["cols"], g["offsets"], g["before"],
                                   g["qkind"])
    assert torch.equal(deps, _kernels.deps_join_plain(*args))
    assert torch.equal(lanes, _kernels.max_conflict_plain(*margs))
    torch.cuda.synchronize()
    assert {n: v - before[n] for n, v in _kernels.LAUNCHES.items()
            if v != before[n]} == names


def test_dense_form_needs_k_within_its_tile(cuda):
    g = _inputs(np.random.default_rng(3), 64, _kernels.DENSE_MAX_K + 1, 4,
                cuda)
    args, margs = _args(g)
    with pytest.raises(ValueError):
        _kernels.deps_join_dense(*args)
    with pytest.raises(ValueError):
        _kernels.max_conflict_dense(*margs)
    assert _kernels.join_form(4, 65536, _kernels.DENSE_MAX_K + 1,
                              10 ** 9) == "csr"


def test_dense_form_needs_an_aligned_index(cuda):
    """An index whose first byte is not 16-byte aligned (a view one byte
    into its storage) is refused by the dense form and taken by CSR."""
    g = _inputs(np.random.default_rng(5), 256, 64, 8, cuda, width=32)
    args, margs = _args(g)
    inc = g["inc"]
    flat = torch.empty(inc.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = flat[1:].view(inc.shape)
    shifted.copy_(inc)
    assert shifted.data_ptr() % 16 != 0
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError):
        _kernels.deps_join_dense(shifted, *args[1:])
    with pytest.raises(ValueError):
        _kernels.max_conflict_dense(shifted, *margs[1:])
    assert _kernels.LAUNCHES == before
    assert torch.equal(_kernels.deps_join(shifted, *args[1:]),
                       _kernels.deps_join_plain(*args))
    assert torch.equal(_kernels.max_conflict(shifted, *margs[1:]),
                       _kernels.max_conflict_plain(*margs))


def test_negative_columns_on_card_equal_plain_and_cpu(cuda):
    """Columns -1 and -K name columns K-1 and 0 (the reference's densify
    wraps them once); K and -K-1 are dropped.  The card's K1/K2 answers
    equal the plain versions on the card and the wrappers on the CPU."""
    t, k = 2049, 64
    g = _inputs(np.random.default_rng(5), t, k, 4, cuda)
    g["inc"][[0, k - 1]] = 1                     # the wrapped keys are real
    g["offsets"] = torch.tensor([0, 3, 5, 6, 7], dtype=torch.int32,
                                device=cuda)
    g["cols"] = torch.tensor([-1, -k, k, -k - 1, 3, -1, 2], dtype=torch.int32,
                             device=cuda)
    args, margs = _args(g)
    on_cpu = [[x.cpu() for x in a] for a in (args, margs)]
    deps = _kernels.deps_join(*args)
    cmax = _kernels.max_conflict(*margs)
    assert torch.equal(deps, _kernels.deps_join_plain(*args))
    assert torch.equal(cmax, _kernels.max_conflict_plain(*margs))
    assert torch.equal(deps.cpu(), _kernels.deps_join(*on_cpu[0]))
    assert torch.equal(cmax.cpu(), _kernels.max_conflict(*on_cpu[1]))
    assert cmax[0].any() and cmax[2].any()


@pytest.mark.parametrize("case", ["T,1", "-1,1", "-1,T-1", "-T-1,1"])
def test_negative_and_out_of_range_slots_on_card_equal_cpu(cuda, case):
    """insert_batch and txn_step with slots outside [0, T): no device-side
    assert, and the state equals the CPU's (which equals the reference's,
    tests/test_torch_graph.py and test_torch_model.py)."""
    t, k = 64, 16
    slots = {"T,1": (t, 1), "-1,1": (-1, 1), "-1,T-1": (-1, t - 1),
             "-T-1,1": (-t - 1, 1)}[case]
    st_c = gs.init_state(t, k, device="cpu")
    lanes = torch.tensor([[1, 0, 100, 0, 1], [1, 0, 101, 0, 2]],
                         dtype=torch.int32)
    bt_c = cg.TxnBatch(slots=torch.tensor(slots, dtype=torch.int32),
                       key_inc=torch.ones((2, k), dtype=torch.int8),
                       txn_id=lanes, kind=torch.ones(2, dtype=torch.int8),
                       valid=torch.ones(2, dtype=torch.bool))
    ins = (bt_c.slots, bt_c.key_inc, bt_c.txn_id, bt_c.txn_id, bt_c.kind,
           torch.full((2,), gs.STABLE, dtype=torch.int8),
           torch.ones((2, t), dtype=torch.int8))
    want = gs.insert_batch(st_c, *ins)
    got = gs.insert_batch(gs.init_state(t, k, device=cuda),
                          *(x.to(cuda) for x in ins))
    for name, v in gs.state_to_numpy(want).items():
        assert np.array_equal(gs.state_to_numpy(got)[name], v), name
    want, deps_c, applied_c = cg.txn_step(st_c, bt_c)
    got, deps, applied = cg.txn_step(gs.init_state(t, k, device=cuda),
                                     cg.TxnBatch(*(x.to(cuda) for x in bt_c)))
    torch.cuda.synchronize()
    assert torch.equal(deps.cpu(), deps_c)
    assert torch.equal(applied.cpu(), applied_c)
    for name, v in gs.state_to_numpy(want).items():
        assert np.array_equal(gs.state_to_numpy(got)[name], v), name


@pytest.mark.parametrize("form", ["csr", "dense"])
def test_graph_replays_equal_plain(cuda, form):
    """K1 and K2 in either form (K1d and K2d for "dense"), one block per
    row group and several,
    captured in one CUDA graph: every replay's answers equal the plain
    versions, with the outputs overwritten before each replay (a fold
    counter left over from an earlier replay would leave K2's output
    unwritten)."""
    sets = [_args(_inputs(np.random.default_rng(t), t, 64, 21, cuda,
                          width=3 if form == "csr" else 32))
            for t in ((120, 256, 6147) if form == "csr"
                      else (112, 256, 6160))]
    k1, k2 = ((_kernels.deps_join, _kernels.max_conflict) if form == "csr"
              else (_kernels.deps_join_dense, _kernels.max_conflict_dense))
    want = [(_kernels.deps_join_plain(*a), _kernels.max_conflict_plain(*m))
            for a, m in sets]
    got = []

    def body():
        got[:] = [(k1(*a), k2(*m)) for a, m in sets]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for _ in range(3):
        for outs, wants in zip(got, want):
            for out, w in zip(outs, wants):
                out.copy_(torch.bitwise_not(w))
        graph.replay()
        torch.cuda.synchronize()
        for outs, wants in zip(got, want):
            for out, w in zip(outs, wants):
                assert torch.equal(out, w)


def test_dense_entry_points_on_card_equal_cpu(cuda):
    rng = np.random.default_rng(5)
    t, k, b = 256, 32, 16
    arrays = ((rng.random((t, k)) < 0.1).astype(np.int8),
              (rng.random((t, k)) < 0.1).astype(np.int8),
              rng.integers(0, 99, (t, 5)).astype(np.int32),
              rng.integers(0, 99, (t, 5)).astype(np.int32),
              rng.integers(0, 6, t).astype(np.int8),
              rng.integers(0, 7, t).astype(np.int8), rng.random(t) < 0.9,
              (rng.random((b, k)) < 0.1).astype(np.int8),
              rng.integers(0, 99, (b, 5)).astype(np.int32),
              rng.integers(0, 6, b).astype(np.int8))
    cpu = [torch.from_numpy(a) for a in arrays]
    gpu = [x.to(cuda) for x in cpu]
    for fn in (dk.consult, dk.consult_packed):
        for a, c in zip(fn(*gpu), fn(*cpu)):
            assert torch.equal(a.cpu(), c)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g = _inputs(np.random.default_rng(1), 64, 16, 4, cuda)
    args = [g["inc"], g["txn_id"], g["kind"], g["status"], g["active"],
            g["offsets"], g["cols"], g["before"], g["qkind"]]
    bad_dtype = list(args)
    bad_dtype[1] = bad_dtype[1].to(torch.int64)
    with pytest.raises(TypeError):
        _kernels.deps_join(*bad_dtype)
    strided = list(args)
    strided[0] = torch.zeros((64, 16), dtype=torch.uint8, device=cuda).t()
    with pytest.raises(ValueError):
        _kernels.deps_join(*strided)
    mixed = list(args)
    mixed[2] = mixed[2].cpu()
    with pytest.raises(ValueError):
        _kernels.deps_join(*mixed)
    odd = _inputs(np.random.default_rng(2), 61, 16, 4, cuda)
    with pytest.raises(ValueError):
        _kernels.deps_join(odd["inc"], odd["txn_id"], odd["kind"],
                           odd["status"], odd["active"], odd["offsets"],
                           odd["cols"], odd["before"], odd["qkind"],
                           packed=True)


def test_txn_step_on_card_equals_cpu(cuda):
    """The entry point's step, three batches and a gc step, on the card and
    on the CPU: equal deps, applied masks and final state; one K1 launch per
    step on the card, on the kernel the [T, K] rule (tk_refusal) picks."""
    fn, (st, bt) = entry(device=cuda)
    _, (st_c, bt_c) = entry(device="cpu")
    k1 = ("deps_join", "deps_join_dense", "deps_join_dense_tk")
    before = sum(_kernels.LAUNCHES[n] for n in k1)
    for step in range(3):
        shift = torch.tensor([0, 0, 64 * step, 0, 0], dtype=torch.int32)
        b_c = bt_c._replace(slots=bt_c.slots + 64 * step,
                            txn_id=bt_c.txn_id + shift)
        st, deps, applied = fn(st, cg.TxnBatch(*(x.to(cuda) for x in b_c)))
        st_c, deps_c, applied_c = fn(st_c, b_c)
        assert torch.equal(deps.cpu(), deps_c)
        assert torch.equal(applied.cpu(), applied_c)
    wm = torch.tensor([1, 0, 164, 0, 0], dtype=torch.int32)
    st, st_c = cg.gc_step(st, wm.to(cuda)), cg.gc_step(st_c, wm)
    got, want = gs.state_to_numpy(st), gs.state_to_numpy(st_c)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    torch.cuda.synchronize()
    assert sum(_kernels.LAUNCHES[n] for n in k1) == before + 3


def test_graph_ops_on_card_equal_edge_twins_and_cpu(cuda):
    rng = np.random.default_rng(9)
    t = 300
    adj = (rng.random((t, t)) < 0.02).astype(np.int8)
    active = rng.random(t) < 0.9
    status = rng.choice([gs.STABLE, gs.APPLIED], t).astype(np.int8)
    a, act, st = (torch.from_numpy(x).to(cuda) for x in (adj, active, status))
    pairs = [
        (dk.transitive_closure(a), lambda d: fk.transitive_closure_csr(adj, d)),
        (dk.elide(a), lambda d: fk.elide_csr(adj, d)),
        (dk.kahn_levels(a, act), lambda d: fk.kahn_levels_csr(adj, active, d)),
        (dk.kahn_frontier(a, st, act),
         lambda d: fk.kahn_frontier_csr(adj, status, active, d)),
    ]
    for dense, twin in pairs:
        on_card = twin(cuda)
        assert np.array_equal(dense.cpu().numpy(), on_card)
        assert np.array_equal(on_card, twin("cpu"))
    labels, level = dk.scc_condense(a, act)
    for x, y, z in zip((labels, level), fk.scc_condense_csr(adj, active, cuda),
                       fk.scc_condense_csr(adj, active, "cpu")):
        assert np.array_equal(x.cpu().numpy(), y) and np.array_equal(y, z)


def test_two_gloo_ranks_on_the_card_equal_single_card(cuda):
    """The sharded step (three batches) and the store-sharded consult (one
    store per rank) in two ranks over gloo on the one card: equal to the
    single-card txn_step and consult, through K1/K2 in each rank (in the
    forms join_form picks)."""
    from cassandra_accord_tpu_torch.parallel import launch
    from cassandra_accord_tpu_torch.parallel import live_dryrun as ld
    fn, (st, bt) = entry(device=cuda)
    state_np = {k: v.copy() for k, v in gs.state_to_numpy(st).items()}
    batches, want = [], []
    for step in range(3):
        shift = torch.tensor([0, 0, 64 * step, 0, 0], dtype=torch.int32,
                             device=cuda)
        b = bt._replace(slots=bt.slots + 64 * step, txn_id=bt.txn_id + shift)
        batches.append({k: v.cpu().numpy() for k, v in b._asdict().items()})
        ts_pre = st.ts.clone()
        st, deps, applied = fn(st, b)
        want.append((dk.max_conflict_ts(ts_pre, deps)[0].cpu().numpy(),
                     applied.cpu().numpy()))
    rng = np.random.default_rng(3)
    t, k, b = 256, 32, 16
    stores = ((rng.random((2, t, k)) < 0.1).astype(np.int8),
              (rng.random((2, t, k)) < 0.1).astype(np.int8),
              rng.integers(0, 99, (2, t, 5)).astype(np.int32),
              rng.integers(0, 99, (2, t, 5)).astype(np.int32),
              rng.integers(0, 6, (2, t)).astype(np.int8),
              rng.integers(0, 7, (2, t)).astype(np.int8),
              rng.random((2, t)) < 0.9,
              (rng.random((2, b, k)) < 0.1).astype(np.int8),
              rng.integers(0, 99, (2, b, 5)).astype(np.int32),
              rng.integers(0, 6, (2, b)).astype(np.int8))
    calls = [(launch.steps_rank, (state_np, batches)),
             (launch.store_consult_rank, (stores,))]
    res = launch.run_ranks(2, launch.sequence, (calls,), device=cuda,
                           backend="gloo", timeout_s=120)
    for r in res:
        steps = r.value[0]
        for i, (cmax, applied) in enumerate(want):
            assert np.array_equal(steps["conflict_max"][i], cmax)
            assert np.array_equal(steps["applied"][i], applied)
        n = r.launches
        assert sum(n[f"deps_join{f}"] for f in ("", "_dense", "_dense_tk")) == 4
        assert sum(n[f"max_conflict{f}"]
                   for f in ("", "_dense", "_dense_tk")) == 1
    full = gs.state_to_numpy(st)
    rows = full["key_inc"].shape[0] // 2
    for i, r in enumerate(res):
        local = r.value[0]["state"]
        for name in full:
            if name == "adj":
                got = np.zeros(local["adj_shape"], np.int8)
                got[tuple(local["adj_index"].T)] = local["adj_values"]
            else:
                got = local[name]
            assert np.array_equal(got, full[name][i * rows:(i + 1) * rows]), \
                name
    singles = [dk.consult(*(torch.from_numpy(x[s]).to(cuda) for x in stores))
               for s in range(2)]
    lanes = np.stack([m.cpu().numpy() for _, m in singles])
    for s, r in enumerate(res):
        cons = r.value[1]
        assert np.array_equal(cons["deps"][0], singles[s][0].cpu().numpy())
        assert np.array_equal(cons["max_lanes"][0], lanes[s])
        assert np.array_equal(cons["global_max"], res[0].value[1]["global_max"])
    best = ld.host_lex_max(lanes.transpose(1, 0, 2), np.ones((b, 2), bool))
    assert np.array_equal(res[0].value[1]["global_max"], best)


def test_calibrated_threshold_on_card_is_finite(cuda):
    """The shipped cost model's threshold, measured on the card: one consult
    round trip through K12 times the host tier's element rate."""
    import math
    from cassandra_accord_tpu_torch.impl import tpu_resolver
    got = tpu_resolver._calibrate_threshold(cuda)
    assert math.isfinite(got) and got >= 1e6
    assert tpu_resolver._CALIBRATED[str(cuda)] == got


def test_maelstrom_workload_on_card_equals_cpu(cuda, monkeypatch):
    """A 3-node, 20-op Maelstrom run with the device tier through the
    service: on the card (K12 launched, one launch a window, and no K1 or
    K2) equal to the same run on the CPU."""
    from cassandra_accord_tpu_torch.maelstrom.runner import run_workload
    for k, v in dict(ACCORD_RESOLVER="tpu", ACCORD_TPU_TIER="device",
                     ACCORD_TPU_WALK_MAX="0", ACCORD_TPU_WALK_WIDTH="0",
                     ACCORD_TPU_SERVICE="on").items():
        monkeypatch.setenv(k, v)
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setenv("ACCORD_DEVICE", dev)
        _kernels.reset_launches()
        out[dev] = run_workload(1, n_nodes=3, ops=20,
                                partition_interval_s=None)
        launches = dict(_kernels.LAUNCHES)
    assert out["cuda"] == out["cpu"]
    assert launches["fused_consult"] > 0
    assert launches["deps_join"] == 0 and launches["max_conflict"] == 0


def test_bench_kernel_on_card_equals_host_tier(cuda, monkeypatch):
    """bench_torch.py's kernel stage at its smallest size on the card: every
    batch's device answer (deps mask and max lanes) equals the host tier's
    on the same batch, or the stage raises."""
    monkeypatch.delenv("ACCORD_DEVICE", raising=False)
    out = bench_torch.bench_kernel(4096)
    assert out["answers_checked"] == 20 * 256
    assert out["device_queries_per_sec"] > 0


# ---------------------------------------------------------------------------
# K1d/K2d on the [T, K] index (csrc/dense_join_tk.cu)
# ---------------------------------------------------------------------------

# (T, K, B, keys per query row, one wide row's columns): every row of
# PERF.md's K1d/K2d table, then T and K tails
TK_CASES = {
    "config4": (65536, 2048, 64, 1024, 0),
    "wide_row": (65536, 512, 9, 2, 5000),
    "shape_A_graph_step_mesh_store": (65536, 512, 256, 2, 0),
    "mesh_rank": (16384, 512, 256, 2, 0),
    "six_key_replay_largest": (32768, 1024, 256, 2, 0),
    "wide_replay_largest": (8192, 8192, 256, 2, 0),
    "bench_phase_largest": (4096, 512, 256, 2, 0),
    "burn_verify_largest_and_window": (256, 16, 8, 2, 0),
    "cli_maelstrom_largest": (128, 16, 8, 1, 0),
    "T_tail_1003": (1003, 64, 13, 2, 0),
    "T_tail_one_slot": (2049, 64, 13, 2, 0),
    "T_below_one_warp": (20, 16, 5, 2, 0),
    "K_tail_80": (4096, 80, 33, 8, 0),
    "B_300_two_row_tiles": (2048, 64, 300, 6, 0),
}


def _tk_inputs(t, k, b, per_row, wide, device, seed):
    rng = np.random.default_rng(seed)
    inc = (rng.random((t, k)) < min(0.5, 4.0 / k)).astype(np.int8)
    live = inc.copy()
    live[rng.random((t, k)) < 0.2] = 0
    q = np.zeros((b, k), dtype=np.int8)
    for i in range(b):
        q[i, rng.choice(k, min(per_row, k), replace=False)] = 1
    if wide:
        q[0, rng.integers(0, k, wide)] = 1
    lanes = rng.integers(0, 50, (t, 5)).astype(np.int32)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    g = dict(inc=up(inc), live=up(live), q=up(q), txn_id=up(lanes),
             ts=up(lanes + rng.integers(0, 3, (t, 5)).astype(np.int32)),
             kind=up(rng.integers(0, 6, t).astype(np.int8)),
             status=up(rng.integers(0, 7, t).astype(np.int8)),
             active=up(rng.random(t) < 0.9),
             before=up(rng.integers(0, 50, (b, 5)).astype(np.int32)),
             qkind=up(rng.integers(0, 6, b).astype(np.int8)))
    tj = (g["live"], g["txn_id"], g["kind"], g["status"], g["active"],
          g["q"], g["before"], g["qkind"])
    tm = (g["inc"], g["ts"], g["txn_id"], g["active"], g["q"])
    return g, tj, tm


@pytest.mark.parametrize("case", sorted(TK_CASES))
def test_tk_kernels_equal_plain_and_kt_path(cuda, case):
    """K1d (bool and bit-packed) and K2d on [T, K], one launch each counted
    under the _tk names: equal to their plain versions and to the [K, T]
    CSR kernels on the transposed index and the CSR query."""
    t, k, b, per_row, wide = TK_CASES[case]
    g, tj, tm = _tk_inputs(t, k, b, per_row, wide, cuda, seed=t + k + b)
    offsets, cols, _vals = dk.query_csr(g["q"])
    kj = (dk.incidence_T(g["live"]), g["txn_id"], g["kind"], g["status"],
          g["active"], offsets, cols, g["before"], g["qkind"])
    km = (dk.incidence_T(g["inc"]), g["ts"], g["txn_id"], g["active"],
          offsets, cols)
    packs = (False, True) if t % 8 == 0 else (False,)
    before = dict(_kernels.LAUNCHES)
    for pk in packs:
        got = _kernels.deps_join_tk(*tj, packed=pk)
        assert torch.equal(got, _kernels.deps_join_tk_plain(*tj, packed=pk))
        assert torch.equal(got, _kernels.deps_join(*kj, packed=pk))
    got = _kernels.max_conflict_tk(*tm)
    assert torch.equal(got, _kernels.max_conflict_tk_plain(*tm))
    assert torch.equal(got, _kernels.max_conflict(*km))
    torch.cuda.synchronize()
    after = dict(_kernels.LAUNCHES)
    assert after["deps_join_dense_tk"] == before["deps_join_dense_tk"] + len(packs)
    assert after["max_conflict_dense_tk"] == before["max_conflict_dense_tk"] + 1


def test_tk_kernels_refuse_what_their_tensor_maps_cannot_take(cuda):
    """K % 16 != 0 and a query one byte off 16-byte alignment: the [T, K]
    wrappers raise and launch nothing; the one-shot consult by the rule
    takes the CSR route with the plain answer."""
    g, tj, tm = _tk_inputs(256, 72, 8, 4, 0, cuda, seed=72)
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError):
        _kernels.deps_join_tk(*tj)
    with pytest.raises(ValueError):
        _kernels.max_conflict_tk(*tm)
    g2, tj2, tm2 = _tk_inputs(256, 64, 8, 4, 0, cuda, seed=64)
    flat = torch.empty(g2["q"].numel() + 1, dtype=torch.int8, device=cuda)
    shifted = flat[1:].view(g2["q"].shape)
    shifted.copy_(tj2[5])
    with pytest.raises(ValueError):
        _kernels.deps_join_tk(*tj2[:5], shifted, *tj2[6:])
    assert _kernels.LAUNCHES == before
    args = (g["live"], g["inc"], g["ts"], g["txn_id"], g["kind"],
            g["status"], g["active"], g["q"], g["before"], g["qkind"])
    assert _kernels.tk_refusal(72) is not None
    got = dk.consult(*args)
    want = dk.consult(*(a.cpu() for a in args))
    for a, w in zip(got, want):
        assert torch.equal(a.cpu(), w)


def test_one_shot_consult_captures_in_a_cuda_graph(cuda):
    """consult_packed at a config-4-like shape (64 rows of 1,024 of 2,048
    keys) on the [T, K] route reads nothing back from the card, so it
    captures into a CUDA graph; replays equal the eager answer and the CPU's
    after the inputs change in place."""
    t, k, b = 8192, 2048, 64
    g, _tj, _tm = _tk_inputs(t, k, b, 1024, 0, cuda, seed=4)
    args = (g["live"], g["inc"], g["ts"], g["txn_id"], g["kind"],
            g["status"], g["active"], g["q"], g["before"], g["qkind"])
    assert _kernels.tk_refusal(k) is None
    eager = dk.consult_packed(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dk.consult_packed(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(_kernels.LAUNCHES)
    with torch.cuda.graph(graph):
        out = dk.consult_packed(*args)
    assert _kernels.LAUNCHES["deps_join_dense_tk"] == before["deps_join_dense_tk"] + 1
    assert _kernels.LAUNCHES["max_conflict_dense_tk"] == before["max_conflict_dense_tk"] + 1
    graph.replay()
    torch.cuda.synchronize()
    for a, w in zip(out, eager):
        assert torch.equal(a, w)
    g["q"].copy_(torch.roll(g["q"], 1, dims=0))          # new rows, in place
    graph.replay()
    torch.cuda.synchronize()
    want = dk.consult_packed(*(a.cpu() for a in args))
    for a, w in zip(out, want):
        assert torch.equal(a.cpu(), w)


# ---------------------------------------------------------------------------
# K1d/K2d on the [K, T] index (csrc/dense_join.cu): one pass for up to 256
# query rows, at the edge shapes; and the parity inputs in every form
# ---------------------------------------------------------------------------

# (T, K, B, keys per row): T not a multiple of 128 (1,040), a K tail (80),
# and B across the tile sizes (16, 64, 128, 256 rows) and past one tile
KT_EDGE = {
    "T1040": (1040, 64, 13, 24),
    "K80": (4096, 80, 33, 40),
    "B1": (2048, 128, 1, 64),
    "B63": (2048, 128, 63, 64),
    "B65": (2048, 128, 65, 64),
    "B255": (2048, 256, 255, 96),
    "B256": (4096, 512, 256, 200),
    "B300_two_passes": (2048, 128, 300, 64),
}

ODD_KINDS = (-1, -6, -7, -128, 9, 100, 127)


def _odd_kinds(g, rng):
    """Half the index's and the query's kind codes outside the table."""
    for name in ("kind", "qkind"):
        x = g[name].cpu().numpy().copy()
        odd = rng.random(x.size) < 0.5
        x[odd] = rng.choice(ODD_KINDS, int(odd.sum()))
        g[name] = torch.from_numpy(x).to(g[name].device)


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("case", sorted(KT_EDGE))
def test_kt_dense_at_the_edge_shapes(cuda, case, odd):
    """K1d (bool and bit-packed) and K2d on [K, T], forced, equal to the
    plain versions and to the CSR form, also with kind codes outside the
    witness table."""
    t, k, b, width = KT_EDGE[case]
    rng = np.random.default_rng(t + k + b)
    g = _inputs(rng, t, k, b, cuda, width=width)
    if odd:
        _odd_kinds(g, rng)
    args, margs = _args(g)
    before = dict(_kernels.LAUNCHES)
    for pk in (False, True):
        got = _kernels.deps_join_dense(*args, packed=pk)
        assert torch.equal(got, _kernels.deps_join_plain(*args, packed=pk))
        assert torch.equal(got, _kernels.deps_join(*args, packed=pk))
    got = _kernels.max_conflict_dense(*margs)
    assert torch.equal(got, _kernels.max_conflict_plain(*margs))
    torch.cuda.synchronize()
    after = dict(_kernels.LAUNCHES)
    assert after["deps_join_dense"] == before["deps_join_dense"] + 2
    assert after["max_conflict_dense"] == before["max_conflict_dense"] + 1


def _signed_tk(t, k, b, device, seed):
    """[T, K] index and [B, K] query of int8 values -2..2 (mostly 0) with
    -128 and 127 mixed in, so that sums of every sign occur."""
    rng = np.random.default_rng(seed)

    def signed(shape, p):
        x = rng.integers(-2, 3, shape) * (rng.random(shape) < p)
        ext = rng.random(shape) < 0.01
        x[ext] = rng.choice([-128, 127], int(ext.sum()))
        return torch.from_numpy(x.astype(np.int8)).to(device)
    g, _tj, _tm = _tk_inputs(t, k, b, 2, 0, device, seed)
    g.update(inc=signed((t, k), 0.3), q=signed((b, k), 0.2))
    g["live"] = g["inc"] * (torch.rand((t, k), device=device) < 0.8)
    _odd_kinds(g, rng)
    return g


@pytest.mark.parametrize("k", [64, 512])
def test_tk_kernels_with_signed_bytes_equal_plain(cuda, k):
    """K1d/K2d on [T, K] (s8 x s8 products) on signed bytes and kinds
    outside the table: equal to the plain versions' exact sums."""
    g = _signed_tk(4096, k, 33, cuda, seed=k)
    tj = (g["live"], g["txn_id"], g["kind"], g["status"], g["active"],
          g["q"], g["before"], g["qkind"])
    tm = (g["inc"], g["ts"], g["txn_id"], g["active"], g["q"])
    for pk in (False, True):
        assert torch.equal(_kernels.deps_join_tk(*tj, packed=pk),
                           _kernels.deps_join_tk_plain(*tj, packed=pk))
    assert torch.equal(_kernels.max_conflict_tk(*tm),
                       _kernels.max_conflict_tk_plain(*tm))


@pytest.mark.parametrize("t", [1024, 4104])
def test_csr_kernels_with_signed_values_equal_plain(cuda, t):
    """K1/K2 with the query's values beside its columns (the [T, K]
    callers' CSR route; at K = 72 the consult takes it by the rule):
    equal to the plain versions and to the [T, K] kernels' plain versions,
    and the one-shot consult on the card equals the CPU's."""
    k = 72
    g = _signed_tk(t, k, 21, cuda, seed=t)
    offsets, cols, vals = dk.query_csr(g["q"])
    kj = (dk.incidence_T(g["live"]), g["txn_id"], g["kind"], g["status"],
          g["active"], offsets, cols, g["before"], g["qkind"])
    km = (dk.incidence_T(g["inc"]), g["ts"], g["txn_id"], g["active"],
          offsets, cols)
    for pk in ((False, True) if t % 8 == 0 else (False,)):
        got = _kernels.deps_join(*kj, packed=pk, vals=vals)
        assert torch.equal(got, _kernels.deps_join_plain(*kj, packed=pk,
                                                         vals=vals))
    got = _kernels.max_conflict(*km, vals=vals)
    assert torch.equal(got, _kernels.max_conflict_plain(*km, vals=vals))
    args = (g["live"], g["inc"], g["ts"], g["txn_id"], g["kind"],
            g["status"], g["active"], g["q"], g["before"], g["qkind"])
    before = dict(_kernels.LAUNCHES)
    got = dk.consult(*args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["deps_join"] == before["deps_join"] + 1
    assert _kernels.LAUNCHES["max_conflict"] == before["max_conflict"] + 1
    for a, w in zip(got, dk.consult(*(x.cpu() for x in args))):
        assert torch.equal(a.cpu(), w)


def test_negative_kinds_in_every_k1_form_equal_plain(cuda):
    """Kind codes -1, -6, -7, -128 and codes past the table in K1 (CSR),
    K1d on [K, T] and K1d on [T, K], each equal to the plain versions."""
    t, k, b = 4096, 64, 33
    rng = np.random.default_rng(11)
    g = _inputs(rng, t, k, b, cuda, width=40)
    _odd_kinds(g, rng)
    args, _margs = _args(g)
    want = _kernels.deps_join_plain(*args)
    for k1 in (_kernels.deps_join, _kernels.deps_join_dense):
        assert torch.equal(k1(*args), want)
    q = _kernels.dense_query(g["offsets"], g["cols"], k).clamp(max=1) \
        .to(torch.int8)
    inc = g["inc"].t().contiguous().view(torch.int8)
    tj = (inc, g["txn_id"], g["kind"], g["status"], g["active"], q,
          g["before"], g["qkind"])
    assert torch.equal(_kernels.deps_join_tk(*tj), want)


# ---------------------------------------------------------------------------
# K12: both halves of the service's window in one launch (csrc/consult.cu)
# ---------------------------------------------------------------------------

def _fused_args(g, seed):
    """K12's arguments on _inputs' index (``live``) and a second index over
    the same slots (``key``: ``live`` and more)."""
    k, t = g["inc"].shape
    extra = np.random.default_rng(seed).random((k, t)) < 0.03
    key = g["inc"] | torch.from_numpy(extra.astype(np.uint8)).to(g["inc"].device)
    return (g["inc"], key, g["ts"], g["txn_id"], g["kind"], g["status"],
            g["active"], g["offsets"], g["cols"], g["before"], g["qkind"])


def _fused_halves(args, packed):
    live_T, key_T, ts, txn_id, kind, status, active, offsets, cols, before, \
        qkind = args
    return (_kernels.deps_join(live_T, txn_id, kind, status, active, offsets,
                               cols, before, qkind, packed=packed),
            _kernels.max_conflict(key_T, ts, txn_id, active, offsets, cols))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_consult_equals_plain_and_k1_k2(cuda, case):
    """K12 at every CASES shape, bool and bit-packed where T % 8 == 0, equal
    to its plain version and to K1 + K2 bit for bit, one launch a call."""
    t, k, b, kw = CASES[case]
    args = _fused_args(_inputs(np.random.default_rng(t), t, k, b, cuda, **kw),
                       t + 1)
    for packed in ((False, True) if t % 8 == 0 else (False,)):
        before = dict(_kernels.LAUNCHES)
        got = _kernels.fused_consult(*args, packed=packed)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["fused_consult"] == \
            before["fused_consult"] + 1
        want = _kernels.fused_consult_plain(*args, packed=packed)
        for a, w, h in zip(got, want, _fused_halves(args, packed)):
            assert torch.equal(a, w) and torch.equal(a, h)


@pytest.mark.parametrize("odd", [False, True])
def test_fused_consult_with_kinds_and_columns_outside_equals_plain(cuda, odd):
    """Kind codes outside the witness table (wrapped once, then clamped)
    and columns -7, -1, K and K + 100 in K12, against its plain version."""
    t, k, b = 2064, 32, 16
    g = _inputs(np.random.default_rng(17), t, k, b, cuda, width=6, oob=True)
    if odd:
        rng = np.random.default_rng(19)
        g["kind"] = torch.from_numpy(rng.choice(
            [-1, -6, -7, -128, 9, 100, 127, 0, 3], t).astype(np.int8)).to(cuda)
        g["qkind"] = torch.from_numpy(rng.choice(
            [-1, -7, 100, 1, 4], b).astype(np.int8)).to(cuda)
    args = _fused_args(g, 23)
    for packed in (False, True):
        got = _kernels.fused_consult(*args, packed=packed)
        for a, w in zip(got, _kernels.fused_consult_plain(*args, packed=packed)):
            assert torch.equal(a, w)


def test_fused_consult_replays_in_a_cuda_graph(cuda):
    """K12 with one block per row group and several (its counters' memset a
    node of the graph), captured in one CUDA graph: every replay's answers
    equal the plain version, the outputs overwritten before each replay."""
    sets = [_fused_args(_inputs(np.random.default_rng(t), t, 64, 21, cuda),
                        t) for t in (120, 256, 6147, 65536)]
    want = [_kernels.fused_consult_plain(*a) for a in sets]
    got = []

    def body():
        got[:] = [_kernels.fused_consult(*a) for a in sets]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for _ in range(3):
        for outs, wants in zip(got, want):
            for out, w in zip(outs, wants):
                out.copy_(torch.bitwise_not(w))
        graph.replay()
        torch.cuda.synchronize()
        for outs, wants in zip(got, want):
            for out, w in zip(outs, wants):
                assert torch.equal(out, w)


@pytest.mark.parametrize("packed", [False, True])
def test_service_window_is_one_fused_launch(cuda, packed):
    """The service's consult on the CSR form is one K12 launch (K1 and K2
    not launched) and one read-back equal to the plain versions; on the
    dense form it is K1d and K2d into the same one buffer."""
    for width, kernels in ((3, {"fused_consult"}),
                           (128, {"deps_join_dense", "max_conflict_dense"})):
        t, k, b = 8192, 256, 64
        g = _inputs(np.random.default_rng(width), t, k, b, cuda, width=width)
        args = _fused_args(g, 29)
        live_T, key_T, ts, txn_id, kind, status, active, offsets, cols, \
            before, qkind = args
        assert _kernels.join_form(b, t, k, cols.numel()) == \
            ("csr" if width == 3 else "dense")
        launched = dict(_kernels.LAUNCHES)
        deps, lanes = to_host(*ragged_consult_t(
            live_T, key_T, ts, txn_id, kind, status, active, cols, offsets,
            before, qkind, packed=packed))
        assert {n for n, v in _kernels.LAUNCHES.items()
                if v != launched[n]} == kernels
        assert all(_kernels.LAUNCHES[n] == launched[n] + 1 for n in kernels)
        want = _kernels.fused_consult_plain(*args, packed=packed)
        assert np.array_equal(deps, want[0].cpu().numpy())
        assert np.array_equal(lanes, want[1].cpu().numpy())


def _profiled(run, tmp_path):
    """``run()`` under a CPU and CUDA profile: the ``accord.*`` ranges of
    its Chrome trace, and its host sync points: the innermost host op of
    each synchronising runtime call (a synchronise, or a copy to pageable
    host memory; ``.item()`` makes a copy and a synchronise)."""
    import json
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    device = {(e.get("args") or {}).get("correlation"): e["name"]
              for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    spans, ops, points = {}, [], set()
    for e in events:
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if e.get("cat") == "user_annotation" \
                and e["name"].startswith("accord."):
            spans.setdefault(e["name"], []).append((a, b))
        elif e.get("cat") == "cpu_op":
            ops.append((a, b))
    for e in events:
        dev = device.get((e.get("args") or {}).get("correlation"), "")
        if e.get("cat") == "cuda_runtime" and (
                e["name"] in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                              "cudaEventSynchronize")
                or (e["name"].startswith("cudaMemcpy") and "DtoH" in dev
                    and "Pageable" in dev)):
            at = float(e["ts"])
            holding = [(a, b) for a, b in ops if a <= at <= b]
            points.add(min(holding, key=lambda r: r[1] - r[0])
                       if holding else (at, at))
    return spans, sorted(points)


def _in(spans, names, t):
    return any(a <= t <= b for n in names for a, b in spans.get(n, ()))



def test_service_window_spans_on_card(cuda, tmp_path):
    """A window at T = 32,768 (bit-packed answers) under the profiler: one
    dispatch holding the uploads, the launch, the read-back and the unpack;
    one refresh holding its row scatter; answers equal to the window run
    untraced."""
    from cassandra_accord_tpu_torch.config import LocalConfig
    from cassandra_accord_tpu_torch.device_service.service import \
        DeviceConsultService
    t, k = 32768, 64
    rng = np.random.default_rng(5)
    inc = (rng.random((t, k)) < 0.05).astype(np.int8)
    lanes = rng.integers(0, 50, (t, 5)).astype(np.int32)
    host = {"key_inc": inc, "live_inc": inc, "ts": lanes, "txn_id": lanes,
            "kind": rng.integers(0, 5, t).astype(np.int8),
            "status": rng.integers(1, 7, t).astype(np.int8),
            "active": rng.random(t) < 0.9}

    class Store:
        def __init__(self):
            self.h = {n: a.copy() for n, a in host.items()}
            self.dirty = set()
            self._max_slot, self._max_key_slot = t - 1, k - 1
            self.device_consults = 0
            self.config = LocalConfig.from_env(
                tpu_service="on", tpu_service_backend="torch", device="cuda")

        def host_index(self):
            return self.h

        def take_dirty_rows(self):
            d, self.dirty = self.dirty, set()
            return d

    consults = [(tuple(rng.choice(k, 2, replace=False).tolist()),
                 (0, 0, 40, 0, 0), 1) for _ in range(24)]

    def window(svc, store):
        store.h["status"][:9] = 2
        store.dirty.update(range(9))
        svc.begin_window()
        futs = [svc.submit(*c) for c in consults]
        out = [f.result() for f in futs]
        svc.end_window()
        return out

    answers = []
    for traced in (False, True):
        store = Store()
        svc = DeviceConsultService(store, config=store.config)
        window(svc, store)
        if traced:
            spans, _ = _profiled(
                lambda: answers.append(window(svc, store)), tmp_path)
        else:
            answers.append(window(svc, store))
    assert len(answers[0]) == len(answers[1]) == len(consults)
    for (deps0, max0), (deps1, max1) in zip(*answers):
        assert np.array_equal(deps0, deps1) and np.array_equal(max0, max1)
    count = {n: len(v) for n, v in spans.items()}
    assert count == {"accord.index.refresh": 1, "accord.index.apply_rows": 1,
                     "accord.service.build_batch": 1,
                     "accord.service.dispatch": 1,
                     "accord.service.upload": 1, "accord.kernel.consult": 1,
                     "accord.kernel.to_host": 1, "accord.service.unpack": 1}
    (d0, d1), = spans["accord.service.dispatch"]
    for part in ("accord.service.upload", "accord.kernel.consult",
                 "accord.kernel.to_host", "accord.service.unpack"):
        (a, b), = spans[part]
        assert d0 <= a and b <= d1, part


def test_service_windows_read_back_only_real_rows_on_card(cuda):
    """Windows of 1, 31, 33 and 64 consults at T = 32,768, so bit-packed:
    each answer equals ``fused_consult_plain`` over the window's pinned
    buffers, every padding row launched is counted in ``pad_rows_skipped``,
    and a later window leaves the answers of earlier ones as they were."""
    from cassandra_accord_tpu_torch.config import LocalConfig
    from cassandra_accord_tpu_torch.device_service.batch import (
        ROW_BUCKET_FLOOR, build_batch, pow2_bucket)
    from cassandra_accord_tpu_torch.device_service.service import \
        DeviceConsultService
    t, k = 32768, 64
    rng = np.random.default_rng(17)
    live = (rng.random((t, k)) < 0.05).astype(np.int8)
    lanes = rng.integers(0, 50, (t, 5)).astype(np.int32)
    host = {"key_inc": live | (rng.random((t, k)) < 0.03).astype(np.int8),
            "live_inc": live, "ts": lanes + rng.integers(0, 3, (t, 5))
            .astype(np.int32), "txn_id": lanes,
            "kind": rng.integers(0, 5, t).astype(np.int8),
            "status": rng.integers(1, 7, t).astype(np.int8),
            "active": rng.random(t) < 0.9}

    class Store:
        def __init__(self):
            self.h = {n: a.copy() for n, a in host.items()}
            self.dirty = set()
            self._max_slot, self._max_key_slot = t - 1, k - 1
            self.device_consults = 0
            self.config = LocalConfig.from_env(
                tpu_service="on", tpu_service_backend="torch", device="cuda")

        def host_index(self):
            return self.h

        def take_dirty_rows(self):
            d, self.dirty = self.dirty, set()
            return d

    store = Store()
    svc = DeviceConsultService(store, config=store.config)
    skipped, held = 0, []
    for n in (1, 31, 33, 64):
        consults = [(tuple(rng.choice(k, int(rng.integers(0, 4)),
                                      replace=False).tolist()),
                     tuple(rng.integers(0, 50, 5).tolist()),
                     int(rng.integers(0, 6))) for _ in range(n)]
        svc.begin_window()
        buffers = svc._window.buffers
        futs = [svc.submit(*c) for c in consults]
        got = [f.result() for f in futs]
        svc.end_window()
        batch = build_batch(*zip(*consults), row_cap=svc.max_window)
        cols, offsets, before, qkind = (
            torch.from_numpy(a).to(cuda) for a in (
                batch.flat_cols, batch.offsets, batch.before, batch.kind))
        want_deps, want_lanes = _kernels.fused_consult_plain(
            buffers["live_T"], buffers["key_T"], buffers["ts"],
            buffers["txn_id"], buffers["kind"], buffers["status"],
            buffers["active"], offsets, cols, before, qkind)
        deps = np.stack([d for d, _ in got])
        assert deps.dtype == np.bool_ and deps.shape == (n, t)
        assert np.array_equal(deps, want_deps[:n].cpu().numpy())
        assert np.array_equal(np.stack([m for _, m in got]),
                              want_lanes[:n].cpu().numpy())
        skipped += pow2_bucket(n, ROW_BUCKET_FLOOR, svc.max_window) - n
        assert svc.stats()["pad_rows_skipped"] == skipped
        held.append((got, [(d.copy(), m.copy()) for d, m in got]))
        for earlier, copies in held:
            for (d, m), (d0, m0) in zip(earlier, copies):
                assert np.array_equal(d, d0) and np.array_equal(m, m0)
        store.h["status"][:64] = rng.integers(1, 7, 64).astype(np.int8)
        store.dirty.update(range(64))
    assert skipped == 7 + 1 + 31 + 0
    assert all(shape[-1] for shape in svc.jit_shapes), "not bit-packed"


def _step_inputs(k, device):
    """A live state of T = 1,024 slots and K = ``k`` keys and a batch of 16
    on ``device``: K = 32 takes the join's [T, K] route, K = 40 its CSR
    route."""
    t, b = 1024, 16
    rng = np.random.default_rng(k)
    state = gs.init_state(t, k, device=device)
    state.key_inc[:] = torch.from_numpy(
        (rng.random((t, k)) < 0.2).astype(np.int8)).to(device)
    lanes = torch.from_numpy(rng.integers(1, 500, (t, 5)).astype(np.int32))
    state.txn_id[:] = lanes.to(device)
    state.ts[:] = lanes.to(device)
    state.status[:] = torch.from_numpy(
        rng.integers(1, 7, t).astype(np.int8)).to(device)
    state.active[:] = True
    state.adj[:] = torch.from_numpy(
        (rng.random((t, t)) < 0.01).astype(np.int8)).to(device)
    batch = cg.TxnBatch(
        slots=torch.from_numpy(rng.choice(t, b, replace=False)
                               .astype(np.int32)).to(device),
        key_inc=torch.from_numpy((rng.random((b, k)) < 0.15)
                                 .astype(np.int8)).to(device),
        txn_id=torch.from_numpy(rng.integers(500, 900, (b, 5))
                                .astype(np.int32)).to(device),
        kind=torch.from_numpy(rng.integers(0, 5, b).astype(np.int8))
        .to(device),
        valid=torch.ones(b, dtype=torch.bool, device=device))
    return state, batch


@pytest.mark.parametrize("k", [32, 40])
def test_step_syncs_are_the_sync_spans_on_card(cuda, k, tmp_path):
    """A ``txn_step`` on the card has no host sync point and opens no
    ``accord.sync.*`` span, on the [T, K] route (K = 32, which opens
    ``accord.kernel.join_tk``) and on the CSR route (K = 40); the
    ``gc_step`` after it syncs once, inside ``accord.sync.evict`` in
    ``accord.gc``."""
    state, batch = _step_inputs(k, cuda)
    watermark = torch.tensor([1000, 0, 0, 0, 0], dtype=torch.int32,
                             device=cuda)

    def step():
        s, _deps, _applied = cg.txn_step(state, batch)
        cg.gc_step(s, watermark)
    step()
    spans, points = _profiled(step, tmp_path)
    syncs = [n for n in spans if n.startswith("accord.sync.")]
    assert syncs == ["accord.sync.evict"]
    assert ("accord.kernel.join_tk" in spans) == (k == 32)
    assert len(spans["accord.step"]) == 1
    assert not [a for a, _ in points if _in(spans, ("accord.step",), a)]
    in_gc = [a for a, _ in points if _in(spans, ("accord.gc",), a)]
    assert in_gc and all(_in(spans, syncs, a) for a in in_gc)
    for a, b in spans["accord.sync.evict"]:
        assert any(a <= at <= b for at in in_gc)


def test_step_lex_max_span_is_one_kernel_on_card(cuda, tmp_path):
    """Inside ``accord.step.lex_max`` a ``txn_step`` launches one kernel,
    the lex max's (no torch op, so no [B, T] temporary)."""
    import json
    from torch.profiler import ProfilerActivity, profile
    state, batch = _step_inputs(32, cuda)
    cg.txn_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cg.txn_step(state, batch)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    kernels = {(e.get("args") or {}).get("correlation"): e["name"]
               for e in events if e.get("cat") in ("kernel", "gpu_memset",
                                                   "gpu_memcpy")}
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "accord.step.lex_max"]
    assert len(spans) == 1
    a, b = spans[0]
    inside = [kernels[c] for e in events if e.get("cat") == "cuda_runtime"
              and a <= float(e["ts"]) <= b
              and (c := (e.get("args") or {}).get("correlation")) in kernels]
    assert len(inside) == 1 and "lex_max_deps_kernel" in inside[0], inside


@pytest.mark.parametrize("k", [32, 40])
def test_txn_step_captures_in_a_cuda_graph(cuda, k):
    """``txn_step`` on either route of the join captures in a CUDA graph (a
    capture refuses any read-back, so this proves the step has none), and
    a replay from the same state gives the eager step's deps, applied set
    and state, bit for bit, with one ``write_rows`` launch for each of the
    witness and the stabilisation, one ``lex_max_deps`` launch and one
    ``frontier`` launch."""
    state, batch = _step_inputs(k, cuda)
    start = [x.clone() for x in state]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                      # warm-up, off capture
        cg.txn_step(state, batch)
    torch.cuda.current_stream().wait_stream(side)
    for x, x0 in zip(state, start):
        x.copy_(x0)
    graph = torch.cuda.CUDAGraph()
    before = dict(_kernels.LAUNCHES)
    with torch.cuda.graph(graph):
        _s, deps, applied = cg.txn_step(state, batch)
    assert _kernels.LAUNCHES["write_rows"] == before["write_rows"] + 2
    assert _kernels.LAUNCHES["frontier"] == before["frontier"] + 1
    assert _kernels.LAUNCHES["lex_max_deps"] == before["lex_max_deps"] + 1
    for x, x0 in zip(state, start):
        x.copy_(x0)
    graph.replay()
    torch.cuda.synchronize()
    got = (deps.clone(), applied.clone(), [x.clone() for x in state])
    for x, x0 in zip(state, start):
        x.copy_(x0)
    _s, want_deps, want_applied = cg.txn_step(state, batch)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want_deps) and torch.equal(got[1], want_applied)
    for name, x, y in zip(gs.GraphState._fields, got[2], state):
        assert torch.equal(x, y), name


# (B, T, where the inputs lie): the step's and the mesh rank's shapes, odd
# T (byte loads, a partial last tile), one row, more rows than the step's;
# "offset" puts deps one byte and ts four bytes past an aligned base
LEX_SHAPES = [(256, 65536, ""), (256, 16384, ""), (13, 1003, ""),
              (1, 4096, ""), (300, 2049, ""), (13, 4096, "offset")]


def _lex_on(a, device, offset):
    x = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if not offset:
        return x
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


@pytest.mark.parametrize("lanes", step_cases.LEX_LANES)
@pytest.mark.parametrize("shape", LEX_SHAPES)
def test_lex_max_deps_equals_plain(cuda, shape, lanes):
    """The lex max kernel (csrc/lex_max.cu) equals its plain version,
    ``lex_max_masked`` and ``any``, bit for bit, one launch a call: rows
    all-false, all-true and of densities 0.001, 0.05 and 0.9 (each row kind
    at every row index across the calls), lanes over the whole int32 range
    with -1, -2, 0 and MAXL, ties on the first three lanes, or slots that
    all agree on the first two."""
    b, t, where = shape
    for start in range(len(step_cases.LEX_ROWS)):
        ts_np, deps_np = step_cases.lex_case(lanes, b, t, start, seed=start)
        ts = _lex_on(ts_np, cuda, where)
        deps = _lex_on(deps_np, cuda, where)
        before = _kernels.LAUNCHES["lex_max_deps"]
        got = _kernels.lex_max_deps(ts, deps)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["lex_max_deps"] == before + 1
        want = _kernels.lex_max_deps_plain(ts, deps)
        for a, c in zip(got, want):
            assert a.dtype == c.dtype and torch.equal(a, c), (start, a, c)


def _write_fields(fields, bt, deps, device):
    up = {f: torch.from_numpy(np.ascontiguousarray(v)).to(device)
          for f, v in bt.items()}
    return (gs.state_from_numpy(fields, device=device), up,
            torch.from_numpy(deps).to(device))


@pytest.mark.parametrize("t", [61, 4096])
@pytest.mark.parametrize("case", sorted(step_cases.WRITE_CASES))
def test_write_rows_kernel_equals_plain_and_last_rows(cuda, case, t):
    """``write_rows`` on the card, the witness's fields (key row, lanes,
    kind, status, adjacency row, active) and then the stabilisation's
    (executeAt, status), equal its plain version on the CPU (the winners
    of ``last_rows``' rule, one ``put_rows`` a field): a slot named twice,
    wrapped slots, slots
    outside [-T, T), padding rows at T-1 after a valid row aimed there and
    before one, all padding, B = 1, 300 rows with collisions; T = 61 takes
    the byte copies, T = 4,096 the 16-byte ones."""
    fields, bt, deps, exec_at = step_cases.write_case(case, t)
    states = []
    for device, write in ((cuda, _kernels.write_rows),
                          ("cpu", _kernels.write_rows_plain)):
        state, b, d = _write_fields(fields, bt, deps, device)
        write(state, b["slots"], b["valid"], key_inc=b["key_inc"],
              ts=b["txn_id"], txn_id=b["txn_id"], kind=b["kind"],
              status=gs.PREACCEPTED, adj=d, active=True)
        # copies: a CPU state's numpy arrays are views of its tensors
        states.append({f: v.copy()
                       for f, v in gs.state_to_numpy(state).items()})
        write(state, b["slots"], b["valid"],
              ts=torch.from_numpy(exec_at).to(device), status=gs.STABLE)
        states.append(gs.state_to_numpy(state))
    for f in gs.GraphState._fields:
        for i in (0, 1):
            assert np.array_equal(states[i][f], states[2 + i][f]), (i, f)


@pytest.mark.parametrize("t", [61, 4100, 4096])
@pytest.mark.parametrize("case", sorted(step_cases.FRONTIER_CASES))
def test_frontier_kernel_equals_plain(cuda, case, t):
    """``kahn_frontier`` on the card (one ``frontier`` launch) equals its
    plain torch form on the CPU: no ready row, every row ready, a row
    blocked only by the last column, inactive and INVALIDATED
    dependencies, signed bytes; T = 61 and 4,100 are no multiple of the
    kernel's 16-byte loads, T = 4,096 is."""
    adj, status, active = step_cases.frontier_case(case, t)
    before = _kernels.LAUNCHES["frontier"]
    got = dk.kahn_frontier(*(torch.from_numpy(x).to(cuda)
                             for x in (adj, status, active)))
    want = dk.kahn_frontier(*(torch.from_numpy(x)
                              for x in (adj, status, active)))
    assert torch.equal(got.cpu(), want)
    assert _kernels.LAUNCHES["frontier"] == before + 1
    # as bool rows, and through the wrapper on rows wider than they are many
    ready = torch.from_numpy(active).to(cuda)
    blocked = torch.from_numpy(status != gs.APPLIED).to(cuda)
    wide = torch.from_numpy(adj[: t // 2]).to(cuda)
    assert torch.equal(
        _kernels.frontier_rows(wide, blocked, ready[: t // 2].clone()).cpu(),
        _kernels.frontier_rows_plain(wide.cpu(), blocked.cpu(),
                                     ready[: t // 2].cpu()))
    assert torch.equal(
        dk.kahn_frontier(torch.from_numpy(adj != 0).to(cuda),
                         *(torch.from_numpy(x).to(cuda)
                           for x in (status, active))).cpu(),
        dk.kahn_frontier(torch.from_numpy(adj != 0),
                         *(torch.from_numpy(x) for x in (status, active))))


@pytest.mark.parametrize("k", [40, 1000])
@pytest.mark.parametrize("case", sorted(step_cases.CSR_CASES))
def test_query_csr_on_card_equals_nonzero_csr(cuda, case, k):
    """The fixed-capacity CSR query built on the card (no read-back) holds
    the ``nonzero``-built one, and K1's and K2's CSR kernels answer the
    same from both and as their plain versions: rows with no key, no key
    at all, a row with all K keys, signed values."""
    b, t = 17, 4104
    q = torch.from_numpy(step_cases.csr_query(case, b, k)).to(cuda)
    offsets, cols, vals = dk.query_csr(q)
    want = step_cases.nonzero_csr(q)
    n = int(want[0][-1])
    assert torch.equal(offsets, want[0]) and cols.shape == (b * k,)
    assert torch.equal(cols[:n], want[1]) and torch.equal(vals[:n], want[2])
    rng = np.random.default_rng(k)
    inc = torch.from_numpy(rng.integers(-2, 3, (t, k)).astype(np.int8))
    lanes = torch.from_numpy(rng.integers(0, 40, (t, 5)).astype(np.int32))
    g = dict(inc_T=dk.incidence_T(inc), txn_id=lanes, ts=lanes + 1,
             kind=torch.from_numpy(rng.integers(0, 6, t).astype(np.int8)),
             status=torch.from_numpy(rng.integers(0, 7, t).astype(np.int8)),
             active=torch.from_numpy(rng.random(t) < 0.9),
             before=torch.from_numpy(rng.integers(0, 40, (b, 5))
                                     .astype(np.int32)),
             qkind=torch.from_numpy(rng.integers(0, 6, b).astype(np.int8)))
    answers = []
    for dev, csr in ((cuda, (offsets, cols, vals)), (cuda, want),
                     ("cpu", tuple(x.cpu() for x in want))):
        x = {n_: v.to(dev) for n_, v in g.items()}
        off, c, v = csr
        answers.append([
            _kernels.deps_join(x["inc_T"], x["txn_id"], x["kind"],
                               x["status"], x["active"], off, c, x["before"],
                               x["qkind"], vals=v).cpu(),
            _kernels.max_conflict(x["inc_T"], x["ts"], x["txn_id"],
                                  x["active"], off, c,
                                  vals=v).cpu()])
    for got in answers[1:]:
        assert torch.equal(answers[0][0], got[0])
        assert torch.equal(answers[0][1], got[1])
