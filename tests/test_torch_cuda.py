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

from cassandra_accord_tpu_torch.entry import entry
from cassandra_accord_tpu_torch.models import conflict_graph as cg
from cassandra_accord_tpu_torch.ops import _kernels
from cassandra_accord_tpu_torch.ops import deps_kernels as dk
from cassandra_accord_tpu_torch.ops import frontier_kernels as fk
from cassandra_accord_tpu_torch.ops import graph_state as gs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(rng, t, k, b, device, width=3, wide=0, oob=False):
    """Random index and CSR query.  Rows take 0..``width`` keys; with
    ``wide`` row 0 takes that many columns (duplicates included), and with
    ``oob`` about a tenth of the columns fall outside [0, k)."""
    inc = (rng.random((k, t)) < 0.05).astype(np.uint8)
    lanes = rng.integers(0, 50, (t, 5)).astype(np.int32)
    ts = lanes + rng.integers(0, 3, (t, 5)).astype(np.int32)
    kind = rng.integers(0, 6, t).astype(np.int8)
    status = rng.integers(0, 7, t).astype(np.int8)
    active = rng.random(t) < 0.9
    lens = rng.integers(0, width + 1, b)
    if wide:
        lens[0] = wide
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = rng.integers(0, k, int(offsets[-1]) + 5).astype(np.int32)
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


# (t, k, b, keyword arguments of _inputs).  A block takes 8 query rows and
# up to 2,048 slots (fewer threads when T is below that); a block stages at
# most 4,096 query columns at a time.
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


def test_graph_replays_equal_plain(cuda):
    """K1 and K2, one tile and three, captured in one CUDA graph: every
    replay's answers equal the plain versions, with the outputs overwritten
    before each replay (a fold counter left over from an earlier replay
    would leave K2's output unwritten)."""
    sets = [_args(_inputs(np.random.default_rng(t), t, 64, 21, cuda))
            for t in (256, 6147)]
    want = [(_kernels.deps_join_plain(*a), _kernels.max_conflict_plain(*m))
            for a, m in sets]
    got = []

    def body():
        got[:] = [(_kernels.deps_join(*a), _kernels.max_conflict(*m))
                  for a, m in sets]
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
    step on the card."""
    fn, (st, bt) = entry(device=cuda)
    _, (st_c, bt_c) = entry(device="cpu")
    before = _kernels.LAUNCHES["deps_join"]
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
    assert _kernels.LAUNCHES["deps_join"] == before + 3


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
    single-card txn_step and consult, through K1/K2 in each rank."""
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
        assert r.launches == {"deps_join": 4, "max_conflict": 1}
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
