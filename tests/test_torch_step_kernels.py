"""The conflict-graph step's sync-free forms on the CPU, against the JAX
reference and against the forms they replaced.

``_kernels.write_rows`` (a batch's winning rows, written in place),
``_kernels.frontier_rows`` (the ready rows' test, through
``deps_kernels.kahn_frontier``) and ``deps_kernels.query_csr`` (the join's
CSR query at a fixed capacity): on the CPU each runs its plain version,
which these tests hold to the reference's step, frontier and join and to
the ``nonzero``-built CSR.
The kernels themselves are held to the same plain versions on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cassandra_accord_tpu.models import conflict_graph as ref_cg
from cassandra_accord_tpu.ops import deps_kernels as ref_dk
from cassandra_accord_tpu.ops import graph_state as ref_gs

from cassandra_accord_tpu_torch.models import conflict_graph as cg
from cassandra_accord_tpu_torch.ops import _kernels
from cassandra_accord_tpu_torch.ops import deps_kernels as dk
from cassandra_accord_tpu_torch.ops import graph_state as gs

import step_cases


def _port(fields):
    return gs.state_from_numpy(fields, device="cpu")


def _ref(fields):
    return ref_gs.GraphState(**{f: jnp.asarray(v) for f, v in fields.items()})


def _same_state(port, fields):
    """``port`` (a GraphState) equals ``fields`` (a GraphState of JAX or
    torch arrays, or numpy arrays by name) field for field, dtype too."""
    got = gs.state_to_numpy(port)
    if not isinstance(fields, dict):
        fields = {f: np.asarray(getattr(fields, f)) for f in fields._fields}
    for f in gs.GraphState._fields:
        want = np.asarray(fields[f])
        assert got[f].dtype == want.dtype and np.array_equal(got[f], want), f


@pytest.mark.parametrize("t", [61, 256])
@pytest.mark.parametrize("case", list(step_cases.WRITE_CASES))
def test_write_rows_equals_reference_and_last_rows(case, t):
    """The witness's and the stabilisation's writes (``preaccept_step``,
    ``stabilise_step``: ``write_rows`` on the CPU, whose plain form is
    ``last_rows``' rule and one ``put_rows`` a field) equal the reference's
    steps, for a slot named twice, wrapped slots, slots outside [-T, T),
    padding rows at T-1 after a valid row aimed there (not inserted) and
    before one (inserted), an all-padding batch, B = 1 and 300 rows with
    collisions."""
    fields, bt, deps, exec_at = step_cases.write_case(case, t)
    batch = cg.TxnBatch(**{f: torch.from_numpy(v) for f, v in bt.items()})
    ref_batch = ref_cg.TxnBatch(**{f: jnp.asarray(v) for f, v in bt.items()})
    got = cg.preaccept_step(_port(fields), batch)
    want = ref_cg.preaccept_step(_ref(fields), ref_batch)
    _same_state(got[0], want[0])

    args = (bt["slots"], exec_at, bt["valid"])
    got = cg.stabilise_step(_port(fields), *(torch.from_numpy(a) for a in args))
    want = ref_cg.stabilise_step(_ref(fields), *(jnp.asarray(a) for a in args))
    _same_state(got, want)


@pytest.mark.parametrize("t", [61, 256])
@pytest.mark.parametrize("case", list(step_cases.FRONTIER_CASES))
def test_kahn_frontier_equals_reference(case, t):
    """``kahn_frontier`` through ``frontier_rows``' plain version equals
    the reference's product over every row: no ready row, every row
    ready, a row blocked only by the last column, dependencies inactive or
    INVALIDATED, and signed adjacency bytes (the reference's sum > 0)."""
    adj, status, active = step_cases.frontier_case(case, t)
    got = dk.kahn_frontier(*(torch.from_numpy(x) for x in (adj, status,
                                                           active)))
    want = ref_dk.kahn_frontier(*(jnp.asarray(x) for x in (adj, status,
                                                           active)))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))
    if case == "every_row_ready":
        assert got.all()
    if case == "no_ready_row":
        assert not got.any()
    if case == "blocked_only_by_last_column":
        assert got.nonzero().squeeze(1).tolist() == [t - 1]


@pytest.mark.parametrize("k", [40, 1000])
@pytest.mark.parametrize("case", list(step_cases.CSR_CASES))
def test_query_csr_equals_nonzero_csr(case, k):
    """The fixed-capacity CSR query holds the ``nonzero``-built one as its
    first offsets[B] entries (zeros after, B*K in all), and K1's and K2's
    plain versions answer the same from both, and as the reference's join
    and max over the [T, K] index: rows with no key, no key at all, a row
    with all K keys, signed values."""
    b, t = 17, 96
    q = torch.from_numpy(step_cases.csr_query(case, b, k))
    offsets, cols, vals = dk.query_csr(q)
    want = step_cases.nonzero_csr(q)
    n = int(want[0][-1])
    assert torch.equal(offsets, want[0])
    assert cols.shape == vals.shape == (b * k,)
    assert cols.dtype == torch.int32 and vals.dtype == torch.int8
    assert torch.equal(cols[:n], want[1]) and torch.equal(vals[:n], want[2])
    assert not cols[n:].any() and not vals[n:].any()

    rng = np.random.default_rng(k)
    inc = rng.integers(-2, 3, (t, k)).astype(np.int8)
    lanes = rng.integers(0, 40, (t, 5)).astype(np.int32)
    kind = rng.integers(0, 6, t).astype(np.int8)
    status = rng.integers(0, 7, t).astype(np.int8)
    active = rng.random(t) < 0.9
    before = rng.integers(0, 40, (b, 5)).astype(np.int32)
    qkind = rng.integers(0, 6, b).astype(np.int8)
    tt = {n_: torch.from_numpy(v) for n_, v in dict(
        inc=inc, lanes=lanes, kind=kind, status=status, active=active,
        before=before, qkind=qkind).items()}
    inc_t = dk.incidence_T(tt["inc"])
    answers = []
    for off, c, v in ((offsets, cols, vals), want):
        answers.append((
            _kernels.deps_join(inc_t, tt["lanes"], tt["kind"], tt["status"],
                               tt["active"], off, c, tt["before"],
                               tt["qkind"], vals=v),
            _kernels.max_conflict(inc_t, tt["lanes"] + 1, tt["lanes"],
                                  tt["active"], off, c, vals=v)))
    assert torch.equal(answers[0][0], answers[1][0])
    assert torch.equal(answers[0][1], answers[1][1])
    ref_deps = ref_dk.overlap_join(*(jnp.asarray(x) for x in (
        inc, lanes, kind, status, active, q.numpy(), before, qkind)))
    assert np.array_equal(answers[0][0].numpy(), np.asarray(ref_deps))
    ref_max = ref_dk.max_conflict_keys(*(jnp.asarray(x) for x in (
        inc, lanes + 1, lanes, active, q.numpy())))
    assert np.array_equal(answers[0][1].numpy(), np.asarray(ref_max))
