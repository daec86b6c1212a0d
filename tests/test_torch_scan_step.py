"""The conflict-graph step under range traffic, as the benchmark's
``zipf-scan.step`` cell drives it (YCSB workload E: scans of contiguous keys
that read, single-key inserts that write), at a small size on the CPU.

The store and its batches come from the benchmark's own generator and key
distribution (``accord_bench/keys/ycsb_scan.py``, whose rows follow the
kinds the generator draws) at T = 256 and K = 32: a multiple of
16, so ``txn_step``'s join takes the [T, K] route, K1d_tk's plain version
here.  Every step's deps, executeAt and applied set, and the state after
it, equal the JAX package's ``txn_step`` bit for bit and the benchmark's
plain reference (``accord_bench/reference.py::StepReference``); the join on
the CSR route gives the same deps as the [T, K] route on every state.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cassandra_accord_tpu.models import conflict_graph as ref_cg
from cassandra_accord_tpu.ops import graph_state as ref_gs

from accord_bench import gen, named
from accord_bench.reference import StepReference
from cassandra_accord_tpu_torch.models import conflict_graph as cg
from cassandra_accord_tpu_torch.ops import _kernels
from cassandra_accord_tpu_torch.ops import deps_kernels as dk
from cassandra_accord_tpu_torch.ops import graph_state as gs

BENCH = Path(__file__).resolve().parent.parent / "accord_bench"
T, K, B = 256, 32, 8
# 28 records (24 loaded, 4 insert keys), scans of 1-8 of them, 5% inserts
CFG = {"txn_slots": T, "key_slots": K, "nodes": 5, "write_share": 0.05,
       "slow_share": 0.5,
       "keys": {"dist": "ycsb_scan", "items": 10 ** 10, "theta": 0.99,
                "zetan": 26.46902820178302, "records": 24, "chooser_items": 29,
                "scan_min": 1, "scan_max": 8}}
TRAFFIC = {"batch": B, "gc_every": 4, "gc_free": 32, "backlog": 3}
STEPS = 12


def _traffic(seed):
    keys = named.load(BENCH / "keys" / "ycsb_scan.py").Keys(CFG, seed)
    return gen.StepTraffic(CFG, TRAFFIC, seed, keys)


def _fields(ini):
    """The store before the first batch as GraphState fields (numpy), as
    the benchmark's step driver builds it."""
    slot = ini["slot"].astype(np.int64)
    f = {"key_inc": np.zeros((T, K), np.int8), "ts": np.zeros((T, 5), np.int32),
         "txn_id": np.zeros((T, 5), np.int32), "kind": np.zeros(T, np.int8),
         "status": np.zeros(T, np.int8), "adj": np.zeros((T, T), np.int8),
         "active": np.zeros(T, bool)}
    f["key_inc"][slot] = ini["keys"].incidence()
    for name in ("txn_id", "ts", "kind", "status"):
        f[name][slot] = ini[name]
    f["active"][slot] = True
    f["adj"][slot[ini["status"] == gen.STABLE]] = ini["deps"]
    return f


def _batch(ev):
    return dict(slots=ev["slot"], key_inc=ev["keys"].incidence(),
                txn_id=ev["txn_id"], kind=ev["kind"], valid=np.ones(B, bool))


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 17])
def test_scan_steps_equal_jax_and_reference(seed):
    traffic = _traffic(seed)
    ini = traffic.initial()
    fields = _fields(ini)
    port = gs.state_from_numpy(fields, device="cpu")
    jax_state = ref_gs.GraphState(**{f: jnp.asarray(v) for f, v in fields.items()})
    ref = StepReference(CFG, ini, B, "cpu")
    widths, kinds, gcs, applied_total, deps_total = set(), set(), 0, 0, 0
    for s in range(STEPS):
        ev = traffic.step(s)
        bt = _batch(ev)
        widths.update((bt["key_inc"] != 0).sum(axis=1).tolist())
        kinds.update(ev["kind"].tolist())
        assert _kernels.tk_refusal(port.key_inc.shape[1]) is None
        port, deps, applied = cg.txn_step(
            port, cg.TxnBatch(**{f: torch.from_numpy(np.ascontiguousarray(v))
                                 for f, v in bt.items()}))
        jax_state, j_deps, j_applied = ref_cg.txn_step(
            jax_state, ref_cg.TxnBatch(**{f: jnp.asarray(v) for f, v in bt.items()}))
        r_deps, r_exec, r_applied, _union, _tested = ref.step(
            ev["slot"], bt["key_inc"], ev["txn_id"], ev["kind"], ev["gc"])
        exec_at = port.ts[torch.from_numpy(ev["slot"]).long()]
        _equal(deps.numpy(), j_deps)
        _equal(applied.numpy(), j_applied)
        _equal(exec_at.numpy(), np.asarray(jax_state.ts)[ev["slot"]])
        _equal(deps.numpy(), r_deps.numpy())
        _equal(exec_at.numpy(), r_exec.numpy())
        _equal(applied.numpy(), r_applied.numpy())
        applied_total += int(applied.sum())
        deps_total += int(deps.sum())
        if ev["gc"] is not None:
            wm = ev["gc"]
            port = cg.gc_step(port, torch.from_numpy(wm))
            jax_state = ref_cg.gc_step(jax_state, jnp.asarray(wm))
            gcs += 1
        got = gs.state_to_numpy(port)
        for f in ref_gs.GraphState._fields:
            _equal(got[f], np.asarray(getattr(jax_state, f)))
    assert gcs == STEPS // TRAFFIC["gc_every"]
    assert kinds == {0, 1} and max(widths) > 1 and 1 in widths
    assert applied_total > 0 and deps_total > 0


@pytest.mark.parametrize("seed", [2 ** 31 + 9, 23])
def test_scan_join_routes_agree(seed):
    """``overlap_join`` down the CSR route (transpose, CSR query, K1; where
    a rule that refuses every shape sends it) and ``deps_join_tk`` give the
    deps of the [T, K] route on the store and after each step."""
    traffic = _traffic(seed)
    port = gs.state_from_numpy(_fields(traffic.initial()), device="cpu")
    for s in range(4):
        ev = traffic.step(s)
        bt = {f: torch.from_numpy(np.ascontiguousarray(v))
              for f, v in _batch(ev).items()}
        args = (port.key_inc, port.txn_id, port.kind, port.status, port.active,
                bt["key_inc"], bt["txn_id"], bt["kind"])
        tk = dk.overlap_join(*args)
        assert tk.any()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(_kernels, "tk_refusal", lambda k, *x: "the CSR route")
            _equal(dk.overlap_join(*args).numpy(), tk.numpy())
        _equal(_kernels.deps_join_tk(*args).numpy(), tk.numpy())
        port, _deps, _applied = cg.txn_step(port, cg.TxnBatch(**bt))
