"""The port's ``accord.*`` spans (``observe/profiler.span``), on the CPU.

With no profiler recording, ``span`` is one shared no-op and no
``record_function`` runs.  Under ``torch.profiler`` each span is a
``user_annotation`` range in the Chrome trace: a service window records its
index and service spans once per refresh or dispatch, with the upload, the
launch, the read-back and the unpack inside the dispatch and the row scatter
inside the refresh; a ``txn_step`` records its phases and an
``accord.sync.*`` span at each host sync site of its route (``gc_step`` adds
the eviction's).  The answers are the same bit for bit with the profiler on
and off.
"""
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cassandra_accord_tpu_torch.config import LocalConfig
from cassandra_accord_tpu_torch.device_service.service import \
    DeviceConsultService
from cassandra_accord_tpu_torch.models import conflict_graph as cg
from cassandra_accord_tpu_torch.observe import profiler
from cassandra_accord_tpu_torch.ops import deps_kernels as dk
from cassandra_accord_tpu_torch.ops import graph_state as gs

PORT = Path(__file__).resolve().parent.parent / "cassandra_accord_tpu_torch"

SPANS = {
    "accord.step", "accord.step.witness", "accord.step.join",
    "accord.step.lex_max", "accord.step.stabilise", "accord.step.execute",
    "accord.gc",
    "accord.sync.query_csr", "accord.sync.bincount", "accord.sync.last_rows",
    "accord.sync.put_scalar", "accord.sync.frontier", "accord.sync.evict",
    "accord.index.refresh", "accord.index.apply_rows",
    "accord.index.full_upload",
    "accord.service.build_batch", "accord.service.dispatch",
    "accord.service.upload", "accord.service.unpack",
    "accord.kernel.consult", "accord.kernel.to_host", "accord.kernel.join_tk",
}
T, K = 256, 32


def _spans(run, tmp_path):
    """``run()`` under a CPU profile: its result and the ``accord.*``
    ranges of the Chrome trace, as {name: [(start, end)]}."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith("accord."):
            a = float(e["ts"])
            spans.setdefault(e["name"], []).append((a, a + float(e["dur"])))
    return out, spans


def _inside(spans, inner, outer):
    """Whether every ``inner`` range lies in some ``outer`` range."""
    return all(any(a <= x and y <= b for a, b in spans.get(outer, ()))
               for x, y in spans.get(inner, ()))


# -- a consult service over a host index of its own --------------------------

class _Store:
    """The surface the service reads of a resolver, over random host
    arrays: ``host_index()``, ``take_dirty_rows()``, the slot marks."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        self.rng = rng
        key_inc = (rng.random((T, K)) < 0.1).astype(np.int8)
        lanes = np.zeros((T, 5), np.int32)
        lanes[:, 0], lanes[:, 2] = 1, rng.permutation(T) + 10
        lanes[:, 4] = rng.integers(1, 5, T)
        self._h = {"key_inc": key_inc, "live_inc": key_inc.copy(),
                   "ts": lanes.copy(), "txn_id": lanes,
                   "kind": rng.choice([0, 1, 3, 4], T).astype(np.int8),
                   "status": rng.integers(1, 7, T).astype(np.int8),
                   "active": rng.random(T) < 0.8}
        self._dirty = set()
        self._max_slot, self._max_key_slot = T - 1, K - 1
        self.device_consults = 0
        self.config = LocalConfig.from_env(
            tpu_service="on", tpu_service_backend="torch", device="cpu")

    def host_index(self):
        return self._h

    def take_dirty_rows(self):
        d, self._dirty = self._dirty, set()
        return d

    def mutate(self, n):
        rows = self.rng.choice(T, n, replace=False)
        self._h["key_inc"][rows] = (self.rng.random((n, K)) < 0.1)
        self._h["live_inc"][rows] = self._h["key_inc"][rows]
        self._h["status"][rows] = self.rng.integers(1, 7, n)
        self._dirty.update(rows.tolist())

    def consults(self, n):
        return [(tuple(np.flatnonzero(self.rng.random(K) < 0.1).tolist()),
                 (1, 0, int(self.rng.integers(0, T + 20)), 0, 1),
                 int(self.rng.choice([0, 1, 3, 4]))) for _ in range(n)]


def _window(svc, submit):
    svc.begin_window()
    futs = [svc.submit(cols, before, kind) for cols, before, kind in submit]
    answers = [f.result() for f in futs]
    svc.end_window()
    return answers


def _service_run(seed, first_window, consults):
    """A service whose second window (or first, with ``first_window``)
    runs under the returned callable."""
    store = _Store(seed)
    svc = DeviceConsultService(store, config=store.config)
    if not first_window:
        _window(svc, store.consults(3))
        store.mutate(9)
    submit = store.consults(consults)
    return lambda: _window(svc, submit)


# -- a txn_step over a random state -------------------------------------------

def _step_run(seed, k, gc):
    """A live random state and batch at key width ``k``: the callable runs
    ``txn_step`` (then ``gc_step`` when ``gc``) and returns the outputs."""
    rng = np.random.default_rng(seed)
    b = 8
    active = rng.random(T) < 0.6
    lanes = np.zeros((T, 5), np.int32)
    lanes[:, 0], lanes[:, 2] = 1, rng.permutation(T) + 10
    lanes[:, 4] = rng.integers(1, 5, T)
    fields = dict(
        key_inc=((rng.random((T, k)) < 0.2) & active[:, None]).astype(np.int8),
        ts=lanes * active[:, None], txn_id=lanes * active[:, None],
        kind=rng.choice([0, 1, 3, 4], T).astype(np.int8) * active,
        status=rng.integers(1, 7, T).astype(np.int8) * active,
        adj=((rng.random((T, T)) < 0.05) & active[:, None]
             & active[None, :]).astype(np.int8),
        active=active)
    blanes = np.zeros((b, 5), np.int32)
    blanes[:, 0], blanes[:, 2] = 1, np.arange(b) + T + 100
    blanes[:, 4] = rng.integers(1, 5, b)
    batch = cg.TxnBatch(
        slots=torch.from_numpy(rng.choice(T, b, replace=False)
                               .astype(np.int32)),
        key_inc=torch.from_numpy((rng.random((b, k)) < 0.15)
                                 .astype(np.int8)),
        txn_id=torch.from_numpy(blanes),
        kind=torch.from_numpy(rng.choice([0, 1, 3, 4], b).astype(np.int8)),
        valid=torch.ones(b, dtype=torch.bool))
    watermark = torch.tensor([1, 0, T // 2, 0, 0], dtype=torch.int32)

    def run():
        state = gs.state_from_numpy(fields, device="cpu")
        state, deps, applied = cg.txn_step(state, batch)
        if gc:
            state = cg.gc_step(state, watermark)
        return gs.state_to_numpy(state), deps.numpy(), applied.numpy()
    return run, batch


@pytest.mark.parametrize("what", ["service", "step"])
def test_no_profiler_no_record_function(what, monkeypatch):
    """Without a profiler every span is the one shared no-op, and the whole
    window or step runs without calling ``record_function``."""
    assert profiler.span("accord.step") is profiler.span("accord.gc") \
        is profiler._NO_SPAN

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) ran untraced")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    run = _service_run(1, False, 5) if what == "service" \
        else _step_run(1, 40, True)[0]
    run()


@pytest.mark.parametrize("first_window,consults", [
    (True, 5), (False, 1), (False, 64), (False, 300)])
def test_service_window_spans(first_window, consults, tmp_path):
    """Each index and service span once per refresh or dispatch (a window
    of more than 256 consults dispatches twice), the parts inside the
    dispatch and the row scatter inside the refresh.  The CPU's answers
    come back unpacked, so no unpack runs here."""
    cap = LocalConfig().tpu_service_max_window
    chunks = math.ceil(consults / cap)
    _, spans = _spans(_service_run(2, first_window, consults), tmp_path)
    count = {n: len(v) for n, v in spans.items()}
    want = {"accord.index.refresh": 1,
            "accord.index.full_upload": int(first_window),
            "accord.index.apply_rows": int(not first_window),
            "accord.service.build_batch": chunks,
            "accord.service.dispatch": chunks,
            "accord.service.upload": chunks,
            "accord.kernel.consult": chunks,
            "accord.kernel.to_host": chunks}
    assert {n: c for n, c in count.items() if c} \
        == {n: c for n, c in want.items() if c}
    for part in ("accord.service.upload", "accord.kernel.consult",
                 "accord.kernel.to_host"):
        assert _inside(spans, part, "accord.service.dispatch"), part
    assert _inside(spans, "accord.index.apply_rows", "accord.index.refresh")
    assert _inside(spans, "accord.index.full_upload", "accord.index.refresh")


@pytest.mark.parametrize("k,gc", [(32, False), (32, True), (40, False),
                                  (40, True)])
def test_txn_step_spans_and_syncs(k, gc, tmp_path):
    """``accord.step`` once with each phase inside it, and an
    ``accord.sync.*`` span at each host sync site of the step's route: both
    ``last_rows`` selections, the three scalar writes (status and active
    in the witness, status in the stabilisation) and the frontier's rows,
    plus the CSR build's ``nonzero`` and ``bincount`` where the join takes
    the CSR route (K = 40), or ``accord.kernel.join_tk`` around the one
    launch where it takes the [T, K] kernels (K = 32); ``gc_step``
    adds ``accord.gc`` and its eviction's sync."""
    run, batch = _step_run(3, k, gc)
    inc = torch.zeros((T, k), dtype=torch.int8)
    csr = not dk._tk_dense("auto", inc, batch.key_inc)
    assert csr == (k == 40)
    _, spans = _spans(run, tmp_path)
    count = {n: len(v) for n, v in spans.items()}
    want = {"accord.step": 1, "accord.step.witness": 1,
            "accord.step.join": 1, "accord.step.lex_max": 1,
            "accord.step.stabilise": 1, "accord.step.execute": 1,
            "accord.sync.last_rows": 2, "accord.sync.put_scalar": 3,
            "accord.sync.frontier": 1, "accord.sync.query_csr": int(csr),
            "accord.sync.bincount": int(csr),
            "accord.kernel.join_tk": int(not csr),
            "accord.gc": int(gc), "accord.sync.evict": int(gc)}
    assert count == {n: c for n, c in want.items() if c}
    for phase in ("accord.step.witness", "accord.step.stabilise",
                  "accord.step.execute"):
        assert _inside(spans, phase, "accord.step"), phase
    for part in ("accord.step.join", "accord.step.lex_max"):
        assert _inside(spans, part, "accord.step.witness"), part
    assert _inside(spans, "accord.sync.query_csr", "accord.step.join")
    assert _inside(spans, "accord.sync.bincount", "accord.step.join")
    assert _inside(spans, "accord.kernel.join_tk", "accord.step.join")
    assert _inside(spans, "accord.sync.put_scalar", "accord.step")
    assert _inside(spans, "accord.sync.frontier", "accord.step.execute")
    assert _inside(spans, "accord.sync.last_rows", "accord.step")
    assert _inside(spans, "accord.sync.evict", "accord.gc")


@pytest.mark.parametrize("what", ["service", "step"])
def test_answers_equal_with_profiler_on_and_off(what, tmp_path):
    """The same window or step from the same seed, traced and not: equal
    answers and state, bit for bit."""
    def make():
        return _service_run(4, False, 40) if what == "service" \
            else _step_run(4, 40, True)[0]
    off = make()()
    on, spans = _spans(make(), tmp_path)
    assert spans
    if what == "service":
        assert len(on) == len(off)
        for (d1, m1), (d2, m2) in zip(on, off):
            assert np.array_equal(d1, d2) and d1.dtype == d2.dtype
            assert np.array_equal(m1, m2) and m1.dtype == m2.dtype
    else:
        (s1, d1, a1), (s2, d2, a2) = on, off
        assert s1.keys() == s2.keys()
        for f in s1:
            assert np.array_equal(s1[f], s2[f]) and s1[f].dtype == s2[f].dtype
        assert np.array_equal(d1, d2) and np.array_equal(a1, a2)


def test_span_names_in_the_port():
    """Every span the port opens is one of the ``accord.*`` names above, and
    each of those is opened somewhere."""
    found = set()
    for path in PORT.rglob("*.py"):
        found.update(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert found == SPANS
