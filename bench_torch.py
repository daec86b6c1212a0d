"""Benchmarks of the PyTorch/CUDA port: bench.py's stages on one NVIDIA card.

The stage-for-stage twin of ``bench.py``, driving ``cassandra_accord_tpu_torch``
instead of the JAX package.  It keeps bench.py's CLI, stage names, workload
constants and result object (``metric``/``value``/``unit``/``vs_baseline``,
``detail.stages``, ``detail.headline_tier``, ``detail.headline_T``), and its
stdout tail contract: the full-detail object, then as the LAST stdout line one
compact single-line JSON summary.

PRIMARY METRIC (protocol level, BASELINE.md's contention metric): commits/s of
the full simulated Accord cluster on a contended workload through the two
deps-resolver data planes behind the same protocol code: ``resolver=cpu`` (the
host cfk walk) and ``resolver=tpu`` (the device data plane; its tiers are
routed by the shipped cost model, which sends a consult to the card when its
B·T·K reaches the calibrated threshold).  The headline, as in bench.py, is the
consult replay's ``auto`` tier at the largest T against the walk.

Where it differs from bench.py:

- the card is resolved through ``cassandra_accord_tpu_torch.device``; without
  CUDA, unless the CPU is asked for (``ACCORD_DEVICE=cpu``), it exits non-zero
  before any stage runs.  There is no probe and no fallback to the CPU;
- a stage that raises, or a run killed by its alarm or SIGTERM, still prints
  the tail line (with the error) and then exits non-zero; a stage skipped at
  the deadline is recorded as bench.py records it;
- device times come from CUDA events, or a host clock that ends in a
  synchronise, after a warm-up; the consult kernels' answers (stages
  ``consult_service`` and ``kernel_scaling``) and the graph ops' answers are
  held against the host tier's (or the edge twins') on the same inputs, and
  a mismatch fails the stage;
- ``detail.device`` names the card (name, count and the power limit as
  ``nvidia-smi --query-gpu=name,power.limit`` gives them): every device
  number of the run was measured on it;
- the trend ledger is ``ACCORD_BENCH_HISTORY`` when set, else
  ``chiprun_out/bench_torch_history.jsonl``, never ``BENCH_HISTORY.jsonl``;
- importing this module changes nothing: bench.py's environment defaults
  (``ACCORD_TPU_TXN_SLOTS``/``KEY_SLOTS``/``WALK_MAX``) are set only when it
  runs as a script, and ``ACCORD_TPU_DISPATCH_ELEMS`` is never set.

Usage (from the repository root):

    python3 bench_torch.py                 # every stage, on the card
    python3 bench_torch.py --smoke         # the seconds-class smoke
    python3 bench_torch.py --gate          # smoke + regression gate
    python3 bench_torch.py --ramp          # the protocol ramp alone
    ACCORD_DEVICE=cpu python3 bench_torch.py --smoke    # on the CPU
"""
import json
import os
import signal
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_HISTORY = os.path.join(ROOT, "chiprun_out", "bench_torch_history.jsonl")

# bench.py sets these when it is imported (bench.py:37-39); here only the
# script's own run sets them (``__main__`` below)
BENCH_ENV = {"ACCORD_TPU_TXN_SLOTS": "1024", "ACCORD_TPU_KEY_SLOTS": "64",
             "ACCORD_TPU_WALK_MAX": "512"}   # tuned: cost-ladder knee
TPU_WINDOW_US = 5_000                        # tuned delivery window


# ---------------------------------------------------------------------------
# protocol-level: same seed + workload through both resolver data planes
# ---------------------------------------------------------------------------

PROTO_SEED = 7
# deep-contention config (the BASELINE.md config-3 shape: few keys, deep deps
# chains); durability=True: the durability rounds advance the majority
# watermarks that gate transitive elision, as real deployments do
PROTO_OPS = 1200
PROTO_CONC = 64
PROTO_KW = dict(nodes=3, rf=3, key_count=6, num_shards=1, durability=True)


def bench_protocol(resolver: str, batch_window_us: int, ops: int = PROTO_OPS,
                   reps: int = 2):
    from cassandra_accord_tpu_torch.harness.burn import run_burn
    best, res = 0.0, None
    for _ in range(reps):
        t0 = time.perf_counter()
        res = run_burn(seed=PROTO_SEED, ops=ops, concurrency=PROTO_CONC,
                       resolver=resolver, batch_window_us=batch_window_us,
                       **PROTO_KW)
        dt = time.perf_counter() - t0
        best = max(best, res.ops_ok / dt)
    return best, res


# ---------------------------------------------------------------------------
# protocol ramp: commits/s vs in-flight concurrency, columnar on vs off
# ---------------------------------------------------------------------------

RAMP_LEVELS = (8, 32, 128)
RAMP_OPS = 400


def bench_protocol_ramp(levels=RAMP_LEVELS, ops: int = RAMP_OPS):
    """commits/s against in-flight concurrency, the columnar protocol engine
    on and off, at each level of the fixed-seed contended workload.  Two
    rates per run: ``sim`` (commits per sim second: deterministic, equal on
    and off) and ``wall`` (commits per wall second: machine-dependent)."""
    from cassandra_accord_tpu_torch.harness.burn import run_burn
    out = {"levels": list(levels), "ops": ops, "seed": PROTO_SEED,
           "workload": dict(ops=ops, seed=PROTO_SEED, **PROTO_KW)}
    # warm the process first, and interleave the modes per level: a
    # mode-major order biases against whichever runs first
    run_burn(seed=PROTO_SEED, ops=40, concurrency=levels[0], **PROTO_KW)
    rates = {"on": {"wall": [], "sim": []}, "off": {"wall": [], "sim": []}}
    for conc in levels:
        for mode in ("on", "off"):
            t0 = time.perf_counter()
            res = run_burn(seed=PROTO_SEED, ops=ops, concurrency=conc,
                           columnar=mode, **PROTO_KW)
            dt = time.perf_counter() - t0
            rates[mode]["wall"].append(round(res.ops_ok / dt, 1)
                                       if dt else None)
            rates[mode]["sim"].append(
                round(res.ops_ok / (res.sim_micros / 1e6), 1)
                if res.sim_micros else None)
            if mode == "on":
                out["columnar_stats"] = {
                    k: v for k, v in res.stats.items()
                    if k.startswith("columnar_")}
    for mode in ("on", "off"):
        out[f"columnar_{mode}"] = {
            "commits_per_sec_wall": rates[mode]["wall"],
            "commits_per_sec_sim": rates[mode]["sim"]}
    on = out["columnar_on"]
    sim = on["commits_per_sec_sim"]
    wall = on["commits_per_sec_wall"]
    out["protocol_commits_per_sec"] = wall[-1]
    out["sim_ramp_scaling"] = round(sim[-1] / sim[0], 3) \
        if sim[0] and sim[-1] else None
    off_wall = out["columnar_off"]["commits_per_sec_wall"]
    out["columnar_wall_speedup"] = [
        round(a / b, 3) if a and b else None for a, b in zip(wall, off_wall)]
    return out


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def device():
    """The torch device of the device tier (``LocalConfig.device``: the card
    unless ``ACCORD_DEVICE=cpu``); raises when CUDA is named and missing."""
    from cassandra_accord_tpu_torch.config import LocalConfig
    from cassandra_accord_tpu_torch.device import resolve_device
    return resolve_device(LocalConfig.from_env().device)


def describe_device(dev) -> dict:
    """The card's name, count and power limit (nvidia-smi's line), or the
    CPU's entry when the CPU was asked for."""
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "count": 0,
                "nvidia_smi": None}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout
        line = next((x.strip() for x in smi.splitlines() if x.strip()), None)
    except (OSError, subprocess.SubprocessError):
        line = None
    return {"platform": "gpu", "name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "nvidia_smi": line or "nvidia-smi unavailable"}


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    """(``fn()``, seconds of its work): CUDA events around it on the card,
    after a synchronise, so queued launches are timed and not their enqueue;
    the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    import torch
    torch.cuda.synchronize(dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1) / 1e3


class AnswerMismatch(AssertionError):
    """A device answer differs from its reference on the same inputs: the
    host tier's for a consult, the edge twin's for a graph op."""


def _arrays(x):
    return [y.cpu().numpy() if hasattr(y, "cpu") else np.asarray(y)
            for y in (x if isinstance(x, tuple) else (x,))]


def _same(what: str, got, want) -> None:
    """Raise AnswerMismatch unless ``got`` equals ``want`` exactly (arrays,
    tensors, or tuples of them)."""
    got, want = _arrays(got), _arrays(want)
    if len(got) != len(want) or any(
            g.shape != w.shape or not np.array_equal(g, w)
            for g, w in zip(got, want)):
        raise AnswerMismatch(f"{what}: the device answer differs from its "
                             f"reference")


# ---------------------------------------------------------------------------
# kernel-level: fused consult vs the host tiers at scale
# ---------------------------------------------------------------------------

def _make_index(rng, t, k, hot=8, keys_per_txn=2):
    """A contended in-flight index: 50% of txns on the hot key set (wide
    range-join shapes — keys_per_txn > hot — draw uniformly instead)."""
    key_inc = np.zeros((t, k), dtype=np.int8)
    hot_mask = rng.random(t) < 0.5
    wide = keys_per_txn > hot
    for i in range(t):
        if wide:
            key_inc[i, rng.choice(k, keys_per_txn, replace=False)] = 1
            continue
        pool = hot if hot_mask[i] else k - hot
        off = 0 if hot_mask[i] else hot
        key_inc[i, off + rng.choice(pool, keys_per_txn, replace=False)] = 1
    lanes = np.zeros((t, 5), dtype=np.int32)
    lanes[:, 0] = 1
    lanes[:, 2] = 1000 + rng.permutation(t)
    lanes[:, 4] = rng.integers(1, 16, t)
    kind = rng.choice([0, 1], t).astype(np.int8)
    status = rng.choice([1, 2, 3, 4], t).astype(np.int8)
    active = np.ones(t, dtype=bool)
    return key_inc, lanes, kind, status, active


def _make_queries(rng, b, k, t, hot=8, keys_per_txn=2):
    q = np.zeros((b, k), dtype=np.int8)
    hot_mask = rng.random(b) < 0.5
    wide = keys_per_txn > hot
    for i in range(b):
        if wide:
            q[i, rng.choice(k, keys_per_txn, replace=False)] = 1
            continue
        pool = hot if hot_mask[i] else k - hot
        off = 0 if hot_mask[i] else hot
        q[i, off + rng.choice(pool, keys_per_txn, replace=False)] = 1
    before = np.zeros((b, 5), dtype=np.int32)
    before[:, 0] = 1
    before[:, 2] = 1000 + t + rng.integers(0, t, b)
    before[:, 4] = rng.integers(1, 16, b)
    kind = rng.choice([0, 1], b).astype(np.int8)
    return q, before, kind


def make_host_tier(key_inc, ts, txn_id, kind, status, active):
    """The host tier of the same fused consult — the resolver's own
    vectorized-numpy implementation (impl.tpu_resolver._consult_host), driven
    directly so the baseline cannot drift from the shipped semantics."""
    from cassandra_accord_tpu_torch.impl.tpu_resolver import TpuDepsResolver
    r = TpuDepsResolver.__new__(TpuDepsResolver)   # host tier needs only _h
    r.host_consults = 0
    r._host_engine = "numpy"   # bare instance: skip the native-engine probe
    # no covered bits in the synthetic index: live == full incidence
    r._h = {"key_inc": key_inc, "key_inc_f32": key_inc.T.astype(np.float32),
            "live_f32": key_inc.T.astype(np.float32),
            "ts": ts, "txn_id": txn_id, "kind": kind, "status": status,
            "active": active}
    return lambda q, before, qkind: r._consult_host(q, before, qkind)


def host_python_scalar(key_inc, txn_id, active, q, before, sample=32):
    """The reference-shaped per-txn scalar walk, on a sample (extrapolated)."""
    done = 0
    t0 = time.perf_counter()
    for i in range(min(sample, q.shape[0])):
        overlap = (key_inc & q[i]).any(axis=1) & active
        bound = tuple(before[i])
        for s in np.nonzero(overlap)[0]:
            _ = tuple(txn_id[s]) < bound
        if overlap.any():
            _ = txn_id[overlap].max(axis=0)
        done += 1
    return done / (time.perf_counter() - t0)


def _deps_rows(deps, t: int) -> np.ndarray:
    """A device deps answer as a [B, T] bool array (the packed form unpacked,
    little-endian bit order)."""
    deps = deps.cpu().numpy()
    if deps.dtype == np.uint8:
        deps = np.unpackbits(deps, axis=1, bitorder="little").astype(bool)
    return deps[:, :t]


def bench_kernel(t, k=512, b=256, iters=20, keys_per_txn=2, packed=False):
    """K1/K2 through ``ops.deps_kernels.consult`` (or ``consult_packed``) over
    ``iters`` distinct query batches, timed with CUDA events around the whole
    run after a warm-up, beside the numpy host tier, the native C++ host
    engine and the scalar walk on the same index.  Every batch's device
    answer (deps mask and max lanes) is then held against the host tier's."""
    import torch
    from cassandra_accord_tpu_torch import native
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    from cassandra_accord_tpu_torch.ops.graph_state import INVALIDATED
    dev = device()
    rng = np.random.default_rng(42)
    key_inc, lanes, kind, status, active = _make_index(rng, t, k,
                                                       keys_per_txn=keys_per_txn)
    q, before, qkind = _make_queries(rng, b, k, t, keys_per_txn=keys_per_txn)

    def up(a):
        return torch.from_numpy(a).to(dev)
    index_dev = [up(x) for x in
                 (key_inc, key_inc, lanes, lanes, kind, status, active)]
    # a DISTINCT query batch per iteration: a repeated computation could be
    # served from caches and would overstate rates
    host_batches = [_make_queries(rng, b, k, t, keys_per_txn=keys_per_txn)
                    for _ in range(iters)]
    batches = [tuple(up(x) for x in bt) for bt in host_batches]
    kernel = dk.consult_packed if packed else dk.consult
    kernel(*index_dev, up(q), up(before), up(qkind))     # warm-up (build)
    # one whole loop untimed first, so that the timed one finds its outputs'
    # memory in the caching allocator (as a serving loop does) instead of
    # paying each batch's first allocation inside the window
    warm = [kernel(*index_dev, *bt) for bt in batches]
    del warm
    outs, seconds = _timed(dev, lambda: [kernel(*index_dev, *bt)
                                         for bt in batches])
    dev_qps = iters * b / seconds
    # numpy-vectorized host baseline: the resolver's own host tier
    host_tier = make_host_tier(key_inc, lanes, lanes, kind, status, active)
    t0 = time.perf_counter()
    for _ in range(3):
        want_deps, want_max = host_tier(q, before, qkind)
    np_qps = 3 * b / (time.perf_counter() - t0)
    # native C++ host engine (native/consult.cpp) on the same state/queries
    native_qps = None
    if native.available():
        h = {"key_inc": key_inc, "live_inc": key_inc, "ts": lanes,
             "txn_id": lanes, "kind": kind, "status": status, "active": active}
        qcols = [np.nonzero(row)[0] for row in q]
        deps_n, max_n = native.consult_batch(h, qcols, before, qkind,
                                             INVALIDATED)   # warm
        _same(f"native consult T={t}", deps_n, want_deps)
        _same(f"native max lanes T={t}", max_n, want_max)
        t0 = time.perf_counter()
        for _ in range(3):
            native.consult_batch(h, qcols, before, qkind, INVALIDATED)
        native_qps = 3 * b / (time.perf_counter() - t0)
    py_qps = host_python_scalar(key_inc, lanes, active, q, before)
    for i, ((qi, bi, ki), (deps, max_lanes)) in enumerate(
            zip(host_batches, outs)):
        want_deps, want_max = host_tier(qi, bi, ki)
        _same(f"consult deps T={t} batch {i}", _deps_rows(deps, t), want_deps)
        _same(f"consult max lanes T={t} batch {i}",
              max_lanes.cpu().numpy().astype(np.int64), want_max)
    out = {"T": t, "K": k, "B": b, "keys_per_txn": keys_per_txn,
           "packed_result": packed,
           "device_queries_per_sec": round(dev_qps, 1),
           "host_numpy_queries_per_sec": round(np_qps, 1),
           "host_native_queries_per_sec":
               round(native_qps, 1) if native_qps else None,
           "host_python_scalar_queries_per_sec": round(py_qps, 1),
           "device_vs_host_numpy": round(dev_qps / np_qps, 2),
           "answers_checked": iters * b}
    return out


def _bare_service_resolver(key_inc, lanes, kind, status, active):
    """A TpuDepsResolver shell carrying a pre-built synthetic index — just
    the surface the consult service reads (host arrays, dirty-row ledger,
    occupancy watermarks, the host fallback tier)."""
    from cassandra_accord_tpu_torch.config import LocalConfig
    from cassandra_accord_tpu_torch.impl.tpu_resolver import TpuDepsResolver
    t, k = key_inc.shape
    r = TpuDepsResolver.__new__(TpuDepsResolver)
    r.host_consults = 0
    r.native_consults = 0
    r.device_consults = 0
    r._host_engine = "numpy"
    r._h = {"key_inc": key_inc, "live_inc": key_inc,
            "key_inc_f32": key_inc.T.astype(np.float32),
            "live_f32": key_inc.T.astype(np.float32),
            "ts": lanes, "txn_id": lanes, "kind": kind, "status": status,
            "active": active, "durable": np.zeros(t, dtype=np.bool_)}
    r._dirty_rows = set()
    r._max_slot = t - 1
    r._max_key_slot = k - 1
    r.store = None
    r.config = LocalConfig.from_env(tpu_service="on",
                                    tpu_service_backend="torch")
    r.host_index = lambda: r._h            # bare shell: no _flush machinery

    def take_dirty():
        d = r._dirty_rows
        r._dirty_rows = set()
        return d
    r.take_dirty_rows = take_dirty
    return r


def bench_service(t, k=512, b=64, keys_per_txn=2, dirty_rows_per_window=8):
    """The consult_service section: batched windows through the persistent
    service vs one-shot dispatch vs the host tier, at the same T.  Between
    windows a few rows go dirty (the protocol's mutation interleave), so the
    numbers carry the incremental-refresh cost.  Every answer, batched and
    one-shot, is then held against the host tier's on the same rows."""
    from cassandra_accord_tpu_torch.device_service.service import \
        DeviceConsultService
    dev = device()
    windows = 12 if t <= 8192 else (8 if t <= 32768 else 4)
    rng = np.random.default_rng(7)
    key_inc, lanes, kind, status, active = _make_index(rng, t, k,
                                                       keys_per_txn=keys_per_txn)
    qs = []
    for _ in range(windows):
        qs.append(_make_queries(rng, b, k, t, keys_per_txn=keys_per_txn))
    # -- batched windows through the service (futures path) ------------------
    r = _bare_service_resolver(key_inc, lanes, kind, status, active)
    svc = DeviceConsultService(r, config=r.config)
    svc.begin_window()                     # warm: buffers + first build
    f = svc.submit(np.nonzero(qs[0][0][0])[0].tolist(),
                   tuple(int(v) for v in qs[0][1][0]), int(qs[0][2][0]))
    f.result()
    svc.end_window()
    answers = []
    t0 = time.perf_counter()
    for q, before, qkind in qs:
        svc.begin_window()
        futs = [svc.submit(np.nonzero(q[i])[0].tolist(),
                           tuple(int(v) for v in before[i]), int(qkind[i]))
                for i in range(b)]
        futs[0].result()                   # one launch answers the window
        svc.end_window()
        answers.append(futs)
        r._dirty_rows.update(int(x) for x in
                             rng.integers(0, t, dirty_rows_per_window))
    _sync(dev)
    batched_qps = windows * b / (time.perf_counter() - t0)
    stats = svc.stats()
    # -- one-shot dispatch (window of 1: unamortized launch round trip) -------
    r1 = _bare_service_resolver(key_inc, lanes, kind, status, active)
    svc1 = DeviceConsultService(r1, config=r1.config)
    q, before, qkind = qs[0]
    svc1.consult_rows(q[:1], before[:1], qkind[:1])      # warm
    n_oneshot = min(2 * b, 64)
    oneshot = []
    t0 = time.perf_counter()
    for i in range(n_oneshot):
        oneshot.append(svc1.consult_rows(q[i:i + 1], before[i:i + 1],
                                         qkind[i:i + 1]))
        r1._dirty_rows.update(int(x) for x in
                              rng.integers(0, t, 1))     # mutation interleave
    _sync(dev)
    oneshot_qps = n_oneshot / (time.perf_counter() - t0)
    # -- host: the resolver's own vectorized host tier -----------------------
    host_tier = make_host_tier(key_inc, lanes, lanes, kind, status, active)
    t0 = time.perf_counter()
    for q, before, qkind in qs[:3]:
        host_tier(q, before, qkind)
    host_qps = 3 * b / (time.perf_counter() - t0)
    # the dirty rows carry no new data, so every answer is the host tier's
    # on the unchanged index
    for w, ((q, before, qkind), futs) in enumerate(zip(qs, answers)):
        want_deps, want_max = host_tier(q, before, qkind)
        got = [fut.result() for fut in futs]
        _same(f"service deps T={t} window {w}",
              np.stack([g[0] for g in got]), want_deps)
        _same(f"service max lanes T={t} window {w}",
              np.stack([g[1] for g in got]).astype(np.int64), want_max)
        if w == 0:
            _same(f"one-shot deps T={t}",
                  np.concatenate([d for d, _ in oneshot]),
                  want_deps[:n_oneshot])
            _same(f"one-shot max lanes T={t}",
                  np.concatenate([m for _, m in oneshot]).astype(np.int64),
                  want_max[:n_oneshot])
    out = {"T": t, "K": k, "B": b, "windows": windows,
           "batched_queries_per_sec": round(batched_qps, 1),
           "oneshot_queries_per_sec": round(oneshot_qps, 1),
           "host_native_queries_per_sec": round(host_qps, 1),
           "batched_vs_host": round(batched_qps / host_qps, 2),
           "batched_vs_oneshot": round(batched_qps / max(oneshot_qps, 1e-9), 2),
           "batch_size_hist": stats["batch_size_hist"],
           "window_occupancy": stats["window_occupancy"],
           "dispatch_mean_s": stats["dispatch_mean_s"],
           "index_incremental_refreshes": stats["index_incremental_refreshes"],
           "index_full_uploads": stats["index_full_uploads"],
           "jit_shapes": stats["jit_shapes"],
           "answers_checked": windows * b + n_oneshot}
    return out


def _bench_graph_adj(t):
    """BASELINE config 5's graph: ~8 deps per txn, cycle-heavy."""
    from cassandra_accord_tpu_torch.ops.graph_state import STABLE
    rng = np.random.default_rng(9)
    adj = (rng.random((t, t)) < (8.0 / t)).astype(np.int8)
    np.fill_diagonal(adj, 0)
    status = np.full((t,), STABLE, dtype=np.int8)
    active = np.ones((t,), dtype=bool)
    return adj, status, active


def bench_graph(t=8192, iters=3):
    """BASELINE config-5 shape: cycle-heavy adversarial dependency graph —
    transitive closure, SCC condensation and the Kahn frontier as dense
    matmul ops on the card.  Dense [T, T] int8 adjacency (64 MB at 8k).
    Each op's answer is held against its edge twin (ops.frontier_kernels)
    on the same device."""
    import torch
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    from cassandra_accord_tpu_torch.ops import frontier_kernels as fk
    dev = device()
    adj, status, active = _bench_graph_adj(t)
    a, s, act = (torch.from_numpy(x).to(dev) for x in (adj, status, active))
    out = {"T": t, "adjacency_bytes": t * t,
           "deps_per_txn": float(adj.sum() / t)}
    closure_flops = 2.0 * t * t * t * max(1, int(t - 1).bit_length())
    for name, fn, args, flops, twin in (
            ("closure", dk.transitive_closure, (a,), closure_flops,
             lambda: fk.transitive_closure_csr(adj, dev)),
            ("scc_condense", dk.scc_condense, (a, act), closure_flops,
             lambda: fk.scc_condense_csr(adj, active, dev)),
            ("kahn_frontier", dk.kahn_frontier, (a, s, act), 2.0 * t * t,
             lambda: fk.kahn_frontier_csr(adj, status, active, dev))):
        fn(*args)                                            # warm-up
        rs, dt = _timed(dev, lambda: [fn(*args) for _ in range(iters)])
        dt /= iters
        _same(f"{name} T={t}", rs[-1], twin())
        out[name] = {"seconds": round(dt, 4),
                     "tflops": round(flops / dt / 1e12, 2)}
    return out


def bench_deps_graph(ts=(1024, 8192), dense_max=None):
    """``deps_graph`` stage: the O(T^3)-shaped dense ops vs their
    frontier/CSR replacements (ops.frontier_kernels) on the config-5 graph
    shape, at T in {1k, 8k}; the dense twins run at T <= ``dense_max``
    (default 1024, ``ACCORD_BENCH_DENSE_MAX`` overrides), and there each
    frontier answer is held against the dense one.  Then the
    frontier-driven vs event-driven commit rate and the round-6 repro's
    profile."""
    import torch
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    from cassandra_accord_tpu_torch.ops import frontier_kernels as fk
    dev = device()
    if dense_max is None:
        dense_max = int(os.environ.get("ACCORD_BENCH_DENSE_MAX", "1024"))
    out = {}
    for t in ts:
        adj, status, active = _bench_graph_adj(t)
        row = {"T": t, "edges": int(adj.sum())}
        answers = {}

        def timed(name, fn):
            fn()                                             # warm-up
            t0 = time.perf_counter()
            answers[name] = fn()
            _sync(dev)
            return round(time.perf_counter() - t0, 4)

        row["closure_frontier_s"] = timed(
            "closure_frontier", lambda: fk.closure_condensed(adj, dev))
        row["elide_frontier_s"] = timed(
            "elide_frontier", lambda: fk.elide_csr(adj, dev))
        row["scc_frontier_s"] = timed(
            "scc_frontier", lambda: fk.scc_condense_csr(adj, active, dev))
        row["kahn_frontier_s"] = timed(
            "kahn_frontier", lambda: fk.kahn_frontier_csr(adj, status, active,
                                                          dev))
        if t <= dense_max:
            a, act, st = (torch.from_numpy(x).to(dev)
                          for x in (adj, active, status))
            row["closure_dense_s"] = timed(
                "closure_dense", lambda: dk.transitive_closure(a))
            row["elide_dense_s"] = timed("elide_dense", lambda: dk.elide(a))
            row["scc_dense_s"] = timed(
                "scc_dense", lambda: dk.scc_condense(a, act))
            row["kahn_dense_s"] = timed(
                "kahn_dense", lambda: dk.kahn_frontier(a, st, act))
            # the condensed closure expands to the dense closure's answer
            _same(f"closure T={t}", fk.transitive_closure_csr(adj, dev),
                         answers["closure_dense"])
            for k2 in ("elide", "scc", "kahn"):
                _same(f"{k2} T={t}", answers[f"{k2}_frontier"],
                             answers[f"{k2}_dense"])
            for k2 in ("closure", "elide", "scc", "kahn"):
                new, old = row[f"{k2}_frontier_s"], row[f"{k2}_dense_s"]
                row[f"{k2}_speedup"] = round(old / new, 2) if new else None
        else:
            row["dense_skipped"] = f"T > dense_max={dense_max} " \
                                   f"(ACCORD_BENCH_DENSE_MAX overrides)"
        out[f"T{t}"] = row
    # frontier-DRIVEN vs event-driven end-to-end commit rate, same workload
    from cassandra_accord_tpu_torch.harness.burn import run_burn
    rates = {}
    for label, fx in (("event_driven", False), ("frontier_driven", True)):
        t0 = time.perf_counter()
        res = run_burn(seed=PROTO_SEED, ops=300, concurrency=PROTO_CONC,
                       resolver="tpu", batch_window_us=TPU_WINDOW_US,
                       frontier_exec=fx, **PROTO_KW)
        dt = time.perf_counter() - t0
        rates[label] = {"commits_per_sec_wall": round(res.ops_ok / dt, 1),
                        "sim_ms": round(res.sim_micros / 1000.0, 1),
                        "frontier_released":
                            res.stats.get("frontier_released", 0)}
    out["exec_commit_rate"] = rates
    # the KNOWN_ISSUES round-6 repro config, profiled: the deps_execute_wait
    # phase share, split into commit-plane vs execute-plane waits
    from cassandra_accord_tpu_torch.observe import FlightRecorder
    rec = FlightRecorder()
    res = run_burn(0, ops=100, concurrency=20, resolver="verify",
                   frontier_exec=True, chaos=True, allow_failures=True,
                   topology_churn=True, durability=True, journal=True,
                   delayed_stores=True, clock_drift=True, cache_miss=True,
                   observer=rec, max_tasks=200_000_000)
    b = rec.latency_budget()
    out["frontier_profile"] = {
        "workload": "round-6 repro (seed 0, 100 ops, full hostile matrix, "
                    "frontier_exec)",
        "ops": res.resolved,
        "mean_commit_ms": round(b["mean_commit_latency_us"] / 1000.0, 1),
        "deps_execute_wait_share":
            round((b["phases"].get("deps_execute_wait") or {})
                  .get("share", 0.0), 4),
        "deps_commit_wait_share":
            round((b["phases"].get("deps_commit_wait") or {})
                  .get("share", 0.0), 4),
        "attributed_share": b["attributed_share"],
    }
    return out


# ---------------------------------------------------------------------------
# the stages of a full run (bench.py's closures of main(), with its sizes)
# ---------------------------------------------------------------------------

def proto(ops: int = PROTO_OPS, warm_ops: int = 40, short_ops: int = 200):
    """``protocol``: one warm rep, then ONE timed rep per data plane, and the
    flat-cost check (commits/s at ``short_ops`` vs ``ops``)."""
    bench_protocol("tpu", batch_window_us=TPU_WINDOW_US, ops=warm_ops, reps=1)
    tpu_cps, tpu_res = bench_protocol("tpu", batch_window_us=TPU_WINDOW_US,
                                      ops=ops, reps=1)
    cpu_cps, cpu_res = bench_protocol("cpu", batch_window_us=0, ops=ops,
                                      reps=1)
    tel = {k: v for k, v in tpu_res.stats.items() if k.startswith("resolver_")}
    mismatch = tpu_res.ops_ok != cpu_res.ops_ok
    short_cps, _ = bench_protocol("cpu", batch_window_us=0, ops=short_ops,
                                  reps=1)
    return {
        "commits_per_sec_tpu_dataplane": round(tpu_cps, 1),
        "commits_per_sec_cpu_resolver": round(cpu_cps, 1),
        "ratio": None if mismatch else round(tpu_cps / cpu_cps, 3),
        "workload_mismatch": {"tpu_ops_ok": tpu_res.ops_ok,
                              "cpu_ops_ok": cpu_res.ops_ok}
        if mismatch else None,
        f"commits_per_sec_cpu_at_{short_ops}_ops": round(short_cps, 1),
        f"per_op_cost_flatness_{ops}_vs_{short_ops}":
            round(cpu_cps / short_cps, 3) if short_cps else None,
        "workload": {"ops": ops, "concurrency": PROTO_CONC,
                     **PROTO_KW, "seed": PROTO_SEED,
                     "tpu_batch_window_us": TPU_WINDOW_US},
        "tpu_resolver_telemetry": tel,
    }


def protocol_slo(nodes=(5, 15), ops: int = 200):
    """``protocol_slo``: p50/p95/p99 commit latency from the recorder's
    sim-time histogram plus liveness-SLO flag counts, under the elastic
    matrix (join/decommission under load).  Sim-time latencies only: wall
    clock never enters the percentile math."""
    from dataclasses import replace as _replace
    from cassandra_accord_tpu_torch.config import LocalConfig
    from cassandra_accord_tpu_torch.harness.burn import run_burn
    from cassandra_accord_tpu_torch.observe import InvariantAuditor
    from cassandra_accord_tpu_torch.observe import schema as _schema
    from cassandra_accord_tpu_torch.observe.registry import Histogram

    pct = Histogram.snapshot_percentile
    out = {}
    cfg = _replace(LocalConfig(), membership_interval_s=6.0)
    for n_nodes in nodes:
        auditor = InvariantAuditor(mode="warn")
        t0 = time.perf_counter()
        res = run_burn(seed=PROTO_SEED, ops=ops, concurrency=PROTO_CONC,
                       nodes=n_nodes, rf=5 if n_nodes >= 5 else 3,
                       chaos=True, allow_failures=True,
                       topology_churn=True, elastic_membership=True,
                       durability=True, journal=True, node_config=cfg,
                       observer=auditor, audit="warn",
                       stall_watchdog_s=300.0, max_tasks=80_000_000)
        dt = time.perf_counter() - t0
        hist = auditor.registry.histogram(
            _schema.LATENCY_METRIC).to_snapshot()
        verdict = res.audit or {}
        out[f"nodes_{n_nodes}"] = {
            "ops": res.resolved,
            "joins": res.joins, "leaves": res.leaves,
            "commits_per_sec_wall": round(res.resolved / dt, 1)
            if dt else None,
            "commit_latency_us": {
                "p50": pct(hist, 0.50), "p95": pct(hist, 0.95),
                "p99": pct(hist, 0.99), "count": hist["count"],
                "mean": round(hist["total"] / hist["count"])
                if hist["count"] else None},
            "slo_flags": {
                "raised": verdict.get("slo_flags_raised"),
                "open_at_quiesce": verdict.get("slo_flags_open")},
            "violations": verdict.get("violations"),
        }
    return out


def workload_slo(ops: int = 240, rate: float = 30.0):
    """``workload_slo``: the open-loop arrival-rate SLO preset under the
    hostile matrix, the burn-rate monitors as the oracle (zero slo.burn
    events = sustained), the history checker riding along."""
    from cassandra_accord_tpu_torch.harness.burn import run_burn
    from cassandra_accord_tpu_torch.observe import (BurnRateMonitor,
                                                    InvariantAuditor)
    monitor = BurnRateMonitor()
    auditor = InvariantAuditor(mode="warn", burnrate=monitor)
    t0 = time.perf_counter()
    res = run_burn(seed=PROTO_SEED, ops=ops, concurrency=PROTO_CONC,
                   chaos=True, allow_failures=True, durability=True,
                   journal=True, delayed_stores=True, clock_drift=True,
                   workload="openloop", rate_txn_s=rate, check="history",
                   observer=auditor, audit="warn",
                   stall_watchdog_s=300.0, max_tasks=80_000_000)
    dt = time.perf_counter() - t0
    rep = monitor.report()
    events = rep.get("slo_burn_events", 0)
    return {
        "workload": "openloop", "rate_txn_s": rate,
        "ops": res.resolved,
        "sim_minutes": round(res.sim_micros / 60e6, 2),
        "slo_burn_events": events,
        "sustained": events == 0,
        "history": {k: res.history[k] for k in ("ops", "ok", "keys")}
        if res.history else None,
        "wall_s": round(dt, 2),
    }


def overload(ops: int = 120, rate: float = 30.0):
    """``overload``: a small metastability ramp (0.5x/1x/2x of the target
    rate, admission control and retry budgets on) under the hostile matrix."""
    from dataclasses import replace
    from cassandra_accord_tpu_torch.config import LocalConfig
    from cassandra_accord_tpu_torch.harness.burn import run_overload_ramp
    cfg = replace(LocalConfig.from_env(), admission_enabled=True,
                  retry_budget_enabled=True)
    kw = dict(ops=ops, concurrency=PROTO_CONC, chaos=True,
              allow_failures=True, durability=True, journal=True,
              delayed_stores=True, clock_drift=True, workload="openloop",
              node_config=cfg, check="history", audit="warn",
              stall_watchdog_s=300.0, max_tasks=80_000_000)
    t0 = time.perf_counter()
    out = run_overload_ramp(PROTO_SEED, kw, rate, mults=(0.5, 1.0, 2.0))
    out["wall_s"] = round(time.perf_counter() - t0, 2)
    return out


def frontier(ops: int = 400):
    """``frontier_exec``: frontier-driven execution in the flagship
    configuration, through the device data plane."""
    from cassandra_accord_tpu_torch.harness.burn import run_burn
    t0 = time.perf_counter()
    res = run_burn(seed=PROTO_SEED, ops=ops, concurrency=PROTO_CONC,
                   resolver="tpu", batch_window_us=TPU_WINDOW_US,
                   frontier_exec=True, **PROTO_KW)
    dt = time.perf_counter() - t0
    return {"commits_per_sec": round(res.ops_ok / dt, 1), "ops": ops,
            "frontier_stats": {k: v for k, v in res.stats.items()
                               if "frontier" in k or "exec" in k}}


def record(ops: int = PROTO_OPS):
    """``record_burn``: the protocol burn with every consult recorded, for
    the scaled replays; the host tier keeps its f32 mirrors at every size."""
    from cassandra_accord_tpu_torch.harness.consult_trace import record_burn
    os.environ["ACCORD_TPU_F32_MAX"] = str(1 << 20)
    return record_burn(seed=PROTO_SEED, ops=ops, concurrency=PROTO_CONC,
                       batch_window_us=TPU_WINDOW_US, **PROTO_KW)


REPLAY_TARGETS = (4096, 32768)
REPLAY_TIERS = ("walk", "host", "auto", "device")
# budget valves (seconds per tier): prefix replay, labelled truncated
REPLAY_VALVES = {"device": 180.0, "host": 240.0, "auto": 240.0}


def replay(rec, t_target: int, tiers=REPLAY_TIERS):
    """``replay_T<t>``: the recording replayed at ``t_target`` live txns
    through each tier — the walk on ~300 sampled queries (extrapolated),
    the device tier through the persistent consult service — under the
    valves."""
    from cassandra_accord_tpu_torch.harness.consult_trace import scaled_replay
    return scaled_replay(rec, t_target, list(tiers), parity_sample=500,
                         walk_sample_target=300,
                         tier_max_seconds=dict(REPLAY_VALVES))


def consult_service_stage(burn_ops: int = 300,
                          scaling=(8192, 32768, 65536)):
    """``consult_service``: a burn with the device tier forced through the
    persistent service (it must make device consults, and its outcome must
    equal the same burn on the service's host backend), then batched vs
    one-shot vs host scaling."""
    from cassandra_accord_tpu_torch.config import LocalConfig
    from cassandra_accord_tpu_torch.harness.burn import run_burn
    dev = device()
    out = {"platform": dev.type}
    runs = {}
    for backend in ("torch", "host"):
        cfg = LocalConfig.from_env(resolver_kind="tpu", tpu_tier="device",
                                   tpu_walk_max=0, tpu_walk_width=0,
                                   tpu_service="on",
                                   tpu_service_backend=backend)
        t0 = time.perf_counter()
        res = run_burn(seed=PROTO_SEED, ops=burn_ops, concurrency=PROTO_CONC,
                       resolver="tpu", batch_window_us=TPU_WINDOW_US,
                       node_config=cfg, **PROTO_KW)
        _sync(dev)
        runs[backend] = (res, time.perf_counter() - t0)
    res, dt = runs["torch"]
    host = runs["host"][0]
    if (res.ops_ok, res.resolved, res.sim_micros) != \
            (host.ops_ok, host.resolved, host.sim_micros):
        raise AnswerMismatch(
            f"service burn: the card's outcome (ok {res.ops_ok}, sim "
            f"{res.sim_micros} us) differs from the host backend's (ok "
            f"{host.ops_ok}, sim {host.sim_micros} us)")
    if not res.stats.get("resolver_device_consults", 0):
        raise AnswerMismatch("service burn made no device consult")
    out["protocol_burn_via_service"] = {
        "ops": burn_ops,
        "commits_per_sec": round(res.ops_ok / dt, 1),
        "host_backend_commits_per_sec": round(host.ops_ok / runs["host"][1],
                                              1),
        "resolver_device_consults":
            res.stats.get("resolver_device_consults", 0),
        "resolver_service_submitted":
            res.stats.get("resolver_service_submitted", 0),
        "resolver_service_batches":
            res.stats.get("resolver_service_batches", 0),
    }
    out["scaling"] = [bench_service(t) for t in scaling]
    return out


def kernels():
    """``kernel_scaling``: the consult's rate at each shape, beside the host
    tiers' on the same index."""
    return [bench_kernel(4096), bench_kernel(65536),
            bench_kernel(65536, packed=True),
            # BASELINE config 4: range txns, 1k keys/txn wide join
            bench_kernel(65536, k=2048, b=64, keys_per_txn=1024,
                         packed=True)]


# ---------------------------------------------------------------------------
# one run: the result object, fail-closed staging and the stdout tail
# ---------------------------------------------------------------------------

def history_file():
    """The trend ledger's path, or None when appends are disabled
    (``ACCORD_BENCH_HISTORY`` = 0/off/empty, as tools/trend.py reads it)."""
    path = os.environ.get("ACCORD_BENCH_HISTORY", DEFAULT_HISTORY)
    return None if path in ("", "0", "off") else path


class Run:
    """One bench run: bench.py's RESULT object, its deadline and its stage
    bookkeeping.  A stage that raises is recorded and fails the run; a stage
    with no time left before the deadline is skipped, as bench.py skips."""

    def __init__(self, deadline_s=None):
        if deadline_s is None:
            deadline_s = float(os.environ.get("ACCORD_BENCH_DEADLINE_S",
                                              "1500"))
        self.deadline = time.monotonic() + deadline_s
        self.result = {
            "metric": "consult_replay_commits_equiv_per_sec_T32k",
            "value": None,
            "unit": "commits-equiv/s",
            "vs_baseline": None,
            "detail": {"stages": {}, "incomplete": True},
        }
        self.emitted = False

    @property
    def detail(self):
        return self.result["detail"]

    def stage(self, name: str, fn):
        """Run one stage; record its wall seconds or its error.  Returns the
        stage's value, or None when it raised or was skipped."""
        stages = self.detail["stages"]
        left = self.deadline - time.monotonic()
        if left <= 30:
            stages[name] = {"skipped": f"deadline ({left:.0f}s left)"}
            return None
        t0 = time.monotonic()
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — recorded; fails the run
            traceback.print_exc()
            stages[name] = {"seconds": round(time.monotonic() - t0, 1),
                            "error": f"{type(e).__name__}: {e}"[:300]}
            return None
        stages[name] = {"seconds": round(time.monotonic() - t0, 1)}
        return out

    def failed(self) -> bool:
        d = self.detail
        return bool(d.get("error") or d.get("killed_by")
                    or any("error" in st for st in d["stages"].values()))

    def finalize_headline(self) -> None:
        """The headline from whatever replay stages completed: the shipped
        cost model's tier (``auto``), else the fastest tier that ran, vs the
        scalar cfk walk at the LARGEST completed T; with no replay, the
        end-to-end protocol ratio."""
        d = self.detail
        replay_out = d.get("trace_replay") or {}
        for key in sorted(replay_out, key=lambda k: -int(k[1:])):
            tiers = replay_out[key].get("tiers") or {}
            walk = (tiers.get("walk") or {}).get("commits_equiv_per_sec")
            rates = {t: v.get("commits_equiv_per_sec")
                     for t, v in tiers.items()
                     if v.get("commits_equiv_per_sec")}
            if not rates:
                continue
            best = "auto" if rates.get("auto") else max(rates, key=rates.get)
            self.result["value"] = rates[best]
            self.result["metric"] = \
                f"consult_replay_commits_equiv_per_sec_{key}"
            d["headline_tier"] = best
            d["headline_T"] = key
            if walk:
                self.result["vs_baseline"] = round(rates[best] / walk, 3)
            return
        proto_out = d.get("protocol_end_to_end")
        if proto_out and proto_out.get("commits_per_sec_tpu_dataplane"):
            self.result["metric"] = "protocol_commits_per_sec"
            self.result["unit"] = "commits/s"
            self.result["value"] = proto_out["commits_per_sec_tpu_dataplane"]
            self.result["vs_baseline"] = proto_out.get("ratio")

    def _append_history(self) -> None:
        """The trend ledger record (tools/trend.py's reader takes bench.py's
        layout); runs doctored by the perf gate's self-test stay out."""
        from tools.trend import append_entry
        from tools_torch.perfgate import inject_active
        path = history_file()
        if path is None or inject_active():
            return
        d = self.detail
        smoke = d.get("smoke") or {}
        rec = {"kind": "bench", "bench": "bench_torch",
               "device": (d.get("device") or {}).get("name"),
               "metric": self.result["metric"], "value": self.result["value"],
               "unit": self.result["unit"],
               "vs_baseline": self.result["vs_baseline"],
               "incomplete": d.get("incomplete", True),
               "sim": smoke.get("sim")}
        dg = d.get("deps_graph")
        if dg:
            deps_graph = {}
            for tkey, row in dg.items():
                if tkey.startswith("T"):
                    deps_graph[tkey] = {
                        k2: row.get(k2) for k2 in
                        ("closure_frontier_s", "elide_frontier_s",
                         "scc_frontier_s", "kahn_frontier_s",
                         "closure_speedup", "elide_speedup", "scc_speedup",
                         "kahn_speedup") if row.get(k2) is not None}
            exec_rate = dg.get("exec_commit_rate") or {}
            if exec_rate:
                deps_graph["exec_commit_rate"] = {
                    label: (v or {}).get("commits_per_sec_wall")
                    for label, v in exec_rate.items()}
            prof = dg.get("frontier_profile") or {}
            if prof:
                deps_graph["frontier_deps_execute_wait_share"] = \
                    prof.get("deps_execute_wait_share")
                deps_graph["frontier_deps_commit_wait_share"] = \
                    prof.get("deps_commit_wait_share")
            rec["deps_graph"] = deps_graph
        ramp = d.get("protocol_ramp")
        if ramp:
            rec["protocol_commits_per_sec"] = \
                ramp.get("protocol_commits_per_sec")
            rec["ramp"] = {
                "levels": ramp.get("levels"),
                "wall": (ramp.get("columnar_on") or {})
                .get("commits_per_sec_wall"),
                "sim": (ramp.get("columnar_on") or {})
                .get("commits_per_sec_sim")}
        wslo = d.get("workload_slo")
        if wslo:
            rec["workload_slo"] = {k: wslo.get(k) for k in (
                "workload", "rate_txn_s", "sim_minutes", "slo_burn_events",
                "sustained")}
        ov = d.get("overload")
        if ov:
            rec["overload"] = {
                "mode": ov.get("mode"), "rate_txn_s": ov.get("rate_txn_s"),
                "capacity_goodput_txn_s": ov.get("capacity_goodput_txn_s"),
                "goodput_floor_frac": ov.get("goodput_floor_frac"),
                "shed": sum(p.get("shed", 0) for p in ov.get("points", [])),
                "passed": ov.get("passed")}
        seed = (smoke.get("workload") or {}).get("seed")
        if seed is not None:
            rec["seeds"] = [seed]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        append_entry(rec, path=path)

    def emit(self) -> int:
        """Print the full-detail object and, last, the compact summary line;
        append to the trend ledger.  Returns the exit code: non-zero when the
        device could not be resolved, a stage raised or the run was killed."""
        if self.emitted:
            return 1 if self.failed() else 0
        self.emitted = True
        self.finalize_headline()
        try:
            self._append_history()
        except Exception:  # noqa: BLE001 — the ledger must not stop the emit
            traceback.print_exc()
        d = self.detail
        print(json.dumps(self.result), flush=True)
        summary = {
            "metric": self.result["metric"],
            "value": self.result["value"],
            "unit": self.result["unit"],
            "vs_baseline": self.result["vs_baseline"],
            "incomplete": d.get("incomplete", True),
            "headline_tier": d.get("headline_tier"),
            "device_present": d.get("device_present"),
            "device": d.get("device"),
            "stages": {name: ("error" if "error" in st
                              else "skipped" if "skipped" in st else "ok")
                       for name, st in d["stages"].items()},
        }
        errors = {name: st["error"][:160] for name, st in d["stages"].items()
                  if "error" in st}
        if d.get("error"):
            errors["run"] = d["error"][:300]
        if errors:
            summary["errors"] = errors
        if d.get("killed_by"):
            summary["killed_by"] = d["killed_by"]
        print(json.dumps(summary), flush=True)
        return 1 if self.failed() else 0

    def resolve_device(self) -> bool:
        """Name the card in ``detail.device``; on failure record the error
        (no stage runs)."""
        try:
            dev = device()
            self.detail["device"] = describe_device(dev)
        except (RuntimeError, ValueError) as e:
            self.detail["error"] = f"{type(e).__name__}: {e}"
            return False
        self.detail["device_present"] = dev.type == "cuda"
        return True


class _Alarm:
    """SIGALRM at ``margin_s`` before the run's deadline, and SIGTERM: either
    prints the tail with ``killed_by`` and exits non-zero.  The handlers in
    place before are put back on exit."""

    def __init__(self, run: Run, margin_s: int):
        self.run = run
        self.margin_s = margin_s
        self.saved = {}

    def _on_term(self, signum, frame):
        self.run.detail["killed_by"] = signal.Signals(signum).name
        code = self.run.emit()
        sys.stdout.flush()
        os._exit(code or 1)

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGALRM):
            self.saved[sig] = signal.signal(sig, self._on_term)
        signal.alarm(max(60, int(self.run.deadline - time.monotonic())
                         - self.margin_s))
        return self

    def __exit__(self, *exc):
        signal.alarm(0)
        for sig, handler in self.saved.items():
            signal.signal(sig, handler)


def smoke_main(run=None) -> int:
    """``--smoke``: the seconds-class fixed-seed measurement the perf gate
    runs (tools_torch/perfgate.py), with the same staging and tail contract
    as the full run."""
    run = run or Run()
    d = run.detail
    if not run.resolve_device():
        return run.emit()
    with _Alarm(run, 30):
        def smoke():
            from tools_torch.perfgate import measure_smoke
            summary = measure_smoke()
            d["smoke"] = summary
            run.result["metric"] = "smoke_commit_latency_mean_us"
            run.result["unit"] = "sim_us"
            run.result["value"] = summary["sim"]["commit_latency_mean_us"]
            d["headline_tier"] = summary["dominating_class"]
        run.stage("smoke", smoke)
        d["incomplete"] = "smoke" not in d
        return run.emit()


def ramp_main(run=None) -> int:
    """``--ramp``: just the protocol_ramp stage, same staging and tail."""
    run = run or Run()
    d = run.detail
    if not run.resolve_device():
        return run.emit()
    with _Alarm(run, 30):
        def ramp():
            out = bench_protocol_ramp()
            d["protocol_ramp"] = out
            run.result["metric"] = "protocol_commits_per_sec"
            run.result["unit"] = "commits/s"
            run.result["value"] = out["protocol_commits_per_sec"]
            speedups = [s for s in out["columnar_wall_speedup"] if s]
            if speedups:
                run.result["vs_baseline"] = speedups[-1]
        run.stage("protocol_ramp", ramp)
        d["incomplete"] = "protocol_ramp" not in d
        return run.emit()


def gate_main() -> int:
    """``--gate``: the smoke measurement compared against BASELINE.json's
    gate block (tools_torch/perfgate.py); exit 3 past thresholds."""
    run = Run()
    if not run.resolve_device():
        return run.emit()
    path = history_file()
    if path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    from tools_torch.perfgate import run as gate
    return gate(gate=True)


def main(run=None) -> int:
    """Every stage, in bench.py's order."""
    run = run or Run()
    d = run.detail
    d["north_star"] = (
        "BASELINE.md targets 10x conflicting-txn commit throughput at deps "
        "parity.  This run holds the port's two data planes to it on the "
        "card named in detail.device: protocol_end_to_end (commits/s, "
        "host walk vs the device plane under the shipped cost model), the "
        "consult replay's tiers at T=4k/32k (the headline), the persistent "
        "service, the consult kernels and the graph ops.")
    if not run.resolve_device():
        return run.emit()
    with _Alarm(run, 60):
        staged = (("protocol", proto, "protocol_end_to_end"),
                  ("protocol_ramp", bench_protocol_ramp, "protocol_ramp"),
                  ("protocol_slo", protocol_slo, "protocol_slo"),
                  ("workload_slo", workload_slo, "workload_slo"),
                  ("overload", overload, "overload"),
                  ("frontier_exec", frontier, "frontier_exec"),
                  ("deps_graph", bench_deps_graph, "deps_graph"))
        for name, fn, key in staged:
            out = run.stage(name, fn)
            if out is not None:
                d[key] = out
        rec = run.stage("record_burn", record)
        if rec is not None:
            d["trace_replay"] = {}
            for t_target in REPLAY_TARGETS:
                r = run.stage(f"replay_T{t_target}",
                              lambda t_target=t_target: replay(rec, t_target))
                if r is not None:
                    d["trace_replay"][f"T{t_target}"] = r
                    run.finalize_headline()
            del rec
        for name, fn, key in (
                ("consult_service", consult_service_stage, "consult_service"),
                ("kernel_scaling", kernels, "kernel_scaling"),
                ("graph_kernels", bench_graph, "graph_kernels")):
            out = run.stage(name, fn)
            if out is not None:
                d[key] = out
        d["incomplete"] = any("skipped" in st
                              for st in d["stages"].values())
        return run.emit()


if __name__ == "__main__":
    import argparse
    _p = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="Without CUDA it exits non-zero unless ACCORD_DEVICE=cpu.")
    _p.add_argument("--smoke", action="store_true",
                    help="seconds-class fixed-seed smoke measurement "
                         "(protocol burn + latency budget); same last-line "
                         "single-JSON tail contract as the full bench")
    _p.add_argument("--gate", action="store_true",
                    help="smoke measurement + regression gate vs "
                         "BASELINE.json (tools_torch/perfgate.py): prints "
                         "per-metric deltas, exits nonzero past thresholds")
    _p.add_argument("--ramp", action="store_true",
                    help="just the protocol_ramp stage: commits/s at "
                         f"concurrency {RAMP_LEVELS}, columnar engine on "
                         "vs off")
    _args = _p.parse_args()
    for _k, _v in BENCH_ENV.items():
        os.environ.setdefault(_k, _v)
    # the port gate appends to the same ledger as the bench's own records
    os.environ.setdefault("ACCORD_BENCH_HISTORY", DEFAULT_HISTORY)
    if _args.gate:
        _code = gate_main()
    elif _args.ramp:
        _code = ramp_main()
    elif _args.smoke:
        _code = smoke_main()
    else:
        _code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(_code)
