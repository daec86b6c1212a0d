#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cassandra_accord_tpu_torch) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py                  # every phase, as the acceptance run
    python3 chip_smoke.py --phases env,build,kernels   # a subset

Phases, one JSON line each; any failure exits non-zero:

1. env      torch/CUDA versions, nvcc, the card's name and power limit;
2. build    nvcc of csrc/consult.cu for sm_90a, with its time;
3. kernels  K1 (deps_join) and K2 (max_conflict) at full size against
            their plain torch versions, exactly; device time per launch
            from a CUDA graph of back-to-back launches between one event
            pair (cold and warm L2), the wrapper's host cost apart, beside
            the plain version, one torch.matmul of the same join and the
            least time the card could take (bytes or operations);
4. service  windows through the persistent consult service at T=65,536,
            K=512, B=64, with dirty rows between windows; every kernel
            answer is held against the plain version on the same inputs;
5. burn     the main path: a seeded burn with the device tier forced
            through the service and frontier execution on; the launch
            counts are zeroed just before it and read just after; every
            kernel answer is checked against the plain version, the trace
            must equal the same burn on the host backend;
6. replay   a recorded burn replayed at T~32,768 through the host and
            device tiers with sampled parity against the cfk walk.

Then the card's nvidia-smi line, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Without CUDA, or run from a directory
that does not hold the port, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(os.getcwd(), "chiprun_out")
PHASES = ("env", "build", "kernels", "service", "burn", "replay")

# H100 SXM data sheet (NVIDIA), dense rates at the 700 W limit: HBM3 at
# 3.35 TB/s; 67 TFLOP/s FP32 on the CUDA cores, the rate class the consult
# kernels' word ORs and int32 compares run in; 1,979 TOP/s int8 on the
# tensor cores, the rate of the dense form of the key-overlap product.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12

TPU_KERNEL = "cassandra_accord_tpu/ops/pallas_join.py:36"   # _join_kernel
SOURCE = "cassandra_accord_tpu_torch/csrc/consult.cu"
REPLACES = {
    # K1 is the port of the one Pallas kernel (pallas_call at :61)
    "deps_join": TPU_KERNEL,
    # K2 is the max half of the same consult; the reference computes it in
    # XLA beside the join (device_service/kernel.py:55-59)
    "max_conflict": "cassandra_accord_tpu/device_service/kernel.py:55",
}


def emit(obj) -> None:
    print(json.dumps(obj, sort_keys=False), flush=True)


class PhaseFailed(Exception):
    pass


def need(cond, msg) -> None:
    if not cond:
        raise PhaseFailed(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def _elapsed_ms(torch, run) -> float:
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    run()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def _graph(torch, body):
    """``body`` captured in one CUDA graph, after a warm-up on a side
    stream (allocator pools, library workspaces)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body()
    g.replay()
    torch.cuda.synchronize()
    return g


def device_ms(torch, fn, reps: int, flush=None) -> float:
    """Device ms per call of ``fn``: ``reps`` back-to-back calls captured in
    one CUDA graph and replayed between one event pair, so no host work
    (argument checks, the ctypes call) sits in the window.  With ``flush``
    every call follows an L2 flush (the index read cold, as after other
    work), and the flushes alone, captured the same way, are subtracted."""
    def calls():
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
    total = _elapsed_ms(torch, _graph(torch, calls).replay)
    if flush is not None:
        def flushes():
            for _ in range(reps):
                flush.zero_()
        total -= _elapsed_ms(torch, _graph(torch, flushes).replay)
    return total / reps


def eager_ms(torch, fn, reps: int, flush) -> float:
    """Ms per call of ``fn`` run eagerly (for code that synchronises and so
    cannot be captured, i.e. the plain versions): ``reps`` calls, each
    after an L2 flush, between one event pair, less the flushes alone."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            flush.zero_()
            fn()

    def flushes():
        for _ in range(reps):
            flush.zero_()
    return (_elapsed_ms(torch, calls) - _elapsed_ms(torch, flushes)) / reps


def host_us(torch, fn, reps: int) -> float:
    """Host µs per wrapper call, the calls enqueued back to back: the
    Python checks, allocation and ctypes call the device times leave out."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def join_bound(torch, name, inc_T, offsets, cols, packed=False):
    """(bound_ms, bound_by, bytes, ops) for one K1/K2 call.  Bytes: each
    input byte the function needs read once (the incidence rows the batch
    names, the slot lanes and codes, the query) and each output byte
    written once, over the HBM rate.  Operations: the key overlap the
    cheaper of two ways, 64-bit ORs of the named rows (nnz·T/8 words) on
    the CUDA cores or the dense 2·B·K·T product on the int8 tensor cores,
    plus the per-(b, t) epilogue on the CUDA cores (K1: five lane compares,
    the witness bit and the ANDs, 8; K2: the masked lex-max step, 6)."""
    k, t = inc_T.shape
    b = offsets.numel() - 1
    nnz = int(offsets[-1])
    c = cols[:nnz].long()
    c = c[(c >= 0) & (c < k)]
    distinct = int(torch.unique(c).numel())
    query = 4 * (b + 1) + 4 * nnz
    if name == "deps_join":
        nbytes = distinct * t + t * (20 + 3) + query + 21 * b \
            + (b * t // 8 if packed else b * t)
        epilogue = 8 * b * t
    else:
        nbytes = distinct * t + t * (40 + 1) + query + 20 * b
        epilogue = 6 * b * t
    or_words = c.numel() * t // 8
    dense = 2 * b * k * t
    if or_words / CUDA_CORE_OPS_PER_S <= dense / INT8_TENSOR_OPS_PER_S:
        t_overlap, overlap_ops = or_words / CUDA_CORE_OPS_PER_S, or_words
    else:
        t_overlap, overlap_ops = dense / INT8_TENSOR_OPS_PER_S, dense
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (t_overlap + epilogue / CUDA_CORE_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, overlap_ops + epilogue)


def sync(ctx) -> None:
    if ctx["dev"] != "cpu":
        ctx["torch"].cuda.synchronize()


def max_abs_err(torch, a, b) -> float:
    need(a.shape == b.shape and a.dtype == b.dtype,
         f"shape/dtype mismatch {tuple(a.shape)} {a.dtype} vs "
         f"{tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# ---------------------------------------------------------------------------
# synthetic full-size index (bench.py's contended shape, vectorised)
# ---------------------------------------------------------------------------

def make_index(np, rng, t, k, keys_per_txn, hot=8):
    """[T, K] int8 incidence: 2-key txns half on a hot key set; wide txns
    (keys_per_txn > hot) draw their keys uniformly.  Lanes as bench.py."""
    key_inc = np.zeros((t, k), dtype=np.int8)
    if keys_per_txn > hot:
        for i in range(t):
            key_inc[i, rng.choice(k, keys_per_txn, replace=False)] = 1
    else:
        hot_mask = rng.random(t) < 0.5
        pool = np.where(hot_mask, hot, k - hot)
        off = np.where(hot_mask, 0, hot)
        first = rng.integers(0, 1 << 30, t) % pool
        key_inc[np.arange(t), off + first] = 1
        if keys_per_txn == 2:
            second = (first + 1 + rng.integers(0, 1 << 30, t) % (pool - 1)) % pool
            key_inc[np.arange(t), off + second] = 1
    lanes = np.zeros((t, 5), dtype=np.int32)
    lanes[:, 0] = 1
    lanes[:, 2] = 1000 + rng.permutation(t)
    lanes[:, 4] = rng.integers(1, 16, t)
    ts = lanes.copy()
    bump = rng.random(t) < 0.3               # some executeAt above txnId
    ts[bump, 2] += rng.integers(1, 5000, int(bump.sum()))
    kind = rng.choice([0, 1, 3, 4], t).astype(np.int8)
    status = rng.choice([1, 2, 3, 4, 5, 6], t).astype(np.int8)
    active = rng.random(t) < 0.95
    live = key_inc.copy()                    # 20% of txns: one key covered
    sel = np.flatnonzero(rng.random(t) < 0.2)
    live[sel, np.argmax(key_inc[sel] != 0, axis=1)] = 0
    return key_inc, live, lanes, ts, kind, status, active


def make_queries(np, rng, b, k, t, keys_per_txn, hot=8):
    rows = []
    for _ in range(b):
        if keys_per_txn > hot or rng.random() >= 0.5:
            pool, off = (k, 0) if keys_per_txn > hot else (k - hot, hot)
        else:
            pool, off = hot, 0
        rows.append(sorted(int(off + c) for c in
                           rng.choice(pool, keys_per_txn, replace=False)))
    before = np.zeros((b, 5), dtype=np.int32)
    before[:, 0] = 1
    before[:, 2] = 1000 + rng.integers(0, t, b)
    before[:, 4] = rng.integers(1, 16, b)
    kind = rng.choice([0, 1, 3, 4], b).astype(np.int8)
    return rows, before, kind


def to_csr(np, rows):
    offsets = np.zeros((len(rows) + 1,), dtype=np.int32)
    offsets[1:] = np.cumsum([len(r) for r in rows])
    cols = np.asarray([c for r in rows for c in r], dtype=np.int32)
    return offsets, cols


# ---------------------------------------------------------------------------
# a shim that keeps kernel answers to hold against the plain version
# ---------------------------------------------------------------------------

class KernelRecorder:
    """Wraps ``_kernels.deps_join``/``max_conflict`` while installed.  The
    real wrapper still does every launch (and its count).  Every
    ``every``-th call's inputs and output are kept (none when ``every`` is
    0), and the largest call per kernel for timing at the path's own
    shapes; ``verify`` then computes
    the plain version on each kept call and compares exactly.  Checking
    after the run keeps the plain versions out of the run's wall time; the
    kept inputs are still as they were, because the index refreshes
    copy-on-write and never writes a buffer a call has read."""

    def __init__(self, torch, kmod, every: int = 1):
        self.torch = torch
        self.k = kmod
        self.every = every
        self.real = {"deps_join": kmod.deps_join,
                     "max_conflict": kmod.max_conflict}
        self.calls = {"deps_join": 0, "max_conflict": 0}
        self.kept = []
        self.largest = {}

    def _wrap(self, name):
        real = self.real[name]
        rows_arg = 5 if name == "deps_join" else 4

        def call(*args, **kwargs):
            got = real(*args, **kwargs)
            if self.every and self.calls[name] % self.every == 0:
                self.kept.append((name, args, kwargs, got))
            self.calls[name] += 1
            size = (args[rows_arg].numel() - 1) * args[0].shape[1]
            if size >= self.largest.get(name, (-1,))[0]:
                self.largest[name] = (size, args, kwargs)
            return got
        return call

    def verify(self) -> int:
        for name, args, kwargs, got in self.kept:
            want = getattr(self.k, f"{name}_plain")(*args, **kwargs)
            need(self.torch.equal(got, want),
                 f"{name} differs from its plain version at "
                 f"T={args[0].shape[1]} K={args[0].shape[0]}")
        return len(self.kept)

    def __enter__(self):
        self.k.deps_join = self._wrap("deps_join")
        self.k.max_conflict = self._wrap("max_conflict")
        return self

    def __exit__(self, *exc):
        self.k.deps_join = self.real["deps_join"]
        self.k.max_conflict = self.real["max_conflict"]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(ctx):
    torch = ctx["torch"]
    smi = shutil.which("nvidia-smi")
    line = None
    if smi:
        proc = subprocess.run([smi, "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60)
        lines = [x.strip() for x in proc.stdout.splitlines() if x.strip()]
        line = lines[0] if lines else None
    ctx["smi_line"] = line or "nvidia-smi unavailable"
    from cassandra_accord_tpu_torch.ops import _kernels
    try:
        nvcc = _kernels._nvcc()
    except RuntimeError:
        nvcc = None
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": nvcc,
            "device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "nvidia_smi": ctx["smi_line"]}


def phase_build(ctx):
    from cassandra_accord_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    _kernels.lib()
    info = dict(_kernels.BUILD_INFO)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(str(info.get("command", "")) + "\n" + str(info.get("ptxas", "")))
    ptxas = [x.strip() for x in str(info.get("ptxas", "")).splitlines()
             if "registers" in x or "spill" in x]
    return {"seconds": round(time.perf_counter() - t0, 3),
            "nvcc_seconds": info.get("seconds"), "library": info.get("path"),
            "ptxas": ptxas}


def _kernel_case(ctx, label, t, k, b, keys_per_txn, iters, packed=(False, True)):
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    dev = torch.device(ctx["dev"])
    rng = np.random.default_rng(7)
    key_inc, live, lanes, ts, kind, status, active = make_index(
        np, rng, t, k, keys_per_txn)
    rows, before, qkind = make_queries(np, rng, b, k, t, keys_per_txn)
    offsets, cols = to_csr(np, rows)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    key_T = up((key_inc != 0).T.astype(np.uint8))
    live_T = up((live != 0).T.astype(np.uint8))
    g = dict(txn_id=up(lanes), ts=up(ts), kind=up(kind), status=up(status),
             active=up(active), offsets=up(offsets), cols=up(cols),
             before=up(before), qkind=up(qkind))
    out = []
    for pk in packed:
        out.append(measure(ctx, "deps_join", f"{label}{'_packed' if pk else ''}",
                           (live_T, g["txn_id"], g["kind"], g["status"],
                            g["active"], g["offsets"], g["cols"], g["before"],
                            g["qkind"]), {"packed": pk}, iters))
    out.append(measure(ctx, "max_conflict", label,
                       (key_T, g["ts"], g["txn_id"], g["active"],
                        g["offsets"], g["cols"]), {}, iters))
    return out


def measure(ctx, name, label, args, kwargs, iters, path="synthetic"):
    """One kernel at one shape: exact check against the plain version, then
    kernel (cold and warm L2), plain and library times, the wrapper's host
    cost and the bound.  ``path`` says where the shape came from."""
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    kern = ctx["real"][name]
    plain = getattr(K, f"{name}_plain")
    got = kern(*args, **kwargs)
    want = plain(*args, **kwargs)
    sync(ctx)
    err = max_abs_err(torch, got, want)
    need(err == 0, f"{name} [{label}] differs from its plain version: "
         f"max_abs_err {err}")
    flush = ctx["flush"]

    def call():
        return kern(*args, **kwargs)
    ms = device_ms(torch, call, iters, flush)
    warm_ms = device_ms(torch, call, iters)
    wrapper_us = host_us(torch, call, iters)
    plain_ms = eager_ms(torch, lambda: plain(*args, **kwargs),
                        max(3, iters // 4), flush)
    inc_T = args[0]
    offsets = args[5] if name == "deps_join" else args[4]
    cols = args[6] if name == "deps_join" else args[5]
    qf = K.dense_query(offsets, cols, inc_T.shape[0]).float()
    incf = inc_T.float()
    library_ms = device_ms(torch, lambda: torch.matmul(qf, incf),
                           max(3, iters // 4), flush)
    del qf, incf
    bound_ms, bound_by, nbytes, ops = join_bound(
        torch, name, inc_T, offsets, cols, packed=kwargs.get("packed", False))
    row = {"name": name, "shape": label, "path": path,
           "B": offsets.numel() - 1, "T": inc_T.shape[1], "K": inc_T.shape[0],
           "nnz": int(offsets[-1]), "packed": bool(kwargs.get("packed", False)),
           "max_abs_err": err, "ms": ms, "warm_ms": warm_ms,
           "wrapper_host_us": wrapper_us, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "ops": ops}
    ctx["rows"].append(row)
    return row


def phase_kernels(ctx):
    rows = []
    rows += _kernel_case(ctx, "T65536_K512_B256_2keys", 65536, 512, 256, 2, 20)
    rows += _kernel_case(ctx, "config4_T65536_K2048_B64_1024keys", 65536,
                         2048, 64, 1024, 10)
    # the odd-T path (byte loads, no packing) at a small shape
    rows += _kernel_case(ctx, "T1003_K64_B13_2keys", 1003, 64, 13, 2, 3,
                         packed=(False,))
    return {"cases": [dict({k: r[k] for k in ("name", "shape", "max_abs_err",
                                              "ms", "warm_ms",
                                              "wrapper_host_us", "plain_ms",
                                              "library_ms", "bound_ms",
                                              "bound_by")},
                           bound_us=r["bound_ms"] * 1e3) for r in rows]}


def bare_service_resolver(cfg_cls, resolver_cls, key_inc, lanes, kind,
                          status, active, device):
    """A TpuDepsResolver shell carrying a pre-built synthetic index — the
    surface the torch-backed consult service reads (bench.py's stand-in)."""
    t, k = key_inc.shape
    r = resolver_cls.__new__(resolver_cls)
    r.device_consults = 0
    r._h = {"key_inc": key_inc, "live_inc": key_inc, "ts": lanes,
            "txn_id": lanes, "kind": kind, "status": status, "active": active}
    r._dirty_rows = set()
    r._max_slot = t - 1
    r._max_key_slot = k - 1
    r.store = None
    r.config = cfg_cls.from_env(tpu_service="on", tpu_service_backend="torch",
                                device=device)
    r.host_index = lambda: r._h

    def take_dirty():
        d = r._dirty_rows
        r._dirty_rows = set()
        return d
    r.take_dirty_rows = take_dirty
    return r


def phase_service(ctx):
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.config import LocalConfig
    from cassandra_accord_tpu_torch.device_service.service import \
        DeviceConsultService
    from cassandra_accord_tpu_torch.impl.tpu_resolver import TpuDepsResolver
    from cassandra_accord_tpu_torch.ops import _kernels as K
    t, k, b, windows = 65536, 512, 64, 4
    rng = np.random.default_rng(11)
    key_inc, _live, lanes, _ts, kind, status, active = make_index(
        np, rng, t, k, 2)
    r = bare_service_resolver(LocalConfig, TpuDepsResolver, key_inc,
                              lanes, kind, status, active, ctx["dev"])
    svc = DeviceConsultService(r, config=r.config)
    need(svc.device.type == torch.device(ctx["dev"]).type,
         f"service device {svc.device}")
    K.reset_launches()
    answered = 0
    t0 = time.perf_counter()
    with KernelRecorder(torch, K) as chk:
        for _w in range(windows):
            rows, before, qkind = make_queries(np, rng, b, k, t, 2)
            svc.begin_window()
            futs = [svc.submit(rows[i], tuple(int(v) for v in before[i]),
                               int(qkind[i])) for i in range(b)]
            futs[0].result()
            svc.end_window()
            answered += sum(1 for f in futs if f.done)
            dirty = rng.integers(0, t, 8)
            key_inc[dirty] = 0
            key_inc[dirty, rng.integers(0, k, 8)] = 1
            r._dirty_rows.update(int(x) for x in dirty)
    sync(ctx)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    need(answered == windows * b, f"answered {answered}")
    need(launches["deps_join"] > 0 and launches["max_conflict"] > 0,
         f"service launched no kernel: {launches}")
    need(chk.calls["deps_join"] == launches["deps_join"], "uncounted launch")
    checked = chk.verify()
    st = svc.stats()
    return {"T": t, "K": k, "B": b, "windows": windows, "answered": answered,
            "checked_calls": checked, "launches": launches,
            "wall_s": wall, "queries_per_s": answered / wall,
            "index_incremental_refreshes": st["index_incremental_refreshes"],
            "index_full_uploads": st["index_full_uploads"]}


BURN_KW = dict(seed=7, ops=300, concurrency=64, nodes=3, rf=3, key_count=6,
               num_shards=1, durability=True, batch_window_us=5000,
               frontier_exec=True, resolver="tpu")


def phase_burn(ctx):
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.config import LocalConfig
    from cassandra_accord_tpu_torch.harness.burn import run_burn
    from cassandra_accord_tpu_torch.harness.trace import Trace, diff_traces
    from cassandra_accord_tpu_torch.ops import _kernels as K
    kw = dict(resolver_kind="tpu", tpu_tier="device", tpu_walk_max=0,
              tpu_walk_width=0, tpu_service="on", device=ctx["dev"])
    out = {}
    traces, results = [], []
    for backend in ("torch", "host"):
        cfg = LocalConfig.from_env(tpu_service_backend=backend, **kw)
        tr = Trace()
        t0 = time.perf_counter()
        if backend == "torch":
            with KernelRecorder(torch, K, every=10) as chk:
                K.reset_launches()                 # just before the main path
                res = run_burn(tracer=tr.hook, node_config=cfg, **BURN_KW)
                sync(ctx)
                launches = dict(K.LAUNCHES)        # just after it
            ctx["burn_launches"] = launches
            ctx["burn_checker"] = chk
        else:
            res = run_burn(tracer=tr.hook, node_config=cfg, **BURN_KW)
        wall = time.perf_counter() - t0
        traces.append(tr)
        results.append(res)
        out[backend] = {"wall_s": wall, "ops_ok": res.ops_ok,
                        "sim_micros": res.sim_micros,
                        "resolver_device_consults":
                            res.stats.get("resolver_device_consults", 0),
                        "resolver_service_batches":
                            res.stats.get("resolver_service_batches", 0)}
    dev_res = results[0]
    need(dev_res.stats.get("resolver_device_consults", 0) > 0,
         "burn made no device consult")
    need(all(v > 0 for v in ctx["burn_launches"].values()),
         f"burn did not launch every kernel: {ctx['burn_launches']}")
    div = diff_traces(*traces)
    need(div is None, f"torch-backend trace differs from host backend:\n{div}")
    outcome = [(r.ops_ok, r.ops_recovered, r.ops_nacked, r.ops_lost,
                r.ops_failed, r.sim_micros) for r in results]
    need(outcome[0] == outcome[1], f"outcomes differ: {outcome}")
    out.update(launches=ctx["burn_launches"],
               checked_calls=ctx["burn_checker"].verify(),
               trace_equal_to_host=True, verifier="pass")
    return out


def phase_replay(ctx):
    from cassandra_accord_tpu_torch.harness.consult_trace import (
        record_burn, scaled_replay)
    from cassandra_accord_tpu_torch.ops import _kernels as K
    os.environ["ACCORD_DEVICE"] = ctx["dev"]
    t0 = time.perf_counter()
    rec = record_burn(seed=7, ops=400, concurrency=64,
                      batch_window_us=5000, nodes=3, rf=3, key_count=6,
                      num_shards=1, durability=True)
    record_s = time.perf_counter() - t0
    K.reset_launches()
    t0 = time.perf_counter()
    # the host tier at this size casts the [T, K] index per query, so it
    # gets a short valve; the device tier a longer one (prefix replay,
    # labelled truncated, when the valve closes)
    with KernelRecorder(ctx["torch"], K, every=0) as chk:
        out = scaled_replay(rec, 32768, ["host", "device"], parity_sample=5,
                            tier_max_seconds={"host": 30.0, "device": 150.0})
    ctx["replay_checker"] = chk
    replay_s = time.perf_counter() - t0
    dev = out["tiers"]["device"]
    svc = dev.get("service", {})
    need(dev.get("device_consults", 0) > 0, "replay made no device consult")
    need(dev.get("parity_checked", 0) > 0, "replay checked no parity")
    launches = dict(K.LAUNCHES)
    need(launches["deps_join"] > 0, f"replay launched no kernel: {launches}")
    ctx["replay_launches"] = launches
    return {"record_s": record_s, "replay_s": replay_s,
            "copies": out["copies"], "txn_capacity": out["txn_capacity"],
            "key_capacity": out["key_capacity"],
            "index_bytes_int8": 2 * out["txn_capacity"] * out["key_capacity"],
            "final_indexed": dev.get("final_indexed"),
            "queries": dev.get("queries"),
            "device_consults": dev.get("device_consults"),
            "parity_checked": dev.get("parity_checked"),
            "truncated_at_event": dev.get("truncated_at_event"),
            "events_total": dev.get("events_total", out["merged_events"]),
            "device_queries_per_s": dev.get("queries_per_sec"),
            "host_queries_per_s": out["tiers"]["host"].get("queries_per_sec"),
            "service_batches": svc.get("batches"),
            "launches": launches}


ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "warm_ms", "wrapper_host_us", "shape", "path", "B",
            "T", "K", "nnz", "packed")


def kernels_line(ctx):
    """One entry per kernel: the main path's (the burn's) launch count and
    the numbers at the largest call it made; every other measured shape
    (the full-size synthetic ones, the replay's largest call) under
    ``shapes``, none of them launched on the main path."""
    for key, path in (("burn_checker", "burn"), ("replay_checker", "replay")):
        chk = ctx.get(key)
        if chk is not None:
            for name, (_size, args, kwargs) in sorted(chk.largest.items()):
                measure(ctx, name, f"{path}_largest", args, kwargs, 20, path)
    entries = []
    for name in REPLACES:
        rows = [r for r in ctx["rows"] if r["name"] == name]
        if not rows:
            continue
        head = next((r for r in rows if r["path"] == "burn"), rows[0])
        e = {"name": name, "route": "cuda", "source": SOURCE,
             "replaces": REPLACES[name],
             "launches": ctx.get("burn_launches", {}).get(name, 0),
             "replay_launches": ctx.get("replay_launches", {}).get(name, 0)}
        e.update({k: head[k] for k in ROW_KEYS})
        e["shapes"] = [dict({k: r[k] for k in ROW_KEYS}, main_path_launches=0)
                       for r in rows if r is not head]
        entries.append(e)
    return {"kernels": entries}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import cassandra_accord_tpu_torch  # noqa: F401
        from cassandra_accord_tpu_torch.ops import _kernels
    except ImportError as e:
        print(f"chip_smoke: the port package is not here: {e}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = {"torch": torch, "rows": [], "dev": "cuda",
           "real": {"deps_join": _kernels.deps_join,
                    "max_conflict": _kernels.max_conflict}}
    fns = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
           "service": phase_service, "burn": phase_burn,
           "replay": phase_replay}
    t_all = time.perf_counter()
    for name in PHASES:
        if name not in phases:
            continue
        if name != "env" and "flush" not in ctx:
            ctx["flush"] = torch.empty(128 << 20, dtype=torch.uint8,
                                       device="cuda")
        t0 = time.perf_counter()
        try:
            result = fns[name](ctx)
        except Exception as e:  # noqa: BLE001 — report, then fail the run
            import traceback
            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}"})
            return 1
        emit({"phase": name, "ok": True,
              "seconds": round(time.perf_counter() - t0, 3), **result})
    try:
        line = kernels_line(ctx)
    except Exception as e:  # noqa: BLE001
        import traceback
        traceback.print_exc()
        emit({"phase": "kernels_line", "ok": False, "error": str(e)})
        return 1
    if "env" not in phases:
        phase_env(ctx)
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_all, 3)})
    print(ctx["smi_line"], flush=True)
    emit(line)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
