#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cassandra_accord_tpu_torch) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py                  # every phase, as the acceptance run
    python3 chip_smoke.py --phases env,build,kernels   # a subset

Phases, one JSON line each; any failure exits non-zero:

1. env      torch/CUDA versions, nvcc, the card's name and power limit;
2. build    nvcc of csrc/consult.cu for sm_90a, with its time;
3. kernels  K1 (deps_join) and K2 (max_conflict) at full size against
            their plain torch versions, exactly (the eager answer and the
            graph replays' answers); device time per launch
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
            tenth kernel answer is checked against the plain version, the
            trace must equal the same burn on the host backend.  The same
            burn through the resolver's one-shot device path (no service)
            must equal it too;
6. graph    the conflict-graph model: txn_step at T=65,536, K=512,
            B=256 with a gc step every 8 (K1 launches counted, each K1
            answer held against its plain version, step ms, peak memory and
            the step's floor); a T=4,096 trajectory with padded batches,
            card against CPU bit for bit; closure/elide/SCC/Kahn at T=8,192
            dense against their edge twins, card against CPU; the edge
            kernels at T=1,048,576 (E ~ 8.4M), card against CPU;
7. mesh     the sharded data plane (parallel/, one process per rank over
            torch.distributed): four ranks over gloo on the one card
            (collectives staged through host memory; not a multi-card
            figure) run 16 sharded steps at T=65,536, K=512, B=256 from the
            graph phase's prefill, the store-sharded consult of four shape-A
            stores, the sharded closure at T=8,192 and the per-store
            frontier of four T=8,192 graphs; one rank over NCCL runs the
            same steps; each result equals the single card's (txn_step,
            consult, transitive_closure, kahn_frontier) exactly; then
            dryrun_multichip(4) over gloo (>= 1,000 live queries, both
            parity checks).  Per rank: step wall, device and collective ms,
            peak memory, K1 launches (16 each);
8. replay   a recorded burn replayed at T~32,768 through the host and
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
PHASES = ("env", "build", "kernels", "service", "burn", "graph", "mesh",
          "replay")

# H100 SXM data sheet (NVIDIA), dense rates at the 700 W limit: HBM3 at
# 3.35 TB/s; 67 TFLOP/s FP32 on the CUDA cores, the rate class the consult
# kernels' word ORs and int32 compares run in; 1,979 TOP/s int8 on the
# tensor cores, the rate of the dense form of the key-overlap product.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12
BF16_TENSOR_FLOPS_PER_S = 989e12

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


def device_ms(torch, fn, reps: int, flush=None, check=None) -> float:
    """Device ms per call of ``fn``: ``reps`` back-to-back calls captured in
    one CUDA graph and replayed between one event pair, so no host work
    (argument checks, the ctypes call) sits in the window.  With ``flush``
    every call follows an L2 flush (the index read cold, as after other
    work), and the flushes alone, captured the same way, are subtracted.
    ``check(replay)``, when given, runs after the timed replay, while the
    graph is alive."""
    def calls():
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
    graph = _graph(torch, calls)
    total = _elapsed_ms(torch, graph.replay)
    if check is not None:
        check(graph.replay)
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


def _kernel_case(ctx, label, t, k, b, keys_per_txn, iters, packed=(False, True),
                 wide=0):
    """K1 (unpacked, and bit-packed where ``packed`` says) and K2 on one
    synthetic index and query batch; with ``wide`` the first query row takes
    that many random columns, duplicates included."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    dev = torch.device(ctx["dev"])
    rng = np.random.default_rng(7)
    key_inc, live, lanes, ts, kind, status, active = make_index(
        np, rng, t, k, keys_per_txn)
    rows, before, qkind = make_queries(np, rng, b, k, t, keys_per_txn)
    if wide:
        rows[0] = sorted(int(c) for c in rng.integers(0, k, wide))
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
    """One kernel at one shape: exact check against the plain version (the
    eager call's answer, and the last graph replay's of each timing, also
    after its output was overwritten and the graph replayed once more),
    then kernel (cold and warm L2), plain and library times, the wrapper's
    host cost and the bound.  ``path`` says where the shape came from."""
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    kern = ctx["real"][name]
    plain = getattr(K, f"{name}_plain")
    got = kern(*args, **kwargs)
    want = plain(*args, **kwargs)
    sync(ctx)
    errs = [max_abs_err(torch, got, want)]
    flush = ctx["flush"]
    last = [None]

    def call():
        last[0] = kern(*args, **kwargs)

    def check(replay):
        sync(ctx)
        errs.append(max_abs_err(torch, last[0], want))
        last[0].copy_(torch.bitwise_not(want))
        replay()
        sync(ctx)
        errs.append(max_abs_err(torch, last[0], want))
    ms = device_ms(torch, call, iters, flush, check)
    warm_ms = device_ms(torch, call, iters, None, check)
    # the method's own floor at this rep count: a one-element add timed the
    # same way (the graph launch's fixed cost is spread over ``iters``)
    floor_ms = ctx["floors"].get(iters)
    if floor_ms is None:
        one = torch.zeros(1, device=ctx["dev"])
        floor_ms = ctx["floors"][iters] = device_ms(
            torch, lambda: one.add_(1), iters, flush)
    err = max(errs)
    need(err == 0, f"{name} [{label}] differs from its plain version: "
         f"max_abs_err {errs} (eager, then cold and warm graph replays)")
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
           "method_floor_ms": floor_ms,
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
    rows += _kernel_case(ctx, "T1003_K64_B13_2keys", 1003, 64, 13, 2, 20,
                         packed=(False,))
    # the burn's window shape (its largest calls are timed after the burn)
    rows += _kernel_case(ctx, "burnlike_T256_K16_B8_2keys", 256, 16, 8, 2, 20)
    # two tiles, the second with one slot (byte loads, cross-tile fold)
    rows += _kernel_case(ctx, "T2049_K64_B13_2keys", 2049, 64, 13, 2, 20,
                         packed=(False,))
    # a row of 5,000 columns (duplicates), wider than a block's CSR stage
    rows += _kernel_case(ctx, "wide_T65536_K512_B9_5000cols", 65536, 512, 9,
                         2, 5, packed=(False,), wide=5000)
    return {"cases": [dict({k: r[k] for k in ("name", "shape", "max_abs_err",
                                              "ms", "warm_ms",
                                              "method_floor_ms",
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
              tpu_walk_width=0, device=ctx["dev"])
    # the main path (the service on the card), the resolver's one-shot
    # device path (no service: one K1 and one K2 launch per consult batch)
    # and the host backend, which both must equal
    runs = {"torch": dict(tpu_service="on", tpu_service_backend="torch"),
            "oneshot": dict(tpu_service="off"),
            "host": dict(tpu_service="on", tpu_service_backend="host")}
    out, traces, results, checkers = {}, {}, {}, {}
    for name, knobs in runs.items():
        cfg = LocalConfig.from_env(**kw, **knobs)
        tr = Trace()
        t0 = time.perf_counter()
        if name == "host":
            res = run_burn(tracer=tr.hook, node_config=cfg, **BURN_KW)
        else:
            with KernelRecorder(torch, K, every=10) as chk:
                K.reset_launches()                 # just before the run
                res = run_burn(tracer=tr.hook, node_config=cfg, **BURN_KW)
                sync(ctx)
                launches = dict(K.LAUNCHES)        # just after it
            checkers[name] = chk
            need(all(v > 0 for v in launches.values()),
                 f"{name} burn did not launch every kernel: {launches}")
            need(res.stats.get("resolver_device_consults", 0) > 0,
                 f"{name} burn made no device consult")
            if name == "torch":
                ctx["burn_launches"] = launches
                ctx["burn_checker"] = chk
            else:
                out["oneshot_launches"] = launches
        wall = time.perf_counter() - t0
        traces[name] = tr
        results[name] = res
        out[name] = {"wall_s": wall, "ops_ok": res.ops_ok,
                     "sim_micros": res.sim_micros,
                     "resolver_device_consults":
                         res.stats.get("resolver_device_consults", 0),
                     "resolver_service_batches":
                         res.stats.get("resolver_service_batches", 0)}

    def outcome(r):
        return (r.ops_ok, r.ops_recovered, r.ops_nacked, r.ops_lost,
                r.ops_failed, r.sim_micros)
    for name in ("torch", "oneshot"):
        div = diff_traces(traces[name], traces["host"])
        need(div is None, f"{name} trace differs from the host backend's:\n"
             f"{div}")
        need(outcome(results[name]) == outcome(results["host"]),
             f"{name} outcomes differ from the host backend's: "
             f"{outcome(results[name])} vs {outcome(results['host'])}")
    out.update(launches=ctx["burn_launches"],
               checked_calls=ctx["burn_checker"].verify(),
               oneshot_checked_calls=checkers["oneshot"].verify(),
               trace_equal_to_host=True, oneshot_trace_equal_to_host=True,
               verifier="pass")
    return out


# the graph phase's shapes: txn_step at kernel shape A's widths (bench.py
# :214) over a half-full 65,536-slot state; the trajectory checked against
# the CPU; BASELINE config 5's bench graph (bench.py:378-409) at T=8,192
# for the dense ops and at its own 1,048,576 txns for the edge kernels
GRAPH = dict(T=65536, K=512, B=256, steps=40, gc_every=8,
             traj_T=4096, traj_K=512, traj_B=64, traj_steps=16,
             ops_T=8192, edges_T=1 << 20, deps_per_txn=8, budget_s=120.0)


def _prefill(np, rng, t, k, n):
    """A GraphState as numpy fields: slots [0, n) hold make_index's txns
    (60% APPLIED, 5% INVALIDATED, 35% STABLE, with n // 8 wait edges from
    later to earlier STABLE txns), the rest are free.  ``adj`` is a ``Coo``
    of those edges (dense it is 4 GiB at T = 65,536): ``_state_on`` builds
    it on the device, a rank only its own rows."""
    from cassandra_accord_tpu_torch.ops import graph_state as gs
    from cassandra_accord_tpu_torch.parallel.mesh import Coo
    key_inc, _live, lanes, ts, kind, _st, _act = make_index(np, rng, n, k, 2)
    f = {"key_inc": np.zeros((t, k), np.int8),
         "ts": np.zeros((t, 5), np.int32), "txn_id": np.zeros((t, 5), np.int32),
         "kind": np.zeros(t, np.int8), "status": np.zeros(t, np.int8),
         "active": np.zeros(t, bool)}
    f["key_inc"][:n], f["ts"][:n], f["txn_id"][:n] = key_inc, ts, lanes
    f["kind"][:n] = kind
    f["status"][:n] = rng.choice([gs.APPLIED, gs.INVALIDATED, gs.STABLE], n,
                                 p=[0.6, 0.05, 0.35])
    f["active"][:n] = True
    stable = np.flatnonzero(f["status"] == gs.STABLE)
    i, j = rng.choice(stable, n // 8), rng.choice(stable, n // 8)
    later = lanes[i, 2] > lanes[j, 2]
    waiter, dep = np.where(later, i, j), np.where(later, j, i)
    f["adj"] = Coo((waiter[i != j], dep[i != j]), (t, t))
    return f


def _state_on(torch, fields, dev):
    """``_prefill``'s fields as a GraphState on ``dev``, the adjacency
    built there from its edges."""
    import numpy as np
    from cassandra_accord_tpu_torch.ops import graph_state as gs
    coo = fields["adj"]
    state = gs.state_from_numpy(dict(fields, adj=np.zeros((0, 0), np.int8)),
                                dev)
    adj = torch.zeros(coo.shape, dtype=torch.int8, device=state.ts.device)
    adj[tuple(torch.from_numpy(np.asarray(x, np.int64)).to(adj.device)
              for x in coo.index)] = 1
    return state._replace(adj=adj)


def _batch_fields(np, rng, t, k, b, hlc0, slots, n_valid):
    """One batch as numpy fields: make_queries' 2-key rows (half on the hot
    keys), TxnIds hlc0, hlc0+1, ...; rows from ``n_valid`` on are padding."""
    rows, _before, qkind = make_queries(np, rng, b, k, t, 2)
    key_inc = np.zeros((b, k), np.int8)
    for r, cols in enumerate(rows):
        key_inc[r, cols] = 1
    lanes = np.zeros((b, 5), np.int32)
    lanes[:, 0] = 1
    lanes[:, 2] = hlc0 + np.arange(b)
    lanes[:, 4] = rng.integers(1, 16, b)
    return dict(slots=np.asarray(slots, np.int32), key_inc=key_inc,
                txn_id=lanes, kind=qkind, valid=np.arange(b) < n_valid)


def _watermark(np, hlc):
    return np.array([1, 0, hlc, 0, 0], np.int32)


class JoinCheck:
    """Installed over ``_kernels.deps_join`` while the graph path runs: the
    real wrapper does every launch (and its count); each call's inputs are
    copied, because the step then writes the state in place, and
    ``verify`` holds each answer against the plain version exactly."""

    def __init__(self, torch, kmod):
        self.torch, self.k = torch, kmod
        self.real = kmod.deps_join
        self.pending, self.checked, self.last = [], 0, None

    def call(self, *args, **kwargs):
        got = self.real(*args, **kwargs)
        self.pending.append(
            (tuple(a.clone() if isinstance(a, self.torch.Tensor) else a
                   for a in args), kwargs, got))
        return got

    def verify(self):
        for args, kwargs, got in self.pending:
            want = self.k.deps_join_plain(*args, **kwargs)
            need(self.torch.equal(got, want),
                 "deps_join differs from its plain version on the graph path")
            self.checked += 1
            self.last = (args, kwargs)
        self.pending = []

    def __enter__(self):
        self.k.deps_join = self.call
        return self

    def __exit__(self, *exc):
        self.k.deps_join = self.real


def _device_edges(torch, adj, rows_per_chunk):
    """(src, dst) int32 of the [T, T] adjacency's nonzeros in row-major
    order, found on the card a block of rows at a time."""
    from cassandra_accord_tpu_torch.parallel.launch import nonzero_rows
    nz = nonzero_rows(adj, rows_per_chunk).to(torch.int32)
    return nz[:, 0].contiguous(), nz[:, 1].contiguous()


def _stats(xs):
    ys = sorted(xs)
    return {"n": len(ys), "median": ys[len(ys) // 2], "mean": sum(ys) / len(ys),
            "min": ys[0], "max": ys[-1]}


def _profile(torch, fn, top=10):
    """``fn`` under torch.profiler (CPU and CUDA activity): its wall ms, the
    device ms summed over its kernels, their share of the wall time, and
    the ops that took the most device time (self time, ms, calls)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    def on_card(e):   # kernels and copies, not the ops that launched them
        return str(getattr(e, "device_type", "")).endswith("CUDA")
    rows = sorted((e for e in prof.key_averages() if on_card(e)), key=dev_us,
                  reverse=True)
    device = sum(dev_us(e) for e in rows) / 1e3
    return {"wall_ms": wall, "device_ms": device,
            "device_busy_share": device / wall if wall else None,
            "top": [[e.key[:200], dev_us(e) / 1e3, e.count]
                    for e in rows[:top]]}


def _graph_step(ctx):
    """txn_step at full width: the graph path's K1 launches, each answer
    held against the plain version, step times beside the floor."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.models import conflict_graph as cg
    from cassandra_accord_tpu_torch.ops import _kernels as K
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    from cassandra_accord_tpu_torch.ops import frontier_kernels as fk
    from cassandra_accord_tpu_torch.ops import graph_state as gs
    t, k, b = GRAPH["T"], GRAPH["K"], GRAPH["B"]
    steps, every = GRAPH["steps"], GRAPH["gc_every"]
    dev = ctx["dev"]
    rng = np.random.default_rng(17)
    n0 = t // 2
    t0 = time.perf_counter()
    fields = _prefill(np, rng, t, k, n0)
    state = _state_on(torch, fields, dev)
    del fields
    sync(ctx)
    prefill_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    step_ms, wall_ms, gc_ms, applied, cand = [], [], [], [], []
    gc_evicted = reused = 0
    freed = set()
    with JoinCheck(torch, K) as chk:
        K.reset_launches()                        # just before the path
        for step in range(steps):
            free = torch.nonzero(~state.active)[:b, 0].cpu().numpy()
            need(len(free) == b, f"step {step}: {len(free)} free slots")
            reused += len(freed & set(free.tolist()))
            hlc0 = 1000 + n0 + step * b
            f = _batch_fields(np, rng, t, k, b, hlc0, free, b)
            batch = cg.TxnBatch(**{n: torch.from_numpy(v).to(dev)
                                   for n, v in f.items()})
            sync(ctx)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            w0 = time.perf_counter()
            e0.record()
            state, deps, done = cg.txn_step(state, batch)
            e1.record()
            e1.synchronize()
            wall_ms.append((time.perf_counter() - w0) * 1e3)
            step_ms.append(e0.elapsed_time(e1))
            applied.append(int(done.sum()))
            # rows the frontier read: applied now, or still STABLE
            cand.append(applied[-1] + int(
                ((state.status == gs.STABLE) & state.active).sum()))
            chk.verify()
            if (step + 1) % every == 0:
                before = state.active.clone()
                wm = torch.from_numpy(_watermark(np, hlc0 - 4 * b)).to(dev)
                g0 = torch.cuda.Event(enable_timing=True)
                g1 = torch.cuda.Event(enable_timing=True)
                g0.record()
                state = cg.gc_step(state, wm)
                g1.record()
                g1.synchronize()
                gc_ms.append(g0.elapsed_time(g1))
                ev = before & ~state.active
                gc_evicted += int(ev.sum())
                freed |= set(torch.nonzero(ev)[:, 0].cpu().tolist())
        sync(ctx)
        launches = dict(K.LAUNCHES)               # just after it

    # where a step's and a gc step's time goes (after the counted path):
    # batches made and uploaded first, slots picked as in the loop
    extra = [_batch_fields(np, rng, t, k, b, 1000 + n0 + (steps + i) * b,
                           np.zeros(b), b) for i in range(8)]
    extra = [cg.TxnBatch(**{n: torch.from_numpy(v).to(dev)
                            for n, v in f.items()}) for f in extra]

    def more_steps(batches):
        nonlocal state
        for bt in batches:
            free = torch.nonzero(~state.active)[:b, 0].to(torch.int32)
            state, _d, _a = cg.txn_step(state, bt._replace(slots=free))
    more_steps(extra[:4])
    profiles = {"txn_step_x4": _profile(torch, lambda: more_steps(extra[4:]))}
    wm = torch.from_numpy(_watermark(np, 1000 + n0 + (steps + 8) * b)).to(dev)
    profiles["gc_step"] = _profile(torch, lambda: cg.gc_step(state, wm))
    peak = torch.cuda.max_memory_allocated()
    need(launches["deps_join"] == steps,
         f"the graph path launched K1 {launches['deps_join']} times, "
         f"expected one per step ({steps})")
    need(chk.checked == steps, f"{chk.checked} K1 answers checked")
    need(gc_evicted > 0 and reused > 0,
         f"no slot recycled: evicted {gc_evicted}, reused {reused}")
    need(sum(applied) > 0, "no txn applied")
    ctx["graph_launches"] = launches
    ctx["graph_join"] = chk.last
    # the final state's frontier: dense product against the edge kernel
    ready = dk.kahn_frontier(state.adj, state.status, state.active)
    src, dst = _device_edges(torch, state.adj, 4096)
    ready_e = fk.kahn_frontier_edges(
        src, dst, torch.ones_like(src, dtype=torch.bool), state.status,
        state.active)
    need(torch.equal(ready, ready_e),
         "full-width frontier: dense differs from the edge kernel")
    # eager: the frontier reads its candidate rows back, so no graph capture
    frontier_ms = eager_ms(
        torch, lambda: dk.kahn_frontier(state.adj, state.status, state.active),
        5, ctx["flush"])
    # floors: one read of adj (the reference's frontier multiplies every
    # row); and the data's: the adjacency rows this run's frontier needed
    # (its candidates) read, the batch's rows and deps mask written, the
    # key incidence read once
    floor_ms = t * t / HBM_BYTES_PER_S * 1e3
    data_floor_ms = [(c * t + 2 * b * t + t * k) / HBM_BYTES_PER_S * 1e3
                     for c in cand]
    out = {"T": t, "K": k, "B": b, "steps": steps, "gc_every": every,
           "prefilled": n0, "prefill_s": prefill_s,
           "k1_launches": launches["deps_join"],
           "k1_checked": chk.checked, "applied_per_step": applied,
           "edges_final": int(src.numel()), "gc_evicted": gc_evicted,
           "slots_reused": reused,
           "frontier_rows": _stats(cand),
           "step_ms": _stats(step_ms), "wall_ms": _stats(wall_ms),
           "gc_ms": _stats(gc_ms), "frontier_ms": frontier_ms,
           "floor_ms": floor_ms, "data_floor_ms": _stats(data_floor_ms),
           "gc_floor_extra_ms": 2 * floor_ms,
           "profiles": profiles,
           "peak_bytes": peak, "state_bytes": sum(
               x.numel() * x.element_size() for x in state)}
    del state, deps, done, ready, ready_e, src, dst
    return out


def _graph_trajectory(ctx):
    """16 txn_steps at T=4,096 on the card and on the CPU through the same
    port functions, partial padded batches and one gc step: every step's
    deps and applied masks and the final state equal bit for bit."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.models import conflict_graph as cg
    from cassandra_accord_tpu_torch.ops import graph_state as gs
    t, k, b = GRAPH["traj_T"], GRAPH["traj_K"], GRAPH["traj_B"]
    rng = np.random.default_rng(19)
    n0 = t // 2
    fields = _prefill(np, rng, t, k, n0)
    devs = (ctx["dev"], "cpu")
    states = {d: _state_on(torch, fields, d) for d in devs}
    applied = 0
    for step in range(GRAPH["traj_steps"]):
        n_valid = b if step % 4 else int(rng.integers(1, b))
        free = np.flatnonzero(~states["cpu"].active.numpy())
        slots = rng.integers(0, t, b)
        slots[:n_valid] = free[:n_valid]
        f = _batch_fields(np, rng, t, k, b, 1000 + n0 + step * b, slots,
                          n_valid)
        outs = []
        for d in devs:
            batch = cg.TxnBatch(**{n: torch.from_numpy(v).to(d)
                                   for n, v in f.items()})
            states[d], deps, done = cg.txn_step(states[d], batch)
            outs.append((deps.cpu(), done.cpu()))
        need(torch.equal(outs[0][0], outs[1][0]),
             f"trajectory step {step}: deps differ card vs CPU")
        need(torch.equal(outs[0][1], outs[1][1]),
             f"trajectory step {step}: applied differs card vs CPU")
        applied += int(outs[1][1].sum())
        if step == 7:
            wm = _watermark(np, 1000 + n0 + 4 * b)
            for d in devs:
                states[d] = cg.gc_step(states[d], torch.from_numpy(wm).to(d))
    a, c = (gs.state_to_numpy(states[d]) for d in devs)
    for name in a:
        need(np.array_equal(a[name], c[name]),
             f"trajectory final state: {name} differs card vs CPU")
    need(applied > 0, "trajectory applied nothing")
    return {"T": t, "K": k, "B": b, "steps": GRAPH["traj_steps"],
            "applied": applied, "equal_to_cpu": True}


def _graph_ops(ctx):
    """Closure, elision, SCC, Kahn levels and the frontier on config 5's
    bench graph: dense on the card, equal to their edge twins on the card,
    which equal the same calls on the CPU."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    from cassandra_accord_tpu_torch.ops import frontier_kernels as fk
    from cassandra_accord_tpu_torch.ops import graph_state as gs
    t = GRAPH["ops_T"]
    rng = np.random.default_rng(9)
    adj = (rng.random((t, t)) < (GRAPH["deps_per_txn"] / t)).astype(np.int8)
    np.fill_diagonal(adj, 0)
    status = np.full((t,), gs.STABLE, np.int8)
    active = np.ones((t,), bool)
    dev = ctx["dev"]
    a, st, act = (torch.from_numpy(x).to(dev) for x in (adj, status, active))
    cases = {
        "transitive_closure": (lambda: dk.transitive_closure(a),
                               lambda d: fk.transitive_closure_csr(adj, d)),
        "elide": (lambda: dk.elide(a), lambda d: fk.elide_csr(adj, d)),
        "scc_condense": (lambda: dk.scc_condense(a, act),
                         lambda d: fk.scc_condense_csr(adj, active, d)),
        "kahn_levels": (lambda: dk.kahn_levels(a, act),
                        lambda d: fk.kahn_levels_csr(adj, active, d)),
        "kahn_frontier": (lambda: dk.kahn_frontier(a, st, act),
                          lambda d: fk.kahn_frontier_csr(adj, status, active,
                                                         d)),
    }
    out = {"T": t, "edges": int(adj.sum())}
    for name, (dense, twin) in cases.items():
        dense()
        sync(ctx)
        ms = _elapsed_ms(torch, dense)
        got = dense()
        got = [x.cpu().numpy() for x in got] if isinstance(got, tuple) \
            else [got.cpu().numpy()]
        w0 = time.perf_counter()
        on_card = twin(dev)
        twin_card_ms = (time.perf_counter() - w0) * 1e3
        w0 = time.perf_counter()
        on_cpu = twin("cpu")
        twin_cpu_ms = (time.perf_counter() - w0) * 1e3
        on_card = list(on_card) if isinstance(on_card, tuple) else [on_card]
        on_cpu = list(on_cpu) if isinstance(on_cpu, tuple) else [on_cpu]
        for x, y, z in zip(got, on_card, on_cpu):
            need(np.array_equal(x, y), f"{name}: dense differs from its edge "
                 f"twin on the card at T={t}")
            need(np.array_equal(y, z), f"{name}: edge twin differs card vs "
                 f"CPU at T={t}")
        out[name] = {"dense_ms": ms, "twin_card_wall_ms": twin_card_ms,
                     "twin_cpu_wall_ms": twin_cpu_ms}
    squarings = max(1, int(t - 1).bit_length())
    flops = squarings * 2.0 * t ** 3
    out["transitive_closure"].update(
        squarings=squarings, flops=flops,
        bound_ms=flops / BF16_TENSOR_FLOPS_PER_S * 1e3, bound_by="operations")
    return out


def _graph_edges(ctx):
    """The edge kernels at config 5's own size, T=1,048,576 with ~8 deps per
    txn, from a seeded generator (no dense matrix): card against CPU."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import frontier_kernels as fk
    from cassandra_accord_tpu_torch.ops import graph_state as gs
    t = GRAPH["edges_T"]
    rng = np.random.default_rng(9)
    e = GRAPH["deps_per_txn"] * t
    src = rng.integers(0, t, e).astype(np.int32)
    dst = rng.integers(0, t, e).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    s, d, v = fk._pad_edges(src, dst, fk._pow2(len(src)))
    status = np.full((t,), gs.STABLE, np.int8)
    status[rng.random(t) < 0.3] = gs.APPLIED
    active = rng.random(t) < 0.99
    runs = {}
    for dv in (ctx["dev"], "cpu"):
        ts_ = [torch.from_numpy(x).to(dv) for x in (s, d, v, status, active)]
        res, times, rounds = {}, {}, {}
        for name, fn, args in (
                ("kahn_frontier_edges", fk.kahn_frontier_edges, ts_),
                ("kahn_levels_edges", fk.kahn_levels_edges,
                 ts_[:3] + ts_[4:]),
                ("scc_condense_edges", fk.scc_condense_edges,
                 ts_[:3] + ts_[4:])):
            fk.reset_rounds()
            if dv != "cpu":
                sync(ctx)
            w0 = time.perf_counter()
            r = fn(*args)
            r = [x.cpu().numpy() for x in r] if isinstance(r, tuple) \
                else [r.cpu().numpy()]
            times[name] = (time.perf_counter() - w0) * 1e3
            res[name] = r
            rounds[name] = {k2: n for k2, n in fk.ROUNDS.items() if n}
        runs[dv] = (res, times, rounds)
    (card, card_ms, card_rounds), (cpu, cpu_ms, cpu_rounds) = \
        runs[ctx["dev"]], runs["cpu"]
    for name in card:
        for x, y in zip(card[name], cpu[name]):
            need(np.array_equal(x, y), f"{name}: card differs from CPU at "
                 f"T={t}")
        need(card_rounds[name] == cpu_rounds[name],
             f"{name}: rounds differ card vs CPU")
    labels, level = card["scc_condense_edges"]
    return {"T": t, "edges": int(len(src)), "edge_slots": int(len(s)),
            "card_wall_ms": card_ms, "cpu_wall_ms": cpu_ms,
            "rounds": card_rounds,
            "ready": int(card["kahn_frontier_edges"][0].sum()),
            "kahn_levels": int(card["kahn_levels_edges"][0].max()) + 1,
            "components": int(len(np.unique(labels[labels >= 0]))),
            "largest_component": int(np.bincount(labels[labels >= 0]).max()),
            "condensed_levels": int(level.max()) + 1,
            "equal_to_cpu": True}


def phase_graph(ctx):
    t0 = time.perf_counter()
    out = {"step": _graph_step(ctx), "trajectory": _graph_trajectory(ctx),
           "ops": _graph_ops(ctx), "edges": _graph_edges(ctx)}
    seconds = time.perf_counter() - t0
    need(seconds <= GRAPH["budget_s"],
         f"graph phase took {seconds:.1f} s > {GRAPH['budget_s']} s")
    return out


# the mesh phase's shapes: the graph phase's txn_step state and batches
# over four ranks on the one card (16,384 rows each); four stores at
# kernel shape A, one per rank; config 5's graph at T=8,192 for the closure
# and four such graphs for the per-store frontier
MESH = dict(T=65536, K=512, B=256, steps=16, ranks=4, ops_T=8192,
            deps_per_txn=8, budget_s=120.0, timeout_s=300.0)


def _mesh_step_inputs(np):
    """The graph phase's prefill (32,768 slots) and 16 batches of all-valid
    rows on distinct free slots, drawn across the free half."""
    t, k, b, steps = MESH["T"], MESH["K"], MESH["B"], MESH["steps"]
    rng = np.random.default_rng(23)
    n0 = t // 2
    fields = _prefill(np, rng, t, k, n0)
    slots = rng.permutation(np.arange(n0, t))[:steps * b]
    batches = [_batch_fields(np, rng, t, k, b, 1000 + n0 + s * b,
                             slots[s * b:(s + 1) * b], b)
               for s in range(steps)]
    return fields, batches


def _mesh_stores(np):
    """Four stores at shape A (T=65,536, K=512, B=256, 2 keys per txn, half
    on 8 hot keys), store-stacked as the consult takes them."""
    t, k, b, n = MESH["T"], MESH["K"], MESH["B"], MESH["ranks"]
    rng = np.random.default_rng(29)
    cols = [[] for _ in range(10)]
    for _ in range(n):
        key_inc, live, lanes, ts, kind, status, active = make_index(
            np, rng, t, k, 2)
        rows, before, qkind = make_queries(np, rng, b, k, t, 2)
        q = np.zeros((b, k), np.int8)
        for r, c in enumerate(rows):
            q[r, c] = 1
        for col, x in zip(cols, (live, key_inc, ts, lanes, kind, status,
                                 active, q, before, qkind)):
            col.append(x)
    return tuple(np.stack(c) for c in cols)


def _mesh_graphs(np):
    """Config 5's bench graph at T=8,192 (as the graph phase draws it) for
    the closure, and four such graphs, as edges, for the frontier."""
    from cassandra_accord_tpu_torch.ops import graph_state as gs
    from cassandra_accord_tpu_torch.parallel.mesh import Coo
    t, n = MESH["ops_T"], MESH["ranks"]
    rng = np.random.default_rng(9)
    adj = (rng.random((t, t)) < (MESH["deps_per_txn"] / t)).astype(np.int8)
    np.fill_diagonal(adj, 0)
    rng = np.random.default_rng(31)
    e = MESH["deps_per_txn"] * t
    store = np.repeat(np.arange(n), e)
    src = rng.integers(0, t, n * e)
    dst = rng.integers(0, t, n * e)
    keep = src != dst
    coo = Coo((store[keep], src[keep], dst[keep]), (n, t, t))
    status = np.where(rng.random((n, t)) < 0.3, gs.APPLIED,
                      gs.STABLE).astype(np.int8)
    active = rng.random((n, t)) < 0.99
    return adj, coo, status, active


def _rank_numbers(np, results, key):
    """Per rank: medians of the steps' wall, device and collective ms, the
    steps' K1 launches and peak bytes."""
    out = []
    for r in results:
        v = r.value[key] if key is not None else r.value
        times = v["times"]
        med = {m: float(np.median([x[m] for x in times]))
               if times[0][m] is not None else None
               for m in ("wall_ms", "device_ms", "collective_ms")}
        out.append(dict(med, k1_launches=sum(
            x["launches"]["deps_join"] for x in times),
            peak_bytes=v["peak_bytes"]))
    return out


def _check_mesh_steps(np, torch, results, want, final, label):
    """Each rank's per-step conflict_max and applied against the single
    card's, and its final local state against its rows of the single
    card's final state (``final``: numpy fields, adj as [E, 2] + values)."""
    rows = final["key_inc"].shape[0] // len(results)
    idx, vals = [], []
    for r, res in enumerate(results):
        v = res.value[0] if isinstance(res.value, list) else res.value
        for i, (cmax, applied) in enumerate(want):
            need(np.array_equal(v["conflict_max"][i], cmax),
                 f"{label}: rank {r} step {i} conflict_max differs from "
                 "the single card's")
            need(np.array_equal(v["applied"][i], applied),
                 f"{label}: rank {r} step {i} applied differs")
        st = v["state"]
        for name in ("key_inc", "ts", "txn_id", "kind", "status", "active"):
            need(np.array_equal(st[name],
                                final[name][r * rows:(r + 1) * rows]),
                 f"{label}: rank {r} final {name} differs")
        idx.append(st["adj_index"] + np.array([r * rows, 0]))
        vals.append(st["adj_values"])
    need(np.array_equal(np.concatenate(idx), final["adj_index"])
         and np.array_equal(np.concatenate(vals), final["adj_values"]),
         f"{label}: final adjacency differs")


def phase_mesh(ctx):
    """The sharded data plane (parallel/) in four ranks over gloo on the
    one card, and in one rank over NCCL, each held against the single
    card; then dryrun_multichip(4) over gloo."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.entry import dryrun_multichip
    from cassandra_accord_tpu_torch.models import conflict_graph as cg
    from cassandra_accord_tpu_torch.ops import _kernels as K
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    from cassandra_accord_tpu_torch.parallel import launch
    from cassandra_accord_tpu_torch.parallel import live_dryrun as ld
    t0 = time.perf_counter()
    n, dev = MESH["ranks"], ctx["dev"]
    fields, batches = _mesh_step_inputs(np)
    stores = _mesh_stores(np)
    adj8k, coo, fstatus, factive = _mesh_graphs(np)
    inputs_s = time.perf_counter() - t0

    # ---- four ranks over gloo on the card: every rank program -----------
    calls = [(launch.steps_rank, (fields, batches)),
             (launch.store_consult_rank, (stores,)),
             (launch.closure_rank, (adj8k,)),
             (launch.frontier_rank, (coo, fstatus, factive))]
    w0 = time.perf_counter()
    gloo = launch.run_ranks(n, launch.sequence, (calls,), device=dev,
                            backend="gloo", timeout_s=MESH["timeout_s"])
    gloo_s = time.perf_counter() - w0
    # ---- one rank over NCCL: the same steps ------------------------------
    w0 = time.perf_counter()
    nccl = launch.run_ranks(1, launch.steps_rank, (fields, batches),
                            device=dev, backend="nccl",
                            timeout_s=MESH["timeout_s"])
    nccl_s = time.perf_counter() - w0

    # ---- the single card: txn_step on the same state and batches ---------
    state = _state_on(torch, fields, dev)
    want = []
    with JoinCheck(torch, K) as chk:
        for f in batches:
            batch = cg.TxnBatch(**{k: torch.from_numpy(v).to(dev)
                                   for k, v in f.items()})
            ts_pre = state.ts.clone()
            state, deps, applied = cg.txn_step(state, batch)
            want.append((dk.max_conflict_ts(ts_pre, deps)[0].cpu().numpy(),
                         applied.cpu().numpy()))
            chk.verify()
    nz = launch.nonzero_rows(state.adj)
    final = {name: getattr(state, name).cpu().numpy()
             for name in ("key_inc", "ts", "txn_id", "kind", "status",
                          "active")}
    final["adj_index"] = nz.cpu().numpy()
    final["adj_values"] = state.adj[nz[:, 0], nz[:, 1]].cpu().numpy()
    del state, deps, nz
    _check_mesh_steps(np, torch, gloo, want, final, "gloo x4")
    _check_mesh_steps(np, torch, nccl, want, final, "nccl x1")
    applied_total = int(sum(a.sum() for _, a in want))
    need(applied_total > 0, "the mesh steps applied nothing")
    rows = MESH["T"] // n
    ctx["mesh_join"] = (
        (dk.incidence_T(torch.from_numpy(fields["key_inc"][:rows]).to(dev)),
         torch.from_numpy(fields["txn_id"][:rows]).to(dev),
         torch.from_numpy(fields["kind"][:rows]).to(dev),
         torch.from_numpy(fields["status"][:rows]).to(dev),
         torch.from_numpy(fields["active"][:rows]).to(dev),
         *dk.query_csr(torch.from_numpy(batches[0]["key_inc"]).to(dev)),
         torch.from_numpy(batches[0]["txn_id"]).to(dev),
         torch.from_numpy(batches[0]["kind"]).to(dev)), {})

    # ---- the store consult: each store on one card, and across stores ----
    lanes = []
    for s in range(n):
        d1, m1 = dk.consult(*(torch.from_numpy(np.ascontiguousarray(x[s]))
                              .to(dev) for x in stores))
        res = gloo[s].value[1]
        need(np.array_equal(res["deps"][0], d1.cpu().numpy()),
             f"store {s}: sharded deps differ from the single-store consult")
        need(np.array_equal(res["max_lanes"][0], m1.cpu().numpy()),
             f"store {s}: sharded max differs from the single-store consult")
        lanes.append(m1.cpu().numpy())
    expect = ld.host_lex_max(np.stack(lanes).transpose(1, 0, 2),
                             np.ones((MESH["B"], n), dtype=bool))
    for r in gloo:
        need(np.array_equal(r.value[1]["global_max"], expect),
             "cross-store max differs from host_lex_max")
    s0 = tuple(torch.from_numpy(np.ascontiguousarray(x[0])).to(dev)
               for x in stores)
    offsets, cols = dk.query_csr(s0[7])
    ctx["mesh_consult"] = (
        (dk.incidence_T(s0[0]), s0[3], s0[4], s0[5], s0[6], offsets, cols,
         s0[8], s0[9]),
        (dk.incidence_T(s0[1]), s0[2], s0[3], s0[6], offsets, cols))

    # ---- closure and frontier against one card ---------------------------
    reach = np.concatenate([r.value[2]["reach"] for r in gloo])
    need(np.array_equal(reach, dk.transitive_closure(
        torch.from_numpy(adj8k).to(dev)).cpu().numpy()),
         "sharded closure differs from the single card's")
    ready = np.concatenate([r.value[3]["ready"] for r in gloo])
    for s in range(n):
        a = torch.zeros(coo.shape[1:], dtype=torch.int8, device=dev)
        m = coo.index[0] == s
        a[torch.from_numpy(coo.index[1][m]).to(dev),
          torch.from_numpy(coo.index[2][m]).to(dev)] = 1
        want_r = dk.kahn_frontier(a, torch.from_numpy(fstatus[s]).to(dev),
                                  torch.from_numpy(factive[s]).to(dev))
        need(np.array_equal(ready[s], want_r.cpu().numpy()),
             f"store {s}: sharded frontier differs from the single card's")
    del a

    # ---- dryrun_multichip(4) over gloo on the card -----------------------
    w0 = time.perf_counter()
    dry = dryrun_multichip(n, device=dev, backend="gloo",
                           timeout_s=MESH["timeout_s"])
    dry_s = time.perf_counter() - w0
    need(dry["queries"] >= 1000, f"dryrun replayed {dry['queries']} queries")

    launches = {name: 0 for name in K.LAUNCHES}
    for r in list(gloo) + list(nccl):
        for name, v in r.launches.items():
            launches[name] += v
    for lw in dry["launches"]:
        for name, v in lw.items():
            launches[name] += v
    need(all(v > 0 for v in launches.values()),
         f"the mesh path did not launch every kernel: {launches}")
    ctx["mesh_launches"] = launches
    seconds = time.perf_counter() - t0
    need(seconds <= MESH["budget_s"],
         f"mesh phase took {seconds:.1f} s > {MESH['budget_s']} s")
    gloo_steps = _rank_numbers(np, gloo, 0)
    need(all(x["k1_launches"] == MESH["steps"] for x in gloo_steps),
         f"K1 launches per rank in the steps: {gloo_steps}")
    return {
        "note": "four ranks on ONE card, collectives staged through host "
                "memory (gloo); not a multi-card figure",
        "card": ctx.get("smi_line"),
        "T": MESH["T"], "K": MESH["K"], "B": MESH["B"], "steps": MESH["steps"],
        "ranks": n, "rows_per_rank": rows,
        "applied": applied_total, "k1_checked_single": chk.checked,
        "inputs_s": inputs_s, "gloo_spawn_s": gloo_s, "nccl_spawn_s": nccl_s,
        "dryrun_s": dry_s,
        "gloo_x4": {"backend": "gloo", "per_rank_step": gloo_steps,
                    "launches_per_rank": [r.launches for r in gloo],
                    "store_consult": [r.value[1]["times"] for r in gloo],
                    "closure": [r.value[2]["times"] for r in gloo],
                    "frontier": [r.value[3]["times"] for r in gloo]},
        "nccl_x1": {"backend": "nccl",
                    "per_rank_step": _rank_numbers(np, nccl, None),
                    "launches_per_rank": [r.launches for r in nccl]},
        "dryrun": dry, "equal_to_single_card": True,
        "launches": launches}


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
            "library_ms", "warm_ms", "method_floor_ms", "wrapper_host_us", "shape", "path", "B",
            "T", "K", "nnz", "packed")


def kernels_line(ctx):
    """One entry per kernel: the main path's (the burn's) launch count and
    the numbers at the largest call it made, and the graph and mesh paths'
    launch counts (the mesh's summed over its ranks); every other measured
    shape (the full-size synthetic ones, the replay's largest call, the
    full-width txn_step's K1 call, a mesh rank's calls) under ``shapes``,
    none of them launched on the main path."""
    for key, path in (("burn_checker", "burn"), ("replay_checker", "replay")):
        chk = ctx.get(key)
        if chk is not None:
            for name, (_size, args, kwargs) in sorted(chk.largest.items()):
                measure(ctx, name, f"{path}_largest", args, kwargs, 20, path)
    if ctx.get("graph_join") is not None:
        args, kwargs = ctx["graph_join"]
        measure(ctx, "deps_join", "graph_step_T{T}_K{K}_B{B}".format(**GRAPH),
                args, kwargs, 20, "graph")
    if ctx.get("mesh_join") is not None:
        # a rank's join in the sharded step (rank 0, first batch), and
        # store 0's consult in the store-sharded consult
        args, kwargs = ctx["mesh_join"]
        label = "mesh_step_rank_T{}_K{K}_B{B}".format(
            MESH["T"] // MESH["ranks"], **MESH)
        measure(ctx, "deps_join", label, args, kwargs, 20, "mesh")
        jargs, margs = ctx["mesh_consult"]
        label = "mesh_store_T{T}_K{K}_B{B}".format(**MESH)
        measure(ctx, "deps_join", label, jargs, {}, 20, "mesh")
        measure(ctx, "max_conflict", label, margs, {}, 20, "mesh")
    entries = []
    for name in REPLACES:
        rows = [r for r in ctx["rows"] if r["name"] == name]
        if not rows:
            continue
        head = next((r for r in rows if r["path"] == "burn"), rows[0])
        e = {"name": name, "route": "cuda", "source": SOURCE,
             "replaces": REPLACES[name],
             "launches": ctx.get("burn_launches", {}).get(name, 0),
             "replay_launches": ctx.get("replay_launches", {}).get(name, 0),
             "graph_launches": ctx.get("graph_launches", {}).get(name, 0),
             "mesh_launches": ctx.get("mesh_launches", {}).get(name, 0)}
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
    ctx = {"torch": torch, "rows": [], "dev": "cuda", "floors": {},
           "real": {"deps_join": _kernels.deps_join,
                    "max_conflict": _kernels.max_conflict}}
    fns = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
           "service": phase_service, "burn": phase_burn, "graph": phase_graph,
           "mesh": phase_mesh, "replay": phase_replay}
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
