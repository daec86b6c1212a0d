#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cassandra_accord_tpu_torch) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py                  # every phase, as the acceptance run
    python3 chip_smoke.py --phases env,build,kernels   # a subset

Phases, one JSON line each; any failure exits non-zero:

1. env      torch/CUDA versions, nvcc, the card's name and power limit;
2. build    nvcc of every csrc/*.cu for sm_90a (all started together),
            linked into one library, with its time;
3. kernels  K1 (deps_join) and K2 (max_conflict) in both forms over the
            [K, T] index, CSR (csrc/consult.cu) and dense
            (csrc/dense_join.cu: K1d, K2d), K1d/K2d on the [T, K] index
            as it lies (csrc/dense_join_tk.cu: TMA ring, int8 wgmma), and
            K12 (fused_consult, csrc/consult.cu: K1 and K2 of the CSR form
            in one launch, the service's window; against its plain version
            and K1 + K2, and timed in turns with K1 + K2), at
            full size against their plain torch versions, exactly (the
            eager answer and the graph replays' answers; the [T, K] ones
            also against the [K, T] answers, and with a K tail of 80), and
            on rows with columns -1, -K, K and -K-1 (wrapped once or
            dropped, as the reference's densify does), K12 also on an empty
            batch and with kind codes outside the table; each case once more
            through the service's consult (ragged_consult_t), which picks
            the form (join_form), and through the one-shot
            consult (ops.deps_kernels.consult) on the [T, K] index, launches
            counted: config 4 and the wide row on K1d/K2d in the service,
            the rest one K12 launch each (the dense form refuses the cases
            with T % 16 != 0, checked), every case on the [T, K] kernels one-shot (K =
            72 and a misaligned query go to CSR and the [T, K] wrappers
            raise, checked); at shape A, config 4 and the wide row the
            one-shot consult's transpose route (transposes, CSR query, K1
            and K2 with values) and its [T, K] route timed in turns, with
            the transpose route's parts and the [T, K] route in a CUDA
            graph; the sweep of both forms in
            turns over row widths at config 4's and the wide row's index,
            config 4's rows over fewer slots and rows naming every key of
            16-, 64- and 256-key indexes (the crossovers join_form is set
            from), and the one-shot consult's sweep of the CSR route
            against the [T, K] kernels at the kernel tables' shapes (the
            tk_refusal rule's); device time per launch
            from a CUDA graph of back-to-back launches between one event
            pair (cold and warm L2), the wrapper's host cost apart, beside
            the plain version, one torch.matmul of the same join and the
            least time the card could take (bytes or operations);
4. service  windows through the persistent consult service at T=65,536,
            K=512, B=64, with dirty rows between windows; every kernel
            answer is held against the plain version on the same inputs;
5. burn     the main path: a seeded burn with the device tier forced
            through the service and frontier execution on; the launch
            counts are zeroed just before it and read just after (every
            window one K12 launch, no other kernel); every
            tenth kernel answer is checked against the plain version, the
            trace must equal the same burn on the host backend.  The same
            burn through the resolver's one-shot device path (no service)
            must equal it too;
6. cli      the burn CLI's fault matrix (``harness.burn.main``, in
            process) on seeds 0 and 1 at 120 ops with --audit=strict, and
            seed 1 again with crash-restarts every 3 sim-s, the device tier
            forced through the environment the CLI reads, then seed 0 under
            the workload presets multirange, zipf and openloop and under
            --elastic at 60 ops: each run on the
            card's backend (launches counted around the run,
            every tenth call checked against the plain version) and on the
            host backend, with equal outcomes and audit verdicts and
            identical causal DAGs (tools_torch/explain.py); then the port's
            gate (tools_torch/perfgate.py) under the same environment: its
            smoke's sim block equals the host resolver's and the gate
            passes against BASELINE.json;
7. maelstrom the Maelstrom adapter on the device tier, set only through the
            environment it reads: run_workload (seed 1 on 3 nodes, seeds 2
            and 9 on 5 nodes with partitions, 100 ops, history oracle on)
            on the card's backend equal to the host backend's, launches
            counted, every tenth call checked; then the stdio binary
            (python -m cassandra_accord_tpu_torch.maelstrom, the command a
            Maelstrom user runs, through runpy so that it reports its
            launches and device consults at exit) fed 33 txns: its replies
            equal the same binary's on the host backend, exit 0, no
            traceback, launches and device consults on the card (two of
            K12's launches its warm-up on init), none on the host
            backend;
8. verify   the verify resolver (every answer checked against the cfk walk,
            frontiers every 0.7 sim-s) on a seed-7 300-op burn with the
            device tier through the service on the card: it completes, its
            trace and outcomes equal the host backend's, and its trace,
            outcomes and every resolver stat equal the same backend's run
            on the CPU;
9. graph    the conflict-graph model: txn_step at T=65,536, K=512,
            B=256 with a gc step every 8 (K1 launches counted, on the [T, K]
            kernel by the rule, each K1 answer held against its plain version, step ms, peak memory and
            the step's floor); a T=4,096 trajectory with padded batches,
            card against CPU bit for bit; insert_batch and txn_step with
            slots T, -1 and -T-1, card against CPU; closure/elide/SCC/Kahn
            at T=8,192 dense against their edge twins, card against CPU;
            the edge kernels at T=1,048,576 (E ~ 8.4M), card against CPU;
10. mesh    the sharded data plane (parallel/, one process per rank over
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
11. replay  bench.py's replay stage: a recorded 6-key burn replayed at
            T=4,096 and 32,768 through the walk (sampled), host, auto (the
            shipped cost model) and device tiers, and the same burn over
            1,000 keys (range transactions, queries up to ~500 keys wide)
            at T=4,096 and 8,192; each tier under a valve (prefix replay,
            labelled truncated, with the events reached and the live index
            held); sampled parity against the cfk walk (range queries too),
            the cost model's calibrated threshold (five calibrations) and
            its routing split, launches per replay and kernel, every tenth
            call checked against the plain version.
12. bench   the port's bench (bench_torch.py): ``--smoke`` in a subprocess
            (exit 0, the tail contract, the card named in its last line),
            then its kernel, service, deps_graph and graph stages in process
            at the smallest sizes bench.py uses (bench_kernel(4096),
            bench_service(8192), bench_deps_graph(ts=(1024,)),
            bench_graph(t=8192, iters=1)), each holding every answer
            against the host tier or the edge twins; launches counted
            around them, every tenth call checked against the plain version
            (the checks sit inside the stages' timed regions, so the rates
            this phase prints are not the bench's).

Then the card's nvidia-smi line, one ``{"kernels": [...]}`` line (K1, K2,
K1d, K2d on [K, T], K1d, K2d on [T, K] and K12, each with its launches per
path and its times at every measured shape in each form) and, last,
``{"ok": true, "device": {...}}``.  Without CUDA, or run from a directory
that does not hold the port, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(os.getcwd(), "chiprun_out")
PHASES = ("env", "build", "kernels", "service", "burn", "cli", "maelstrom",
          "verify", "graph", "mesh", "replay", "bench")

# H100 SXM data sheet (NVIDIA), dense rates at the 700 W limit: HBM3 at
# 3.35 TB/s; 67 TFLOP/s FP32 on the CUDA cores, the rate class the consult
# kernels' word ORs and int32 compares run in; 1,979 TOP/s int8 on the
# tensor cores, the rate of the dense form of the key-overlap product.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12
BF16_TENSOR_FLOPS_PER_S = 989e12

TPU_KERNEL = "cassandra_accord_tpu/ops/pallas_join.py:36"   # _join_kernel
MAX_HALF = "cassandra_accord_tpu/device_service/kernel.py:55"
REPLACES = {
    # K1 is the port of the one Pallas kernel (pallas_call at :61)
    "deps_join": TPU_KERNEL,
    # K2 is the max half of the same consult; the reference computes it in
    # XLA beside the join (device_service/kernel.py:55-59)
    "max_conflict": MAX_HALF,
    # K1d and K2d: the same functions as an int8 tensor-core product, the
    # Pallas kernel's own shape (a dense query against the whole index)
    "deps_join_dense": TPU_KERNEL,
    "max_conflict_dense": MAX_HALF,
    # K1d and K2d on the [T, K] index as the reference's kernel reads it
    # (TMA ring, int8 wgmma): the one-shot consults' and the steps' path
    "deps_join_dense_tk": TPU_KERNEL,
    "max_conflict_dense_tk": MAX_HALF,
    # K12: K1 and K2 in one launch, the service's window (the reference's
    # one program, device_service/kernel.py:37-68); it replaces the Pallas
    # kernel and the XLA max half (``also_replaces`` in the kernels line)
    "fused_consult": TPU_KERNEL,
    # the conflict-graph step's own kernels: the reference's scatters of
    # the witness (and, alike, the stabilisation's at :89) and its
    # frontier's product, both plain XLA
    "write_rows": "cassandra_accord_tpu/models/conflict_graph.py:57",
    "frontier": "cassandra_accord_tpu/ops/deps_kernels.py:261",
    # the step's MaxConflicts: the XLA chain of max_conflict_ts (its
    # _lex_max_masked at :101), five lanes of where / max / == / &
    "lex_max_deps": "cassandra_accord_tpu/ops/deps_kernels.py:117",
}
ALSO_REPLACES = {"fused_consult": MAX_HALF}
SOURCES = {"deps_join": "cassandra_accord_tpu_torch/csrc/consult.cu",
           "max_conflict": "cassandra_accord_tpu_torch/csrc/consult.cu",
           "deps_join_dense": "cassandra_accord_tpu_torch/csrc/dense_join.cu",
           "max_conflict_dense":
               "cassandra_accord_tpu_torch/csrc/dense_join.cu",
           "deps_join_dense_tk":
               "cassandra_accord_tpu_torch/csrc/dense_join_tk.cu",
           "max_conflict_dense_tk":
               "cassandra_accord_tpu_torch/csrc/dense_join_tk.cu",
           "fused_consult": "cassandra_accord_tpu_torch/csrc/consult.cu",
           "write_rows": "cassandra_accord_tpu_torch/csrc/step_rows.cu",
           "frontier": "cassandra_accord_tpu_torch/csrc/step_rows.cu",
           "lex_max_deps": "cassandra_accord_tpu_torch/csrc/lex_max.cu"}
CSR_KERNELS = ("deps_join", "max_conflict")
# the service's window on the CSR form: one K12 launch
FUSED = "fused_consult"
TK_KERNELS = ("deps_join_dense_tk", "max_conflict_dense_tk")
STEP_KERNELS = ("write_rows", "frontier", "lex_max_deps")
# the wrappers the recorders hold: the [K, T] ones (a form each), the
# [T, K] ones and K12; their plain versions are ``<name>_plain``
WRAPPERS = ("deps_join", "max_conflict", "deps_join_dense",
            "max_conflict_dense", "deps_join_tk", "max_conflict_tk", FUSED)
# BASELINE.md config 4 (range transactions of 1,000 keys): the kernels
# phase's case whose consult is the dense kernels' path
CONFIG4 = "config4_T65536_K2048_B64_1024keys"
FORMS = ("csr", "dense")


def kernel_name(base, form) -> str:
    """The launch counter (and kernels-line entry) of K1 or K2 ``base`` in
    ``form``, which is also the name of its [K, T] wrapper (the [T, K]
    wrappers have one kernel each)."""
    if base.endswith("_tk"):
        return base[:-3] + "_dense_tk"
    return f"{base}_dense" if form == "dense" else base


def base_name(name) -> str:
    """The kernel a wrapper serves: ``deps_join`` or ``max_conflict`` for
    either [K, T] wrapper (the dense one runs the same plain version)."""
    return name[:-len("_dense")] if name.endswith("_dense") else name


def k1_launches(launches) -> int:
    """K1 launches in any form: what one deps_join, deps_join_tk or
    fused_consult wrapper call adds."""
    return (launches["deps_join"] + launches["deps_join_dense"]
            + launches["deps_join_dense_tk"] + launches[FUSED])


def need_csr_only(launches, what) -> None:
    """K12 launched and no other kernel: the service's paths, whose shapes
    join_form keeps on the CSR form, where a window is one K12 launch."""
    need(launches[FUSED] > 0
         and all(v == 0 for n, v in launches.items() if n != FUSED),
         f"{what} launched {launches}")


def call_shape(name, args):
    """(B, T, K) of a call of wrapper ``name`` with ``args``."""
    if name == FUSED:
        return args[7].numel() - 1, args[0].shape[1], args[0].shape[0]
    if name.endswith("_tk"):
        query = args[5] if name == "deps_join_tk" else args[4]
        return query.shape[0], args[0].shape[0], args[0].shape[1]
    offsets = args[5] if base_name(name) == "deps_join" else args[4]
    return offsets.numel() - 1, args[0].shape[1], args[0].shape[0]


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
    """(bound_ms, bound_by, bytes, ops) for one K1, K2 or K12 call over the
    [K, T] index and a CSR query (see ``_bound``)."""
    k, t = inc_T.shape
    b = offsets.numel() - 1
    nnz = int(offsets[-1])
    c = cols[:nnz].long()
    c = c[(c >= 0) & (c < k)]
    return _bound(name, b, t, k, c.numel(), int(torch.unique(c).numel()),
                  4 * (b + 1) + 4 * nnz, packed)


def join_bound_tk(torch, name, inc, query, packed=False):
    """(bound_ms, bound_by, bytes, ops) for one K1/K2 call over the [T, K]
    index and the dense [B, K] query (see ``_bound``): the keys the batch
    names are the query's nonzero columns, and the query is B·K bytes."""
    t, k = inc.shape
    b = query.shape[0]
    nz = query != 0
    return _bound(name, b, t, k, int(nz.sum()), int(nz.any(0).sum()), b * k,
                  packed)


def _bound(name, b, t, k, nnz, distinct, query, packed):
    """Bytes: each input byte the function needs read once (the incidence
    of the keys the batch names, the slot lanes and codes, the query) and
    each output byte written once, over the HBM rate.  Operations: the key
    overlap the cheaper of two ways, 64-bit ORs of the named rows (nnz·T/8
    words) on the CUDA cores or the dense 2·B·K·T product on the int8
    tensor cores, plus the per-(b, t) epilogue on the CUDA cores (K1: five
    lane compares, the witness bit and the ANDs, 8; K2: the masked lex-max
    step, 6).  K12 (``fused_consult``) is both over two indexes: the named
    rows of each, the slot data (txnId, ts, kind, status, active) and the
    query once, both outputs, both overlaps and 8 + 6 ops per (b, t)."""
    deps_bytes = b * t // 8 if packed else b * t
    indexes = 1
    if name == FUSED:
        indexes = 2
        nbytes = 2 * distinct * t + t * (40 + 3) + query + 21 * b + 20 * b \
            + deps_bytes
        epilogue = (8 + 6) * b * t
    elif name.startswith("deps_join"):
        nbytes = distinct * t + t * (20 + 3) + query + 21 * b + deps_bytes
        epilogue = 8 * b * t
    else:
        nbytes = distinct * t + t * (40 + 1) + query + 20 * b
        epilogue = 6 * b * t
    or_words = indexes * nnz * t // 8
    dense = indexes * 2 * b * k * t
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
    """Exact-match error of an answer (a tensor, or K12's pair) against its
    plain version's: the largest absolute difference, 0 when equal."""
    if isinstance(a, tuple):
        return max(max_abs_err(torch, x, y) for x, y in zip(a, b))
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
    ``every``-th call (none when ``every`` is 0) is held against the plain
    version on the same inputs at once, exactly; ``check_s`` sums the
    seconds those checks took, which the phases take off the wall times
    they report.  Nothing is kept but the largest call per kernel, for
    timing at the path's own shapes."""

    def __init__(self, torch, kmod, every: int = 1):
        self.torch = torch
        self.k = kmod
        self.every = every
        self.real = {n: getattr(kmod, n) for n in WRAPPERS}
        self.calls = {n: 0 for n in WRAPPERS}
        self.largest = {}
        self.checked = 0
        self.check_s = 0.0

    def k1_calls(self) -> int:
        return (self.calls["deps_join"] + self.calls["deps_join_dense"]
                + self.calls["deps_join_tk"] + self.calls[FUSED])

    def _check(self, name, args, kwargs, got):
        t0 = time.perf_counter()
        kwargs = {k: v for k, v in kwargs.items() if k != "out"}
        want = getattr(self.k, f"{base_name(name)}_plain")(*args, **kwargs)
        b, t, k = call_shape(name, args)
        need(max_abs_err(self.torch, got, want) == 0,
             f"{name} differs from its plain version at B={b} T={t} K={k}")
        self.checked += 1
        self.check_s += time.perf_counter() - t0

    def _wrap(self, name):
        real = self.real[name]

        def call(*args, **kwargs):
            got = real(*args, **kwargs)
            if self.every and self.calls[name] % self.every == 0:
                self._check(name, args, kwargs, got)
            self.calls[name] += 1
            b, t, _k = call_shape(name, args)
            key = base_name(name)     # timed later in both [K, T] forms
            if b * t >= self.largest.get(key, (-1,))[0]:
                self.largest[key] = (b * t, args, kwargs)
            return got
        return call

    def __enter__(self):
        for n in WRAPPERS:
            setattr(self.k, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n in WRAPPERS:
            setattr(self.k, n, self.real[n])


def _keep_largest(ctx, path, chk) -> None:
    """Keep ``chk``'s largest call per kernel as ``path``'s (over several
    runs, the largest), for timing at the path's own shape afterwards."""
    kept = ctx.setdefault("largest", {}).setdefault(path, {})
    for name, call in chk.largest.items():
        if call[0] >= kept.get(name, (-1,))[0]:
            kept[name] = call


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
                 wide=0, split=False):
    """K1 (unpacked, and bit-packed where ``packed`` says) and K2 on one
    synthetic index and query batch, each in both forms (CSR, dense) over
    the [K, T] index and on the [T, K] index as it lies (K1d/K2d _tk, also
    equal to the [K, T] answers), and K12 (both halves in one launch, the
    CSR form; against its plain version and K1 + K2); then the same batch
    through the consult the device tier's service runs
    (``device_service.kernel.ragged_consult_t``, the CSR batch as given:
    K12 on the CSR form, K1d and K2d on the dense, by join_form), and
    through the one-shot consult
    (``ops.deps_kernels.consult``, the [T, K] index and the dense query),
    each with the launch counts zeroed just before and read just after;
    with ``wide`` the first query row takes that many random columns,
    duplicates included; with ``split`` the one-shot consult's transpose
    route and its [T, K] route are timed in turns (``_oneshot_split``)."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.device_service.kernel import \
        ragged_consult_t
    from cassandra_accord_tpu_torch.ops import _kernels as K
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
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
    jargs = (live_T, g["txn_id"], g["kind"], g["status"], g["active"],
             g["offsets"], g["cols"], g["before"], g["qkind"])
    margs = (key_T, g["ts"], g["txn_id"], g["active"], g["offsets"],
             g["cols"])
    out = []
    for form in FORMS:
        if form == "dense" and t % 16:
            _dense_refused(ctx, label, jargs, margs)
            continue
        for pk in packed:
            out.append(measure(ctx, "deps_join",
                               f"{label}{'_packed' if pk else ''}", jargs,
                               {"packed": pk}, iters, form=form))
        out.append(measure(ctx, "max_conflict", label, margs, {}, iters,
                           form=form))
    fargs = (live_T, key_T, g["ts"], g["txn_id"], g["kind"], g["status"],
             g["active"], g["offsets"], g["cols"], g["before"], g["qkind"])
    for pk in packed:
        out.append(measure_fused(ctx, f"{label}{'_packed' if pk else ''}",
                                 fargs, {"packed": pk}, iters))
    K.reset_launches()                        # just before the call
    deps, cmax = ragged_consult_t(live_T, key_T, g["ts"], g["txn_id"],
                                  g["kind"], g["status"], g["active"],
                                  g["cols"], g["offsets"], g["before"],
                                  g["qkind"])
    sync(ctx)
    launches = dict(K.LAUNCHES)               # just after it
    need(torch.equal(deps, K.deps_join_plain(*jargs))
         and torch.equal(cmax, K.max_conflict_plain(*margs)),
         f"[{label}] the service's consult differs from the plain versions")
    form = K.join_form(b, t, k, g["cols"].numel())
    kernels = ((FUSED,) if form == "csr" else
               ("deps_join_dense", "max_conflict_dense"))
    need(launches == {n: int(n in kernels) for n in K.LAUNCHES},
         f"[{label}] auto ({form}) launched {launches}")
    ctx.setdefault("auto_launches", {})[label] = launches

    # the [T, K] entries on the index as the one-shot callers hold it
    q = np.zeros((b, k), dtype=np.int8)
    for i, r in enumerate(rows):
        q[i, r] = 1
    tk = dict(live=up(live), key=up(key_inc), q=up(q))
    tj = (tk["live"], g["txn_id"], g["kind"], g["status"], g["active"],
          tk["q"], g["before"], g["qkind"])
    tm = (tk["key"], g["ts"], g["txn_id"], g["active"], tk["q"])
    need(torch.equal(K.deps_join_tk_plain(*tj), deps)
         and torch.equal(K.max_conflict_tk_plain(*tm), cmax),
         f"[{label}] the [T, K] plain versions differ from the [K, T] path")
    for pk in packed:
        out.append(measure(ctx, "deps_join_tk",
                           f"{label}{'_packed' if pk else ''}", tj,
                           {"packed": pk}, iters))
    out.append(measure(ctx, "max_conflict_tk", label, tm, {}, iters))
    oneshot = (tk["live"], tk["key"], g["ts"], g["txn_id"], g["kind"],
               g["status"], g["active"], tk["q"], g["before"], g["qkind"])
    K.reset_launches()                        # just before the call
    d1, m1 = dk.consult(*oneshot)
    sync(ctx)
    launches = dict(K.LAUNCHES)               # just after it
    need(torch.equal(d1, deps) and torch.equal(m1, cmax),
         f"[{label}] the one-shot consult differs from the service's")
    want = ({n: int(n in TK_KERNELS) for n in K.LAUNCHES}
            if K.tk_refusal(k) is None else None)
    need(want is None or launches == want,
         f"[{label}] the one-shot consult launched {launches}")
    ctx.setdefault("oneshot_launches", {})[label] = launches
    if split:
        ctx.setdefault("oneshot_split", {})[label] = _oneshot_split(
            ctx, oneshot, (d1, m1))
    return out


def transpose_consult(*args, packed=False):
    """The one-shot consult's transpose route, the one a [T, K] caller
    takes when the [T, K] kernels refuse its shape: both incidences
    transposed to [K, T], the query to CSR with its values (its size read
    back), then K1 and K2 in the CSR form with those values."""
    from cassandra_accord_tpu_torch.ops import _kernels as K
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    live, key, ts, txn_id, kind, status, active, q, before, qkind = args
    offsets, cols, vals = dk.query_csr(q)
    deps = K.deps_join(dk.incidence_T(live), txn_id, kind, status, active,
                       offsets, cols, before, qkind, packed=packed, vals=vals)
    return deps, K.max_conflict(dk.incidence_T(key), ts, txn_id, active,
                                offsets, cols, vals=vals)


def tk_consult(*args, packed=False):
    """The one-shot consult's [T, K] route: K1d and K2d on the [T, K]
    index and the dense query as they lie (they raise where they refuse)."""
    from cassandra_accord_tpu_torch.ops import _kernels as K
    live, key, ts, txn_id, kind, status, active, q, before, qkind = args
    return (K.deps_join_tk(live, txn_id, kind, status, active, q, before,
                           qkind, packed=packed),
            K.max_conflict_tk(key, ts, txn_id, active, q))


# the one-shot consult's two routes, by the name of the [K, T] form each
# stands beside in the sweeps
ONESHOT_ROUTES = {"csr": transpose_consult, "dense": tk_consult}


def _oneshot_split(ctx, args, want):
    """The one-shot consult (``consult_packed``) by the transpose route and
    by the [T, K] route, in turns (transpose, tk, tk, transpose), ms per
    call from events around calls after an L2 flush each (the transpose
    route reads the query's size back, so neither is captured; the events
    then take the host's gaps in), and the transpose route in its parts:
    ``incidence_T`` of both incidences, ``query_csr``, K1 and K2 on the
    prepared inputs; and this route captured in a CUDA graph (it reads
    nothing back), device ms per call.  Both routes' answers are held
    against ``want``."""
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    flush, reps = ctx["flush"], 5
    packed = (K.pack_bits(want[0]), want[1])
    routes = {"transpose": lambda: transpose_consult(*args, packed=True),
              "tk": lambda: dk.consult_packed(*args)}
    for name, fn in routes.items():
        got = fn()
        sync(ctx)
        need(all(torch.equal(a, w) for a, w in zip(got, packed)),
             f"one-shot consult ({name} route) differs")
    ms = {"transpose": [], "tk": []}
    for name in ("transpose", "tk", "tk", "transpose"):
        ms[name].append(eager_ms(torch, routes[name], reps, flush))
    live, key, ts, txn_id, kind, status, active, q, before, qkind = args
    offsets, cols, vals = dk.query_csr(q)
    live_T, key_T = dk.incidence_T(live), dk.incidence_T(key)
    parts = {
        "incidence_T_x2": eager_ms(torch, lambda: (dk.incidence_T(live),
                                                   dk.incidence_T(key)),
                                   reps, flush),
        "query_csr": eager_ms(torch, lambda: dk.query_csr(q), reps, flush),
        "kernels": device_ms(torch, lambda: (
            K.deps_join(live_T, txn_id, kind, status, active, offsets, cols,
                        before, qkind, packed=True, vals=vals),
            K.max_conflict(key_T, ts, txn_id, active, offsets, cols,
                           vals=vals)),
            reps, flush),
        "form": "csr"}
    last = [None]

    def graphed():
        last[0] = dk.consult_packed(*args)

    def check(replay):
        sync(ctx)
        need(all(torch.equal(a, w) for a, w in zip(last[0], packed)),
             "one-shot consult (tk route) differs after a graph replay")
    return {"transpose_ms": ms["transpose"], "tk_ms": ms["tk"],
            "transpose_parts_ms": parts,
            "tk_graph_ms": device_ms(torch, graphed, reps, flush, check),
            "tk_host_us": host_us(torch, routes["tk"], reps)}


def _dense_refused(ctx, label, jargs, margs):
    """The dense form takes T % 16 == 0 only: forced at another T, K1d and
    K2d raise and launch nothing."""
    from cassandra_accord_tpu_torch.ops import _kernels as K
    before = dict(K.LAUNCHES)
    for name, args in (("deps_join", jargs), ("max_conflict", margs)):
        try:
            ctx["real"][kernel_name(name, "dense")](*args)
        except ValueError:
            continue
        need(False, f"[{label}] {name} forced dense did not raise")
    need(K.LAUNCHES == before, f"[{label}] a refused dense call launched")


def method_floor_ms(ctx, iters) -> float:
    """The timing method's own floor at this rep count: a one-element add
    timed as the kernels are (the graph launch's fixed cost is spread over
    ``iters``), once per count."""
    torch = ctx["torch"]
    if iters not in ctx["floors"]:
        one = torch.zeros(1, device=ctx["dev"])
        ctx["floors"][iters] = device_ms(torch, lambda: one.add_(1), iters,
                                         ctx["flush"])
    return ctx["floors"][iters]


def measure(ctx, name, label, args, kwargs, iters, path="synthetic",
            form="auto"):
    """One kernel (``name``: the wrapper deps_join or max_conflict, in one
    form, or deps_join_tk or max_conflict_tk) at one shape: exact check
    against the plain version (the eager call's answer, and the last graph
    replay's of each timing, also after its output was overwritten and the
    graph replayed once more), then kernel (cold and warm L2), plain and
    library times, the wrapper's host cost and the bound.  ``path`` says
    where the shape came from; ``form`` "auto" is the form join_form picks
    for it, and the row is named by the kernel (the [K, T] form's wrapper's
    name)."""
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    if name == FUSED:
        return measure_fused(ctx, label, args, kwargs, iters, path)
    kwargs = {k: v for k, v in kwargs.items() if k != "out"}
    b, t, k = call_shape(name, args)
    packed = kwargs.get("packed", False)
    if name.endswith("_tk"):
        inc, query = args[0], args[5 if name == "deps_join_tk" else 4]
        kern = ctx["real"][name]
        qf, incf = query.float(), inc.float().t()
        bound = join_bound_tk(torch, name, inc, query, packed=packed)
        nnz = int((query != 0).sum())
    else:
        inc_T = args[0]
        offsets = args[5] if name == "deps_join" else args[4]
        cols = args[6] if name == "deps_join" else args[5]
        if form == "auto":
            form = K.join_form(b, t, k, cols.numel())
        kern = ctx["real"][kernel_name(name, form)]
        qf, incf = K.dense_query(offsets, cols, k).float(), inc_T.float()
        bound = join_bound(torch, name, inc_T, offsets, cols, packed=packed)
        nnz = int(offsets[-1])
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
    floor_ms = method_floor_ms(ctx, iters)
    err = max(errs)
    need(err == 0, f"{name} ({form}) [{label}] differs from its plain version: "
         f"max_abs_err {errs} (eager, then cold and warm graph replays)")
    wrapper_us = host_us(torch, call, iters)
    plain_ms = eager_ms(torch, lambda: plain(*args, **kwargs),
                        max(3, iters // 4), flush)
    library_ms = device_ms(torch, lambda: torch.matmul(qf, incf),
                           max(3, iters // 4), flush)
    del qf, incf
    bound_ms, bound_by, nbytes, ops = bound
    row = {"name": kernel_name(name, form), "shape": label, "path": path,
           "B": b, "T": t, "K": k, "nnz": nnz, "packed": bool(packed),
           "max_abs_err": err, "ms": ms, "warm_ms": warm_ms,
           "method_floor_ms": floor_ms,
           "wrapper_host_us": wrapper_us, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "ops": ops}
    ctx["rows"].append(row)
    return row


def _fused_halves(ctx, args, packed=False):
    """K1 and K2 (the CSR form) on K12's arguments: the pair K12 replaces."""
    live_T, key_T, ts, txn_id, kind, status, active, offsets, cols, before, \
        qkind = args
    return (ctx["real"]["deps_join"](live_T, txn_id, kind, status, active,
                                     offsets, cols, before, qkind,
                                     packed=packed),
            ctx["real"]["max_conflict"](key_T, ts, txn_id, active, offsets,
                                        cols))


def measure_fused(ctx, label, args, kwargs, iters, path="synthetic"):
    """K12 (``fused_consult``) at one shape, as ``measure``: exact against
    its plain version and against K1 + K2 (the eager answers, then each
    timing's graph replays), cold and warm ms, then K1 + K2 captured in one
    graph in turns with it (K12, K1 + K2, K1 + K2, K12: ``k1_k2_ms``), the
    plain version, the reference's two products (``library_ms``: the two
    ``torch.matmul``s its two ``dot_general``s map to), the wrapper's host
    cost and the bound."""
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    kwargs = {k: v for k, v in kwargs.items() if k != "out"}
    packed = kwargs.get("packed", False)
    real = ctx["real"][FUSED]
    b, t, k = call_shape(FUSED, args)
    live_T, key_T, offsets, cols = args[0], args[1], args[7], args[8]
    want = K.fused_consult_plain(*args, **kwargs)
    got = real(*args, **kwargs)
    halves = _fused_halves(ctx, args, packed)
    sync(ctx)
    errs = [max_abs_err(torch, got, want), max_abs_err(torch, halves, want)]
    flush = ctx["flush"]
    last = [None]

    def call():
        last[0] = real(*args, **kwargs)

    def pair():
        last[0] = _fused_halves(ctx, args, packed)

    def check(replay):
        sync(ctx)
        errs.append(max_abs_err(torch, last[0], want))
        for x, w in zip(last[0], want):
            x.copy_(torch.bitwise_not(w))
        replay()
        sync(ctx)
        errs.append(max_abs_err(torch, last[0], want))
    turns = {"k12": [], "k1_k2": []}
    for name in ("k12", "k1_k2", "k1_k2", "k12"):
        turns[name].append(device_ms(torch, call if name == "k12" else pair,
                                     iters, flush, check))
    warm_ms = device_ms(torch, call, iters, None, check)
    err = max(errs)
    need(err == 0, f"{FUSED} [{label}] differs from its plain version or from "
         f"K1 + K2: max_abs_err {errs} (eager K12, eager K1 + K2, then the "
         "graph replays)")
    floor_ms = method_floor_ms(ctx, iters)
    wrapper_us = host_us(torch, call, iters)
    pair_us = host_us(torch, pair, iters)
    plain_ms = eager_ms(torch, lambda: K.fused_consult_plain(*args, **kwargs),
                        max(3, iters // 4), flush)
    qf = K.dense_query(offsets, cols, k).float()
    livef, keyf = live_T.float(), key_T.float()
    library_ms = device_ms(torch, lambda: (torch.matmul(qf, livef),
                                           torch.matmul(qf, keyf)),
                           max(3, iters // 4), flush)
    del qf, livef, keyf
    bound_ms, bound_by, nbytes, ops = join_bound(torch, FUSED, live_T,
                                                 offsets, cols, packed=packed)
    row = {"name": FUSED, "shape": label, "path": path, "B": b, "T": t,
           "K": k, "nnz": int(offsets[-1]), "packed": bool(packed),
           "max_abs_err": err, "ms": turns["k12"][0], "warm_ms": warm_ms,
           "method_floor_ms": floor_ms, "wrapper_host_us": wrapper_us,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops, "k12_ms_turns": turns["k12"],
           "k1_k2_ms": turns["k1_k2"], "k1_k2_host_us": pair_us}
    ctx["rows"].append(row)
    return row


def phase_kernels(ctx):
    rows = []
    rows += _kernel_case(ctx, "T65536_K512_B256_2keys", 65536, 512, 256, 2, 20,
                         split=True)
    rows += _kernel_case(ctx, CONFIG4, 65536, 2048, 64, 1024, 10, split=True)
    # odd T (the CSR form's byte loads, no packing; the dense form refuses
    # T % 16 != 0) at a small shape
    rows += _kernel_case(ctx, "T1003_K64_B13_2keys", 1003, 64, 13, 2, 20,
                         packed=(False,))
    # the burn's window shape (its largest calls are timed after the burn)
    rows += _kernel_case(ctx, "burnlike_T256_K16_B8_2keys", 256, 16, 8, 2, 20)
    # two tiles, the second with one slot (the CSR form's byte loads and
    # cross-tile fold; the dense form refuses it)
    rows += _kernel_case(ctx, "T2049_K64_B13_2keys", 2049, 64, 13, 2, 20,
                         packed=(False,))
    # a row of 5,000 columns (duplicates), wider than a block's CSR stage
    rows += _kernel_case(ctx, "wide_T65536_K512_B9_5000cols", 65536, 512, 9,
                         2, 5, packed=(False,), wide=5000, split=True)
    # a K tail the [T, K] kernels take (80) and one they refuse (72)
    rows += _kernel_case(ctx, "T4096_K80_B33_2keys", 4096, 80, 33, 2, 20)
    # a mesh rank's shard of the sharded step (MESH's T over its ranks)
    rows += _kernel_case(ctx, "mesh_rank_T16384_K512_B256_2keys", 16384, 512,
                         256, 2, 20)
    keys = ("name", "shape", "max_abs_err", "ms", "warm_ms",
            "method_floor_ms", "wrapper_host_us", "plain_ms", "library_ms",
            "bound_ms", "bound_by")
    return {"negative_columns": _kernel_columns(ctx),
            "kt_edges": _kt_edges(ctx),
            "parity": _parity(ctx),
            "tk_refused": _tk_refused(ctx),
            "cases": [dict({k: r[k] for k in keys},
                           bound_us=r["bound_ms"] * 1e3) for r in rows],
            "auto_launches": ctx["auto_launches"],
            "oneshot_launches": ctx["oneshot_launches"],
            "oneshot_split": ctx["oneshot_split"],
            "sweep": _kernel_sweep(ctx),
            "consult_sweep": _consult_sweep(ctx)}


def _tk_refused(ctx):
    """K = 72 (not a multiple of 16) and a misaligned query: the [T, K]
    kernels refuse both, so their wrappers (``tk_consult``) raise and
    launch nothing, and the one-shot consult takes the CSR route
    (transposes, CSR query, the [K, T] wrappers), equal to the plain
    versions."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    rng = np.random.default_rng(31)
    out = {}
    for label, t, k, b, offset in (("K72", 1024, 72, 9, 0),
                                   ("misaligned_query", 1024, 64, 9, 1)):
        key_inc, live, lanes, ts, kind, status, active = make_index(
            np, rng, t, k, 2)
        rows, before, qkind = make_queries(np, rng, b, k, t, 2)
        q = np.zeros((b * k + offset,), dtype=np.int8)
        for i, r in enumerate(rows):
            q[offset + i * k + np.asarray(r)] = 1

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(ctx["dev"])
        qd = up(q)[offset:].view(b, k)          # data_ptr % 16 == offset
        args = (up(live), up(key_inc), up(ts), up(lanes), up(kind),
                up(status), up(active), qd, up(before), up(qkind))
        before_l = dict(K.LAUNCHES)
        try:
            tk_consult(*args)
        except ValueError:
            pass
        else:
            need(False, f"[{label}] the [T, K] kernels did not refuse")
        need(K.LAUNCHES == before_l, f"[{label}] a refused call launched")
        K.reset_launches()
        got = dk.consult(*args)
        sync(ctx)
        launches = dict(K.LAUNCHES)
        need(not any(launches[n] for n in TK_KERNELS)
             and k1_launches(launches) == 1,
             f"[{label}] auto launched {launches}")
        cpu = [a.cpu() for a in args]
        want = dk.consult(*cpu)
        need(all(torch.equal(a.cpu(), w) for a, w in zip(got, want)),
             f"[{label}] the CSR route differs from the plain versions")
        out[label] = launches
    return out


# The rule's sweep for [T, K] callers (PERF.md sets their rule,
# ``tk_refusal``, from it): the one-shot consult (``ops.deps_kernels.
# consult``, both halves) at the shapes of PERF.md's kernel tables, by the
# CSR route (the index transposed, the query to CSR with its size read
# back, the [K, T] CSR kernels) and by the [T, K] kernels, in turns (CSR,
# dense, dense, CSR), ms per call from events around calls after an L2
# flush each.  (label, B, T, K, keys per index row, keys per query row,
# wide row's columns)
CONSULT_SWEEP = dict(
    shapes=(("burn_largest", 8, 256, 16, 2, 2, 0),
            ("cli_largest", 8, 128, 16, 1, 1, 0),
            ("odd_T", 13, 1003, 64, 2, 2, 0),
            ("two_tiles", 13, 2049, 64, 2, 2, 0),
            ("bench_phase_largest", 256, 4096, 512, 2, 2, 0),
            ("mesh_rank_step", 256, 16384, 512, 2, 2, 0),
            ("shape_A", 256, 65536, 512, 2, 2, 0),
            ("wide_row", 9, 65536, 512, 2, 2, 5000),
            ("replay_largest", 256, 65536, 1024, 2, 8, 0),
            ("wide_replay_largest", 256, 4096, 8192, 2, 2, 0),
            ("config4", 64, 65536, 2048, 1024, 1024, 0)),
    reps=5)


def _consult_sweep(ctx):
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    rng = np.random.default_rng(37)
    out = []
    for label, b, t, k, per_txn, per_row, wide in CONSULT_SWEEP["shapes"]:
        if per_txn > 8:                      # config 4's index: 50% dense
            key_inc = (rng.random((t, k)) < 0.5).astype(np.int8)
            _k, _l, lanes, ts, kind, status, active = make_index(
                np, rng, t, 64, 2)
        else:
            key_inc, _l, lanes, ts, kind, status, active = make_index(
                np, rng, t, k, per_txn)
        rows, before, qkind = make_queries(np, rng, b, k, t, min(per_row, 2))
        if per_row > 2:
            rows = [sorted(int(c) for c in rng.choice(k, per_row, replace=False))
                    for _ in range(b)]
        if wide:
            rows[0] = sorted(int(c) for c in rng.integers(0, k, wide))
        q = np.zeros((b, k), dtype=np.int8)
        for i, r in enumerate(rows):
            q[i, r] = 1

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(ctx["dev"])
        args = (up(key_inc), up(key_inc), up(ts), up(lanes), up(kind),
                up(status), up(active), up(q), up(before), up(qkind))
        want = transpose_consult(*args)
        got = tk_consult(*args)
        sync(ctx)
        need(all(torch.equal(a, w) for a, w in zip(got, want)),
             f"consult sweep [{label}]: the forms differ")
        ms = {"csr": [], "dense": []}
        for form in ("csr", "dense", "dense", "csr"):
            ms[form].append(eager_ms(
                torch, lambda f=form: ONESHOT_ROUTES[f](*args),
                CONSULT_SWEEP["reps"], ctx["flush"]))
        out.append({"shape": label, "B": b, "T": t, "K": k,
                    "rule": "dense" if K.tk_refusal(k) is None else "csr",
                    "csr_ms": ms["csr"], "dense_ms": ms["dense"],
                    "faster": min(ms, key=lambda f: min(ms[f]))})
        del args
    return out


# The crossover sweep of the two forms (PERF.md §6 sets join_form's
# thresholds from it): config 4's index (T=65,536, K=2,048, 50% dense) with
# 64 rows of 8 to 1,024 keys each, then its 1,024-key rows over the first
# ``short_T`` slots; the wide row's (K=512, 2 keys per txn) with 8 rows of
# 2 keys and one of 500 to 5,000 columns (duplicates); and indexes of 16
# (the protocol paths'), 64 and 256 keys with 8 rows naming every key, at
# the protocol paths' T and above; and shape A's index (K = 512) with 256
# rows (one pass of the dense form) of 2 to 128 keys each
SWEEP = dict(config4=dict(T=65536, K=2048, B=64,
                          keys=(8, 32, 128, 256, 512, 1024),
                          short_T=(256, 1024, 2048, 4096, 8192, 16384)),
             wide=dict(T=65536, K=512, B=9, cols=(500, 1000, 5000)),
             rows256=dict(T=65536, K=512, B=256, keys=(2, 8, 32, 128)),
             protocol=dict(T=4096, K=(16, 64, 256), B=8,
                           short_T=(128, 256, 1024)),
             iters=10)


def _sweep_point(ctx, label, key_T, g, rows):
    """K1 and K2 at one query batch in both forms: each form held against
    the plain version once, exactly, then cold-L2 device ms in turns (CSR,
    dense, dense, CSR); K12 held against its plain version once."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    offsets, cols = (torch.from_numpy(a).to(ctx["dev"])
                     for a in to_csr(np, rows))
    k, t = key_T.shape
    b = len(rows)
    calls = {"deps_join": ((key_T, g["txn_id"], g["kind"], g["status"],
                            g["active"], offsets, cols, g["before"][:b],
                            g["qkind"][:b]), K.deps_join_plain),
             "max_conflict": ((key_T, g["ts"], g["txn_id"], g["active"],
                               offsets, cols), K.max_conflict_plain)}
    out = {"shape": label, "B": b, "T": t, "K": k, "n_cols": cols.numel(),
           "rule": K.join_form(b, t, k, cols.numel())}
    fargs = (key_T, key_T, g["ts"], g["txn_id"], g["kind"], g["status"],
             g["active"], offsets, cols, g["before"][:b], g["qkind"][:b])
    got = ctx["real"][FUSED](*fargs)
    sync(ctx)
    need(max_abs_err(torch, got, K.fused_consult_plain(*fargs)) == 0,
         f"sweep [{label}] K12 differs from its plain version")
    for name, (args, plain) in calls.items():
        want = plain(*args)
        for form in FORMS:
            got = ctx["real"][kernel_name(name, form)](*args)
            sync(ctx)
            need(torch.equal(got, want),
                 f"sweep [{label}] {name} ({form}) differs from its plain "
                 "version")
        ms = {form: [] for form in FORMS}
        for form in ("csr", "dense", "dense", "csr"):
            ms[form].append(device_ms(
                torch, lambda f=form: ctx["real"][kernel_name(name, f)](*args),
                SWEEP["iters"], ctx["flush"]))
        best = min(FORMS, key=lambda f: min(ms[f]))
        out[name] = {"csr_ms": ms["csr"], "dense_ms": ms["dense"],
                     "faster": best}
    return out


def _first_slots(key_T, g, t):
    """The index and slot arrays cut to their first ``t`` slots."""
    slots = ("txn_id", "ts", "kind", "status", "active")
    return key_T[:, :t].contiguous(), {
        n: v[:t].contiguous() if n in slots else v for n, v in g.items()}


def _kernel_sweep(ctx):
    import numpy as np
    torch = ctx["torch"]
    dev = ctx["dev"]
    rng = np.random.default_rng(11)
    out = []
    cases = [("config4", SWEEP["config4"]["K"]), ("wide", SWEEP["wide"]["K"]),
             ("rows256", SWEEP["rows256"]["K"])]
    cases += [("protocol", k) for k in SWEEP["protocol"]["K"]]
    for case, k in cases:
        p = SWEEP[case]
        t, b = p["T"], p["B"]
        if case == "config4":
            key_T = torch.from_numpy(rng.integers(0, 2, (k, t), dtype=np.uint8))
            _ki, _l, lanes, ts, kind, status, active = make_index(
                np, rng, t, k, 2)
        else:
            key_inc, _l, lanes, ts, kind, status, active = make_index(
                np, rng, t, k, 2)
            key_T = torch.from_numpy(np.ascontiguousarray(
                (key_inc != 0).T).astype(np.uint8))
        _r, before, qkind = make_queries(np, rng, b, k, t, 2)
        g = {n: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for n, a in dict(txn_id=lanes, ts=ts, kind=kind, status=status,
                              active=active, before=before,
                              qkind=qkind).items()}
        key_T = key_T.to(dev)
        if case == "config4":
            for kpr in p["keys"]:
                rows = [sorted(int(c) for c in rng.choice(k, kpr, replace=False))
                        for _ in range(b)]
                out.append(_sweep_point(ctx, f"config4_{kpr}keys", key_T, g,
                                        rows))
            for short in p["short_T"]:
                out.append(_sweep_point(ctx, f"config4_{kpr}keys_T{short}",
                                        *_first_slots(key_T, g, short), rows))
        elif case == "rows256":
            for kpr in p["keys"]:
                rows = [sorted(int(c) for c in rng.choice(k, kpr, replace=False))
                        for _ in range(b)]
                out.append(_sweep_point(ctx, f"rows256_{kpr}keys", key_T, g,
                                        rows))
        elif case == "protocol":
            rows = [list(range(k))] * b
            for short in p["short_T"] + (t,):
                out.append(_sweep_point(ctx, f"full_rows_K{k}_T{short}",
                                        *_first_slots(key_T, g, short), rows))
        else:
            narrow, _b, _q = make_queries(np, rng, b - 1, k, t, 2)
            for w in p["cols"]:
                rows = [sorted(int(c) for c in rng.integers(0, k, w))] + narrow
                out.append(_sweep_point(ctx, f"wide_row_{w}cols", key_T, g,
                                        rows))
        del key_T
    return out


def _kernel_columns(ctx):
    """K1 (bool and bit-packed), K2 and K12 on rows whose columns are -1,
    -K, K and -K-1: the reference's densify names column c + K for c in
    [-K, -1] and drops the rest, and so must the kernels and their plain
    versions, which must agree exactly; then K12 on an empty batch (B = 0:
    empty answers, no launch)."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    t, k = 2064, 64                          # two CSR tiles; T % 16 == 0
    rng = np.random.default_rng(29)
    key_inc, live, lanes, ts, kind, status, active = make_index(
        np, rng, t, k, 2)
    rows = [[-1, -k, k], [-k - 1, 3], [-1], [2, -k], [k, -k - 1]]
    _q, before, qkind = make_queries(np, rng, len(rows), k, t, 2)
    offsets, cols = to_csr(np, rows)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(ctx["dev"])
    jargs = (up((live != 0).T.astype(np.uint8)), up(lanes), up(kind),
             up(status), up(active), up(offsets), up(cols), up(before),
             up(qkind))
    margs = (up((key_inc != 0).T.astype(np.uint8)), up(ts), up(lanes),
             up(active), up(offsets), up(cols))
    errs = {}
    for form in FORMS:
        k1 = ctx["real"][kernel_name("deps_join", form)]
        got = {"deps_join": k1(*jargs),
               "deps_join_packed": k1(*jargs, packed=True),
               "max_conflict": ctx["real"][kernel_name("max_conflict", form)](
                   *margs)}
        want = {"deps_join": K.deps_join_plain(*jargs),
                "deps_join_packed": K.deps_join_plain(*jargs, packed=True),
                "max_conflict": K.max_conflict_plain(*margs)}
        sync(ctx)
        errs[form] = {n: max_abs_err(torch, got[n], want[n]) for n in got}
        need(all(e == 0 for e in errs[form].values()),
             f"negative columns ({form}): kernels differ from their plain "
             f"versions {errs[form]}")
        # the wrapped columns name real keys; K and -K-1 alone name none
        need(bool(got["max_conflict"][2].any())
             and bool(got["deps_join"][0].any()),
             f"negative columns ({form}): the wrapped rows found no conflict")
        need(not bool(got["max_conflict"][4].any()),
             f"negative columns ({form}): a row of dropped columns found a "
             "conflict")
    fargs = (jargs[0], margs[0], margs[1], *jargs[1:])
    for pk in (False, True):
        got = ctx["real"][FUSED](*fargs, packed=pk)
        want = K.fused_consult_plain(*fargs, packed=pk)
        sync(ctx)
        errs[f"{FUSED}{'_packed' if pk else ''}"] = [
            max_abs_err(torch, got, want),
            max_abs_err(torch, got, _fused_halves(ctx, fargs, pk))]
    need(all(e == 0 for e in errs[FUSED] + errs[f"{FUSED}_packed"]),
         f"negative columns: K12 differs from its plain version or K1 + K2 "
         f"{errs}")
    empty = (*fargs[:7], fargs[7][:1].clone(), fargs[8], fargs[9][:0],
             fargs[10][:0])
    launched = dict(K.LAUNCHES)
    for pk in (False, True):
        deps, max_lanes = ctx["real"][FUSED](*empty, packed=pk)
        sync(ctx)
        need(tuple(deps.shape) == (0, t // 8 if pk else t)
             and tuple(max_lanes.shape) == (0, 5),
             f"empty batch: K12 answered {deps.shape}, {max_lanes.shape}")
    need(K.LAUNCHES == launched, "empty batch: K12 launched")
    return {"T": t, "K": k, "rows": rows, "max_abs_err": errs,
            "empty_batch": "no launch"}


# K1d/K2d on [K, T] (csrc/dense_join.cu) at their edges, forced dense: T =
# 1,040 (not a multiple of a 256-slot stage), K = 80 (a tail of a 128-key
# stage), B = 1, 63, 65, 255, 256 (one pass each) and 300 (two row tiles);
# each with the kinds as drawn and with half of them outside the witness
# table.  (label, T, K, B, keys per query row)
KT_EDGES = (("T1040", 1040, 64, 13, 24), ("K80", 4096, 80, 33, 40),
            ("B1", 4096, 256, 1, 96), ("B63", 4096, 256, 63, 96),
            ("B65", 4096, 256, 65, 96), ("B255", 4096, 256, 255, 96),
            ("B256", 16384, 512, 256, 200), ("B300", 4096, 256, 300, 96))
ODD_KINDS = (-1, -6, -7, -128, 9, 100, 127)


def _odd_kinds(np, rng, kinds):
    """``kinds`` with about half its codes outside the witness table."""
    out = kinds.copy()
    odd = rng.random(out.size) < 0.5
    out[odd] = rng.choice(ODD_KINDS, int(odd.sum()))
    return out


def _kt_edges(ctx):
    """K1d (bool and packed) and K2d at ``KT_EDGES``, each held exactly
    against the plain version; max_abs_err per case."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    rng = np.random.default_rng(43)
    out = {}
    for label, t, k, b, per_row in KT_EDGES:
        key_inc, live, lanes, ts, kind, status, active = make_index(
            np, rng, t, k, 2)
        rows = [sorted(int(c) for c in rng.choice(k, per_row, replace=False))
                for _ in range(b)]
        _r, before, qkind = make_queries(np, rng, b, k, t, 2)
        offsets, cols = to_csr(np, rows)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(ctx["dev"])
        for odd in (False, True):
            kd, qd = ((_odd_kinds(np, rng, kind), _odd_kinds(np, rng, qkind))
                      if odd else (kind, qkind))
            jargs = (up((live != 0).T.astype(np.uint8)), up(lanes), up(kd),
                     up(status), up(active), up(offsets), up(cols),
                     up(before), up(qd))
            margs = (up((key_inc != 0).T.astype(np.uint8)), up(ts), up(lanes),
                     up(active), up(offsets), up(cols))
            errs = {}
            for pk in (False, True):
                got = ctx["real"]["deps_join_dense"](*jargs, packed=pk)
                want = K.deps_join_plain(*jargs, packed=pk)
                errs[f"K1d{'_packed' if pk else ''}"] = max_abs_err(
                    torch, got, want)
            errs["K2d"] = max_abs_err(
                torch, ctx["real"]["max_conflict_dense"](*margs),
                K.max_conflict_plain(*margs))
            sync(ctx)
            name = f"{label}{'_odd_kinds' if odd else ''}"
            need(all(e == 0 for e in errs.values()),
                 f"[K, T] dense at {name} (T={t} K={k} B={b}) differs from "
                 f"its plain version: {errs}")
            out[name] = errs
    return out


def _parity(ctx):
    """The two inputs on which the port once differed from the reference,
    in every form on the card, each held exactly against the plain
    versions: kind
    codes outside the witness table in K1 (CSR), K1d on [K, T], K1d on
    [T, K] and K12; signed incidence bytes through the one-shot consult on the
    [T, K] kernels (K = 64 and 512) and on its CSR route (K = 72, the
    query's values beside its columns), with the launches of each."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    rng = np.random.default_rng(47)
    dev = ctx["dev"]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    t, k, b = 16384, 64, 33
    key_inc, live, lanes, ts, kind, status, active = make_index(
        np, rng, t, k, 2)
    rows = [sorted(int(c) for c in rng.choice(k, 40, replace=False))
            for _ in range(b)]
    _r, before, qkind = make_queries(np, rng, b, k, t, 2)
    kind, qkind = _odd_kinds(np, rng, kind), _odd_kinds(np, rng, qkind)
    offsets, cols = to_csr(np, rows)
    q = np.zeros((b, k), dtype=np.int8)
    for i, r in enumerate(rows):
        q[i, r] = 1
    jargs = (up((live != 0).T.astype(np.uint8)), up(lanes), up(kind),
             up(status), up(active), up(offsets), up(cols), up(before),
             up(qkind))
    want = K.deps_join_plain(*jargs)
    kinds = {form: max_abs_err(torch, ctx["real"][kernel_name(
        "deps_join", form)](*jargs), want) for form in FORMS}
    kinds["tk"] = max_abs_err(torch, ctx["real"]["deps_join_tk"](
        up(live), up(lanes), up(kind), up(status), up(active), up(q),
        up(before), up(qkind)), want)
    fargs = (jargs[0], up((key_inc != 0).T.astype(np.uint8)), up(ts),
             *jargs[1:])
    kinds[FUSED] = max(max_abs_err(torch, ctx["real"][FUSED](*fargs)[0],
                                   want),
                       max_abs_err(torch, ctx["real"][FUSED](*fargs),
                                   K.fused_consult_plain(*fargs)))
    sync(ctx)
    need(all(e == 0 for e in kinds.values()),
         f"kind codes outside the table: a K1 form differs {kinds}")
    signed = {}
    for k2, t2 in ((64, 16384), (512, 16384), (72, 4096)):
        def vals(shape, p):
            x = rng.integers(-2, 3, shape) * (rng.random(shape) < p)
            ext = rng.random(shape) < 0.01
            x[ext] = rng.choice([-128, 127], int(ext.sum()))
            return x.astype(np.int8)
        inc = vals((t2, k2), 0.3)
        key2, _l, lanes2, ts2, kind2, status2, active2 = make_index(
            np, rng, t2, 16, 2)
        _r, before2, qkind2 = make_queries(np, rng, b, 16, t2, 2)
        args = (up(inc * (rng.random(inc.shape) < 0.8)), up(inc), up(ts2),
                up(lanes2), up(_odd_kinds(np, rng, kind2)), up(status2),
                up(active2), up(vals((b, k2), 0.2)), up(before2),
                up(_odd_kinds(np, rng, qkind2)))
        K.reset_launches()
        got = dk.consult(*args)
        sync(ctx)
        launches = {n: v for n, v in K.LAUNCHES.items() if v}
        plain = (K.deps_join_tk_plain(args[0], *args[3:7], args[7], *args[8:]),
                 K.max_conflict_tk_plain(args[1], args[2], args[3], args[6],
                                         args[7]))
        errs = [max_abs_err(torch, a, w) for a, w in zip(got, plain)]
        route = "tk" if K.tk_refusal(k2) is None else "csr"
        need(all(e == 0 for e in errs) and launches == (
            {n: 1 for n in TK_KERNELS} if route == "tk"
            else {n: 1 for n in CSR_KERNELS}),
             f"signed bytes at K={k2} ({route} route): errors {errs}, "
             f"launches {launches}")
        signed[f"K{k2}_{route}"] = {"max_abs_err": max(errs),
                                    "launches": launches,
                                    "deps_found": int(got[0].sum())}
    return {"negative_kinds_max_abs_err": kinds, "signed_bytes": signed}


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
    wall = time.perf_counter() - t0 - chk.check_s
    launches = dict(K.LAUNCHES)
    need(answered == windows * b, f"answered {answered}")
    need_csr_only(launches, "the service")
    need(chk.k1_calls() == k1_launches(launches), "uncounted launch")
    checked = chk.checked
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
    # device path (no service: one K12 launch per consult batch)
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
            need_csr_only(launches, f"{name} burn")
            need(res.stats.get("resolver_device_consults", 0) > 0,
                 f"{name} burn made no device consult")
            if name == "torch":
                ctx["burn_launches"] = launches
                ctx["burn_checker"] = chk
            else:
                out["oneshot_launches"] = launches
        wall = time.perf_counter() - t0 - (
            checkers[name].check_s if name in checkers else 0.0)
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
               checked_calls=ctx["burn_checker"].checked,
               oneshot_checked_calls=checkers["oneshot"].checked,
               trace_equal_to_host=True, oneshot_trace_equal_to_host=True,
               verifier="pass")
    return out


# the cli phase: the burn CLI's full fault matrix (chaos, churn,
# crash-restart, pause, disk stall, journal corruption; verify skill item
# 6) at 120 ops, the device tier forced through the environment the CLI
# reads (config.py); each run on the card's backend and on the host
# backend.  Seeds 0 and 1 on the default cadences inject no crash in 120
# ops (a restart every 20 sim-s, a run lasts 7-8), so seed 1 runs once
# more with the cadences the CLI also reads from the environment cut to
# a restart every 3 sim-s, a pause or a disk stall every 4: its nodes
# crash, restart and rebuild their stores from the journal.  Then seed 0
# under the CLI's workload presets (multirange: multi-key and range
# transactions; zipf: skewed keys; openloop: arrivals at a fixed rate) and
# under membership churn (--elastic: joins and decommissions under load),
# these four cut to 60 ops for the script's time
RESTARTS_ENV = dict(ACCORD_RESTART_INTERVAL="3", ACCORD_PAUSE_INTERVAL="4",
                    ACCORD_DISK_STALL_INTERVAL="4")
CLI = dict(runs=(("0", 0, 120, {}, ()), ("1", 1, 120, {}, ()),
                 ("1_restarts", 1, 120, RESTARTS_ENV, ()),
                 ("0_multirange", 0, 60, {}, ("--workload", "multirange")),
                 ("0_zipf", 0, 60, {}, ("--workload", "zipf")),
                 ("0_openloop", 0, 60, {}, ("--workload", "openloop")),
                 ("0_elastic", 0, 60, {}, ("--elastic",))),
           budget_s=240.0)
# the device tier forced through the consult service, set through the
# environment that the CLI and the Maelstrom adapter read (config.py)
DEVICE_TIER_ENV = dict(ACCORD_RESOLVER="tpu", ACCORD_TPU_TIER="device",
                       ACCORD_TPU_WALK_MAX="0", ACCORD_TPU_WALK_WIDTH="0",
                       ACCORD_TPU_SERVICE="on")
CLI_OUTCOME = ("status", "rf", "resolved", "ok", "recovered", "nacked",
               "lost", "failed", "shed", "sim_ms", "faults")


@contextlib.contextmanager
def _environ(**kv):
    """``os.environ`` with ``kv`` set, restored on the way out."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _file_digest(path):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@contextlib.contextmanager
def _resolver_calls(names=("_grow", "_rebuild")):
    """Counts calls of the device resolver's index growth and rebuild while
    installed (the paths a restart or a full index takes)."""
    from cassandra_accord_tpu_torch.impl.tpu_resolver import TpuDepsResolver
    counts = dict.fromkeys(names, 0)
    real = {n: getattr(TpuDepsResolver, n) for n in names}

    def counted(name):
        def call(self, *args, **kwargs):
            counts[name] += 1
            return real[name](self, *args, **kwargs)
        return call
    for n in names:
        setattr(TpuDepsResolver, n, counted(n))
    try:
        yield counts
    finally:
        for n in names:
            setattr(TpuDepsResolver, n, real[n])


def _cli_run(ctx, tmp, label, seed, ops, env, extra, backend):
    """One seed through ``harness.burn.main`` (with the arguments ``extra``)
    on one service backend, its
    stdout kept in OUT_DIR: (JSON entry, provenance dump, wall s, and
    on the card's backend the launches, the recorder and the resolver's
    grow/rebuild calls)."""
    from cassandra_accord_tpu_torch.harness import burn
    from cassandra_accord_tpu_torch.ops import _kernels as K
    js = os.path.join(tmp, f"{label}_{backend}.json")
    prov = os.path.join(tmp, f"{label}_{backend}_prov.json")
    argv = ["--seeds", str(seed), "--ops", str(ops), "--audit=strict",
            "--json", js, "--provenance", prov, *extra]
    log = io.StringIO()
    launches = chk = calls = None
    t0 = time.perf_counter()
    try:
        with _environ(**DEVICE_TIER_ENV, **env, ACCORD_DEVICE=ctx["dev"],
                      ACCORD_TPU_SERVICE_BACKEND=backend), \
                contextlib.redirect_stdout(log):
            if backend == "torch":
                with KernelRecorder(ctx["torch"], K, every=10) as chk, \
                        _resolver_calls() as calls:
                    K.reset_launches()               # just before the run
                    burn.main(argv)
                    sync(ctx)
                    launches = dict(K.LAUNCHES)      # just after it
            else:
                burn.main(argv)
    except SystemExit as e:          # a stall (2) or a failed acceptance
        raise PhaseFailed(f"burn CLI run {label} on {backend} exited "
                          f"{e.code}") from e
    finally:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"cli_{label}_{backend}.log"),
                  "w") as f:
            f.write(log.getvalue())
    wall = time.perf_counter() - t0 - (chk.check_s if chk else 0.0)
    with open(js) as f:
        entry = json.load(f)["results"][0]
    return entry, prov, wall, (launches, chk, calls)


def _cli_gate(ctx, tmp):
    """tools_torch/perfgate.py under the device tier: the smoke's sim block
    equals the host resolver's, the gate passes, its trend record goes to
    a temporary ledger and never to the repository's."""
    from cassandra_accord_tpu_torch.ops import _kernels as K
    from tools_torch import perfgate
    history = os.path.join(tmp, "history.jsonl")
    repo_history = os.path.join(HERE, "BENCH_HISTORY.jsonl")
    kept = _file_digest(repo_history)
    report = io.StringIO()
    with _environ(ACCORD_BENCH_HISTORY=history):
        need("ACCORD_PERFGATE_INJECT_LATENCY" not in os.environ,
             "the gate's latency-injection hook is set")
        t0 = time.perf_counter()
        host = perfgate.measure_smoke()
        host_s = time.perf_counter() - t0
        with _environ(**DEVICE_TIER_ENV, ACCORD_DEVICE=ctx["dev"],
                      ACCORD_TPU_SERVICE_BACKEND="torch"):
            K.reset_launches()
            t0 = time.perf_counter()
            dev = perfgate.measure_smoke()
            sync(ctx)
            dev_s = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            rc = perfgate.run(gate=True, out=report)
    need(dev["sim"] == host["sim"],
         f"gate smoke under the device tier {dev['sim']} differs from the "
         f"host resolver's {host['sim']}")
    need_csr_only(launches, "the gate smoke under the device tier")
    need(rc == 0, "the port's gate failed under the device tier:\n"
         + report.getvalue()[-2000:])
    with open(history) as f:
        records = [json.loads(x) for x in f if x.strip()]
    need(len(records) == 1 and records[0]["kind"] == "perfgate",
         f"trend ledger records {records}")
    need(_file_digest(repo_history) == kept,
         "the repository's BENCH_HISTORY.jsonl changed")
    return {"sim": dev["sim"], "sim_equal_to_host": True, "gate_rc": rc,
            "host_smoke_s": host_s, "device_smoke_s": dev_s,
            "device_smoke_launches": launches,
            "device_commits_per_s": dev["wall"]["commits_per_sec"]}


def phase_cli(ctx):
    import tempfile
    from tools_torch import explain
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    runs, totals = {}, {FUSED: 0}
    try:
        for label, seed, ops, env, extra in CLI["runs"]:
            host, host_prov, host_s, _ = _cli_run(ctx, tmp, label, seed, ops,
                                                  env, extra, "host")
            card, card_prov, card_s, (launches, chk, calls) = _cli_run(
                ctx, tmp, label, seed, ops, env, extra, "torch")
            audit = card.get("audit") or {}
            need(card["status"] == "pass" and audit.get("violations") == 0,
                 f"run {label}: status {card['status']}, audit {audit}")
            got = {k: card.get(k) for k in CLI_OUTCOME}
            want = {k: host.get(k) for k in CLI_OUTCOME}
            need(got == want, f"run {label}: outcomes {got} differ from the "
                 f"host backend's {want}")
            need(audit == host.get("audit"),
                 f"run {label}: audit verdict differs from the host backend's")
            if env:
                need(card["faults"].get("node_restarts", 0) > 0,
                     f"run {label}: no node restarted: {card['faults']}")
            consults = card["metrics"].get("resolver.device_consults", 0)
            need(consults > 0, f"run {label}: no device consult")
            need_csr_only(launches, f"run {label}: the CLI run")
            need(chk.k1_calls() == k1_launches(launches),
                 f"run {label}: uncounted launch")
            checked = chk.checked
            need(checked > 0, f"run {label}: no kernel call checked")
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = explain.main([host_prov, card_prov])
            tail = json.loads(out.getvalue().strip().splitlines()[-1])
            need(rc == 0 and tail.get("identical") is True,
                 f"run {label}: causal DAGs differ (explain rc {rc}): {tail}")
            for name in totals:
                totals[name] += launches[name]
            largest = ctx.setdefault("cli_largest", {})
            for name, call in chk.largest.items():
                if call[0] >= largest.get(name, (-1,))[0]:
                    largest[name] = call
            runs[label] = {
                "seed": seed, "ops": ops, "env": env, "args": list(extra),
                "wall_s": {"torch": card_s, "host": host_s},
                "cli_wall_s": {"torch": card["wall_s"], "host": host["wall_s"]},
                "outcome": got, "audit": audit,
                "device_consults": consults,
                "service_batches":
                    card["metrics"].get("resolver.service_batches", 0),
                "host_consults": card["metrics"].get("resolver.host_consults"),
                "launches": launches, "checked_calls": checked,
                "resolver_calls": calls,
                "explain": {"rc": rc, "events": tail.get("events_a")}}
        ctx["cli_launches"] = totals
        gate = _cli_gate(ctx, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    need(seconds <= CLI["budget_s"],
         f"cli phase took {seconds:.1f} s > {CLI['budget_s']} s")
    return {"runs": runs, "launches": totals,
            "gate": gate, "nvidia_smi": ctx.get("smi_line")}


# the maelstrom phase: the Maelstrom adapter (maelstrom/, carried from the
# reference) on the device tier.  MaelstromNode builds its Node without a
# config, so the tier is set only through the environment (LocalConfig.
# from_env); the binary's main.py adds only the device tier's warm-up on
# init.  The in-process runs are tests/test_maelstrom.py's shapes
# (:133-148) at 100 ops instead of 40; the stdio binary gets that file's
# three packets (:155-163) and 30 more list-append txns on 4 keys
MAELSTROM = dict(runs=((1, 3, None), (2, 5, 1.5), (9, 5, 1.5)), ops=100,
                 stdio_txns=30, stdio_keys=4, stdio_timeout_s=120.0,
                 budget_s=90.0)


@contextlib.contextmanager
def _resolvers():
    """The TpuDepsResolvers made while installed (their consult counters
    outlive the run that made them)."""
    from cassandra_accord_tpu_torch.impl.tpu_resolver import TpuDepsResolver
    made = []
    real = TpuDepsResolver.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        made.append(self)
    TpuDepsResolver.__init__ = init
    try:
        yield made
    finally:
        TpuDepsResolver.__init__ = real


def _maelstrom_run(ctx, seed, nodes, partitions, backend):
    """One in-process run_workload on one service backend: (output, wall s,
    device consults, and on the card's backend launches and recorder)."""
    from cassandra_accord_tpu_torch.maelstrom.runner import run_workload
    from cassandra_accord_tpu_torch.ops import _kernels as K
    launches = chk = None
    with _environ(**DEVICE_TIER_ENV, ACCORD_DEVICE=ctx["dev"],
                  ACCORD_TPU_SERVICE_BACKEND=backend), _resolvers() as made:
        t0 = time.perf_counter()
        if backend == "torch":
            with KernelRecorder(ctx["torch"], K, every=10) as chk:
                K.reset_launches()                   # just before the run
                out = run_workload(seed, n_nodes=nodes, ops=MAELSTROM["ops"],
                                   partition_interval_s=partitions, check=True)
                sync(ctx)
                launches = dict(K.LAUNCHES)          # just after it
        else:
            out = run_workload(seed, n_nodes=nodes, ops=MAELSTROM["ops"],
                               partition_interval_s=partitions, check=True)
        wall = time.perf_counter() - t0 - (chk.check_s if chk else 0.0)
    consults = sum(r.device_consults for r in made)
    return out, wall, consults, launches, chk


def _stdio_packets():
    """test_stdio_single_node's init and two txns, then list-append txns of
    1-3 micro-ops on a few keys from a fixed seed (each appended value
    unique, as the list-append checker needs)."""
    import random
    rng = random.Random(13)
    packets = [
        {"src": "c1", "dest": "n1",
         "body": {"type": "init", "msg_id": 1, "node_id": "n1",
                  "node_ids": ["n1"]}},
        {"src": "c1", "dest": "n1",
         "body": {"type": "txn", "msg_id": 2,
                  "txn": [["append", 5, 1], ["r", 5, None]]}},
        {"src": "c1", "dest": "n1",
         "body": {"type": "txn", "msg_id": 3,
                  "txn": [["append", 5, 2], ["r", 5, None]]}}]
    value = 100
    for i in range(MAELSTROM["stdio_txns"]):
        ops = []
        for _ in range(rng.randint(1, 3)):
            key = rng.randrange(MAELSTROM["stdio_keys"])
            if rng.random() < 0.5:
                ops.append(["r", key, None])
            else:
                value += 1
                ops.append(["append", key, value])
        packets.append({"src": "c1", "dest": "n1",
                        "body": {"type": "txn", "msg_id": 4 + i, "txn": ops}})
    return packets


# the binary's entry point (``python -m cassandra_accord_tpu_torch.
# maelstrom``) run through runpy, so that the process reports on stderr at
# exit what its resolvers did: the kernels' launch counts and the device
# consults of every TpuDepsResolver it made
STDIO_MAIN = """
import atexit, json, runpy, sys
from cassandra_accord_tpu_torch.impl.tpu_resolver import TpuDepsResolver
from cassandra_accord_tpu_torch.ops import _kernels as K
made, init = [], TpuDepsResolver.__init__
def track(self, *args, **kwargs):
    init(self, *args, **kwargs)
    made.append(self)
TpuDepsResolver.__init__ = track
atexit.register(lambda: print("STDIO_COUNTS " + json.dumps(
    {"launches": dict(K.LAUNCHES),
     "device_consults": sum(r.device_consults for r in made)}),
    file=sys.stderr))
runpy.run_module("cassandra_accord_tpu_torch.maelstrom", run_name="__main__",
                 alter_sys=True)
"""


def _stdio_run(ctx, packets, backend):
    """The Maelstrom node binary as Maelstrom runs it: a subprocess fed
    JSON lines on stdin.  Stdin stays open until every request has its
    reply (the binary stops at end of input), then closes.  Returns (reply
    body by in_reply_to, exit code, stderr, wall s, the counts the process
    reported at exit)."""
    import queue
    import tempfile
    import threading
    env = dict(os.environ, **DEVICE_TIER_ENV, ACCORD_DEVICE=ctx["dev"],
               ACCORD_TPU_SERVICE_BACKEND=backend)
    env["PYTHONPATH"] = os.pathsep.join(
        x for x in (HERE, env.get("PYTHONPATH")) if x)
    want = {p["body"]["msg_id"] for p in packets}
    replies = {}
    lines = queue.Queue()
    t0 = time.perf_counter()
    with tempfile.TemporaryFile(mode="w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", STDIO_MAIN],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
            text=True, cwd=HERE, env=env)
        try:
            reader = threading.Thread(
                target=lambda: [lines.put(x) for x in proc.stdout] + [
                    lines.put(None)], daemon=True)
            reader.start()
            proc.stdin.write("".join(json.dumps(p) + "\n" for p in packets))
            proc.stdin.flush()
            deadline = time.monotonic() + MAELSTROM["stdio_timeout_s"]
            while want - replies.keys():
                try:
                    line = lines.get(timeout=max(0.0, deadline -
                                                 time.monotonic()))
                except queue.Empty:
                    raise PhaseFailed(
                        f"stdio binary ({backend}): no reply to "
                        f"{sorted(want - replies.keys())} in "
                        f"{MAELSTROM['stdio_timeout_s']} s") from None
                if line is None:
                    break
                packet = json.loads(line)
                if packet.get("dest") == "c1":
                    body = packet["body"]
                    replies[body.get("in_reply_to")] = body
            proc.stdin.close()
            rc = proc.wait(timeout=60)
            reader.join(timeout=10)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        stderr = err.read()
    wall = time.perf_counter() - t0
    counts = [json.loads(x.split(" ", 1)[1]) for x in stderr.splitlines()
              if x.startswith("STDIO_COUNTS ")]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"maelstrom_stdio_{backend}.log"),
              "w") as f:
        f.write(json.dumps({str(k): v for k, v in sorted(
            replies.items(), key=lambda kv: str(kv[0]))}, indent=1))
        f.write("\n--- stderr ---\n" + stderr)
    return replies, rc, stderr, wall, counts[-1] if counts else None


def phase_maelstrom(ctx):
    t0 = time.perf_counter()
    runs, totals = {}, {FUSED: 0}
    for seed, nodes, partitions in MAELSTROM["runs"]:
        host, host_s, _, _, _ = _maelstrom_run(ctx, seed, nodes, partitions,
                                               "host")
        card, card_s, consults, launches, chk = _maelstrom_run(
            ctx, seed, nodes, partitions, "torch")
        label = f"seed{seed}_n{nodes}"
        need(card == host, f"maelstrom {label}: the card's output {card} "
             f"differs from the host backend's {host}")
        need(card["ok"] == MAELSTROM["ops"],
             f"maelstrom {label}: {card['ok']} of {MAELSTROM['ops']} ok")
        need_csr_only(launches, f"maelstrom {label}")
        need(chk.k1_calls() == k1_launches(launches),
             f"maelstrom {label}: uncounted launch")
        need(consults > 0, f"maelstrom {label}: no device consult")
        _keep_largest(ctx, "maelstrom", chk)
        checked = chk.checked
        need(checked > 0, f"maelstrom {label}: no kernel call checked")
        for name in totals:
            totals[name] += launches[name]
        runs[label] = {"seed": seed, "nodes": nodes,
                       "partition_interval_s": partitions,
                       "ops": MAELSTROM["ops"],
                       "wall_s": {"torch": card_s, "host": host_s},
                       "device_consults": consults,
                       "launches": launches, "checked_calls": checked,
                       "output": {k: card[k] for k in card if k != "history"},
                       "history": card.get("history")}
    packets = _stdio_packets()
    stdio = {}
    for backend in ("host", "torch"):
        replies, rc, stderr, wall, counts = _stdio_run(ctx, packets, backend)
        need(rc == 0, f"stdio binary ({backend}) exited {rc}:\n"
             f"{stderr[-2000:]}")
        need("Traceback" not in stderr,
             f"stdio binary ({backend}) printed a traceback:\n"
             f"{stderr[-2000:]}")
        need(counts is not None, f"stdio binary ({backend}) reported no "
             f"counts at exit:\n{stderr[-2000:]}")
        if backend == "torch":
            need_csr_only(counts["launches"], "stdio binary on the card")
            need(counts["device_consults"] > 0,
                 f"stdio binary on the card: {counts}")
        else:
            need(not any(counts["launches"].values())
                 and counts["device_consults"] == 0,
                 f"stdio binary on the host backend used the card: {counts}")
        stdio[backend] = (replies, wall, counts)
    strip = ("msg_id",)      # numbered in reply order, which may differ

    def bodies(replies):
        return {k: {f: v for f, v in b.items() if f not in strip}
                for k, b in replies.items()}
    card, host = bodies(stdio["torch"][0]), bodies(stdio["host"][0])
    differ = sorted(k for k in host if card.get(k) != host[k])
    need(card == host, "stdio binary: the card's replies differ from the "
         f"host backend's: {differ}; the first, card "
         f"{card.get(differ[0]) if differ else None} against host "
         f"{host.get(differ[0]) if differ else None}")
    types = {}
    for b in card.values():
        types[b["type"]] = types.get(b["type"], 0) + 1
    need(card[1]["type"] == "init_ok" and card[2]["type"] == "txn_ok"
         and card[2]["txn"][1] == ["r", 5, []] and card[3]["type"] == "txn_ok"
         and card[3]["txn"][1] == ["r", 5, [1]],
         f"stdio binary: replies to 1-3 are not test_stdio_single_node's: "
         f"{[card.get(i) for i in (1, 2, 3)]}")
    ctx["maelstrom_launches"] = totals
    ctx["maelstrom_stdio_launches"] = stdio["torch"][2]["launches"]
    seconds = time.perf_counter() - t0
    need(seconds <= MAELSTROM["budget_s"],
         f"maelstrom phase took {seconds:.1f} s > {MAELSTROM['budget_s']} s")
    return {"runs": runs, "launches": totals,
            "stdio": {"requests": len(packets), "reply_types": types,
                      "equal_to_host": True,
                      "wall_s": {b: stdio[b][1] for b in stdio},
                      "counts": {b: stdio[b][2] for b in stdio}},
            "nvidia_smi": ctx.get("smi_line")}


# the verify phase: the reference's strongest oracle on the device tier.
# VerifyDepsResolver answers every query on both the cfk walk and the
# device resolver and raises when they differ; with frontier_exec the burn
# also checks frontier parity every 0.7 sim-s (harness/burn.py:432).  The
# card's run is held against the host backend's and against the same
# backend on the CPU (the plain versions), which names its consults as the
# card's backend does
VERIFY = dict(kw=dict(BURN_KW, resolver="verify"), budget_s=120.0)


def phase_verify(ctx):
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.config import LocalConfig
    from cassandra_accord_tpu_torch.harness.burn import run_burn
    from cassandra_accord_tpu_torch.harness.trace import Trace, diff_traces
    from cassandra_accord_tpu_torch.ops import _kernels as K
    t0 = time.perf_counter()
    cfg = dict(resolver_kind="verify", tpu_tier="device", tpu_walk_max=0,
               tpu_walk_width=0, tpu_service="on")
    runs = {"host": dict(device=ctx["dev"], tpu_service_backend="host"),
            "torch": dict(device=ctx["dev"], tpu_service_backend="torch"),
            "cpu": dict(device="cpu", tpu_service_backend="torch")}
    res, walls, traces = {}, {}, {}
    for name, knobs in runs.items():
        node_config = LocalConfig.from_env(**cfg, **knobs)
        traces[name] = Trace()
        kw = dict(VERIFY["kw"], tracer=traces[name].hook,
                  node_config=node_config)
        w0 = time.perf_counter()
        if name == "torch":
            with KernelRecorder(torch, K, every=10) as chk:
                K.reset_launches()                   # just before the run
                res[name] = run_burn(**kw)
                sync(ctx)
                launches = dict(K.LAUNCHES)          # just after it
            walls[name] = time.perf_counter() - w0 - chk.check_s
        else:
            res[name] = run_burn(**kw)
            walls[name] = time.perf_counter() - w0

    # which tier answered is the backend's to name: the host backend
    # answers every window on the host (native or host consults) and
    # eagerly, the card's backend defers a window until an answer is
    # demanded (service.py), so those counters are held against the CPU
    # witness only
    split = ("resolver_device_consults", "resolver_native_consults",
             "resolver_service_batches")

    def outcome(r, keep_split=False):
        return {"ops_ok": r.ops_ok, "ops_recovered": r.ops_recovered,
                "ops_nacked": r.ops_nacked, "ops_lost": r.ops_lost,
                "ops_failed": r.ops_failed, "sim_micros": r.sim_micros,
                **{k: v for k, v in sorted(r.stats.items())
                   if k.startswith("resolver_")
                   and (keep_split or k not in split)}}
    for other in ("host", "cpu"):
        div = diff_traces(traces["torch"], traces[other])
        need(div is None, f"verify burn: the card's trace differs from the "
             f"{other} run's:\n{div}")
        card, want = (outcome(res[x], keep_split=other == "cpu")
                      for x in ("torch", other))
        need(card == want, f"verify burn: the card's outcome {card} differs "
             f"from the {other} run's {want}")
    card = outcome(res["torch"], keep_split=True)
    need(card["ops_ok"] > 0 and res["torch"].resolved == VERIFY["kw"]["ops"],
         f"verify burn resolved {res['torch'].resolved} of "
         f"{VERIFY['kw']['ops']}")
    need(card["resolver_device_consults"] > 0,
         "verify burn: no device consult")
    need_csr_only(launches, "verify burn")
    need(chk.k1_calls() == k1_launches(launches),
         "verify burn: uncounted launch")
    need(chk.checked > 0, "verify burn: no kernel call checked")
    ctx["verify_launches"] = launches
    _keep_largest(ctx, "verify", chk)
    seconds = time.perf_counter() - t0
    need(seconds <= VERIFY["budget_s"],
         f"verify phase took {seconds:.1f} s > {VERIFY['budget_s']} s")
    return {"ops": VERIFY["kw"]["ops"], "seed": VERIFY["kw"]["seed"],
            "outcome": card, "trace_equal_to_host": True,
            "equal_to_cpu_witness": True,
            "consult_split": {b: {k: res[b].stats.get(k, 0) for k in split}
                              for b in res},
            "wall_s": walls, "launches": launches,
            "checked_calls": chk.checked,
            "nvidia_smi": ctx.get("smi_line")}


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
    """Installed over ``_kernels.deps_join`` and ``deps_join_tk`` while the
    graph path runs: the real wrappers do every launch (and its count);
    each call's inputs are copied, because the step then writes the state
    in place, and ``verify`` holds each answer against the plain version
    exactly.  ``last``: (wrapper, args, kwargs) of the last call checked."""

    NAMES = ("deps_join", "deps_join_tk")

    def __init__(self, torch, kmod):
        self.torch, self.k = torch, kmod
        self.real = {n: getattr(kmod, n) for n in self.NAMES}
        self.pending, self.checked, self.last = [], 0, None

    def _wrap(self, name):
        def call(*args, **kwargs):
            got = self.real[name](*args, **kwargs)
            self.pending.append(
                (name, tuple(a.clone() if isinstance(a, self.torch.Tensor)
                             else a for a in args), kwargs, got))
            return got
        return call

    def verify(self):
        for name, args, kwargs, got in self.pending:
            want = getattr(self.k, f"{name}_plain")(*args, **kwargs)
            need(self.torch.equal(got, want),
                 f"{name} differs from its plain version on the graph path")
            self.checked += 1
            self.last = (name, args, kwargs)
        self.pending = []

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.k, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n in self.NAMES:
            setattr(self.k, n, self.real[n])


def _wrapper_calls(torch, fn, args):
    """[(wrapper, args, kwargs)]: the kernel wrapper calls ``fn(*args)``
    makes (its route by the rule), for timing at the path's own shapes."""
    from cassandra_accord_tpu_torch.ops import _kernels as K
    with KernelRecorder(torch, K, every=0) as chk:
        fn(*args)
    return [(name, a, kw) for name, (_s, a, kw) in sorted(chk.largest.items())]


def _join_call(torch, args):
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    return _wrapper_calls(torch, dk.overlap_join, args)


def _consult_calls(torch, args):
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    return _wrapper_calls(torch, dk.consult, args)


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
    need(k1_launches(launches) == steps,
         f"the graph path launched K1 {k1_launches(launches)} times, "
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
    # eager, as the step calls it
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
           "k1_launches": k1_launches(launches),
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
    del deps, done, ready, ready_e, src, dst
    out["step_kernels"] = _step_kernels(ctx, state, steps, launches)
    del state
    return out


def _step_kernels(ctx, state, steps, launches):
    """The step's own kernels at the graph path's shapes, on clones of its
    final state: ``write_rows`` (the witness's fields, then the
    stabilisation's), ``frontier`` and ``lex_max_deps`` each bit-equal to
    its plain version, launched twice, once and once a step on the counted
    path; their ms (from a CUDA graph), plain ms and bounds go to the
    kernels line."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    from cassandra_accord_tpu_torch.ops import graph_state as gs
    need(launches["write_rows"] == 2 * steps,
         f"write_rows launched {launches['write_rows']} times, expected "
         f"two per step ({2 * steps})")
    need(launches["frontier"] == steps,
         f"frontier launched {launches['frontier']} times, expected one "
         f"per step ({steps})")
    need(launches["lex_max_deps"] == steps,
         f"lex_max_deps launched {launches['lex_max_deps']} times, expected "
         f"one per step ({steps})")
    t, k, b = state.txn_slots, state.key_slots, GRAPH["B"]
    dev, flush = ctx["dev"], ctx["flush"]
    rng = np.random.default_rng(23)
    # slots drawn with repeats from [-T - 3, T + 3) (wrapped and dropped
    # ones), a fifth padding, and a valid row at T - 1 before padding rows
    slots = rng.integers(-t - 3, t + 3, b)
    valid = rng.random(b) < 0.8
    slots[0], valid[0] = t - 1, True
    slots = torch.from_numpy(slots.astype(np.int32)).to(dev)
    valid = torch.from_numpy(valid).to(dev)
    key_inc = torch.randint(-3, 4, (b, k), dtype=torch.int8, device=dev)
    lanes = torch.randint(0, 1 << 30, (b, gs.TS_LANES), dtype=torch.int32,
                          device=dev)
    kind = torch.randint(0, 6, (b,), dtype=torch.int8, device=dev)
    deps = torch.rand(b, t, device=dev) < 0.01
    win = int(gs.last_writers(
        torch.where(valid, gs.wrap_index(slots.long(), t), t - 1), t,
        keep=valid).sum())

    def witness(write, st):
        write(st, slots, valid, key_inc=key_inc, ts=lanes, txn_id=lanes,
              kind=kind, status=gs.PREACCEPTED, adj=deps, active=True)

    def stabilise(write, st):
        write(st, slots, valid, ts=lanes + 1, status=gs.STABLE)
    rows = []
    got = gs.GraphState(*(x.clone() for x in state))
    want = gs.GraphState(*(x.clone() for x in state))
    for label, phase, nbytes in (
            ("witness", witness, 2 * (k + 41 + t) + 2),
            ("stabilisation", stabilise, 2 * 20 + 2)):
        phase(K.write_rows, got)
        phase(K.write_rows_plain, want)
        sync(ctx)
        for f, x, y in zip(gs.GraphState._fields, got, want):
            need(torch.equal(x, y), f"write_rows ({label}): state.{f} "
                 "differs from its plain version")
        # slots and valid flags read, each winning row's fields moved
        nbytes = 9 * b + win * nbytes
        rows.append({
            "name": "write_rows", "shape": f"graph_{label}_T{t}_K{k}_B{b}",
            "path": "graph", "B": b, "T": t, "K": k, "nnz": win,
            "packed": False, "max_abs_err": 0,
            "ms": device_ms(torch, lambda: phase(K.write_rows, got), 20,
                            flush),
            "warm_ms": device_ms(torch, lambda: phase(K.write_rows, got), 20),
            "method_floor_ms": method_floor_ms(ctx, 20),
            "wrapper_host_us": host_us(
                torch, lambda: phase(K.write_rows, got), 20),
            "plain_ms": eager_ms(
                torch, lambda: phase(K.write_rows_plain, want), 5, flush),
            "library_ms": None,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "ops": 0})
    del got, want, key_inc, deps
    # the final state's frontier: the ready rows' adjacency read once,
    # the blocked and ready flags read, the ready flags written
    blocked = ~((state.status == gs.APPLIED)
                | (state.status == gs.INVALIDATED) | ~state.active)
    ready = state.active & (state.status == gs.STABLE)
    cand = int(ready.sum())
    out = K.frontier_rows(state.adj, blocked, ready.clone())
    want = K.frontier_rows_plain(state.adj, blocked, ready.clone())
    need(torch.equal(out, want), "frontier differs from its plain version")
    scratch = ready.clone()

    def frontier():
        scratch.copy_(ready)
        K.frontier_rows(state.adj, blocked, scratch)
    nbytes = cand * t + 3 * t
    rows.append({
        "name": "frontier", "shape": f"graph_final_T{t}_K{k}", "path": "graph",
        "B": cand, "T": t, "K": k, "nnz": int(want.sum()), "packed": False,
        "max_abs_err": 0, "ms": device_ms(torch, frontier, 20, flush),
        "warm_ms": device_ms(torch, frontier, 20),
        "method_floor_ms": method_floor_ms(ctx, 20),
        "wrapper_host_us": host_us(torch, frontier, 20),
        "plain_ms": eager_ms(torch, lambda: K.frontier_rows_plain(
            state.adj, blocked, ready.clone()), 5, flush),
        "library_ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "bytes": nbytes, "ops": 0})
    rows += _lex_max_rows(ctx, state.ts, b)
    ctx["rows"].extend(rows)
    return rows


# the lex max's rows by density: sparse ones (the step cells' rows), then
# an all-true and an all-false row every 64, and a dense one every 32
LEX_DENSITY = (0.001, 0.01, 0.05, 0.2)


def _lex_max_rows(ctx, ts_full, b):
    """``lex_max_deps`` on the final state's executeAt lanes, at the step's
    T and the mesh rank's (its first T / 4 slots): bit-equal to its plain
    version over rows of every density, all-true and all-false rows, then
    timed (a CUDA graph of calls, cold and warm), the plain version eager."""
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    dev, flush = ctx["dev"], ctx["flush"]
    rows = []
    for label, t in (("graph_final", ts_full.shape[0]),
                     ("mesh_rank", ts_full.shape[0] // MESH["ranks"])):
        ts = ts_full[:t].contiguous()
        gen = torch.Generator(device=dev).manual_seed(29)
        dens = torch.tensor([LEX_DENSITY[i % len(LEX_DENSITY)]
                             for i in range(b)], device=dev)
        deps = torch.rand((b, t), device=dev, generator=gen) < dens[:, None]
        deps[::64] = True
        deps[1::64] = False
        deps[2::32] = torch.rand((t,), device=dev, generator=gen) < 0.9
        got = K.lex_max_deps(ts, deps)
        want = K.lex_max_deps_plain(ts, deps)
        need(all(torch.equal(x, y) for x, y in zip(got, want)),
             f"lex_max_deps ({label}) differs from its plain version")
        nbytes = b * t + 20 * t + 21 * b
        rows.append({
            "name": "lex_max_deps", "shape": f"{label}_T{t}_B{b}",
            "path": "graph", "B": b, "T": t, "K": 0,
            "nnz": int(deps.sum()), "packed": False, "max_abs_err": 0,
            "ms": device_ms(torch, lambda: K.lex_max_deps(ts, deps), 20,
                            flush),
            "warm_ms": device_ms(torch, lambda: K.lex_max_deps(ts, deps), 20),
            "method_floor_ms": method_floor_ms(ctx, 20),
            "wrapper_host_us": host_us(
                torch, lambda: K.lex_max_deps(ts, deps), 20),
            "plain_ms": eager_ms(
                torch, lambda: K.lex_max_deps_plain(ts, deps), 5, flush),
            "library_ms": None,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "ops": 0})
    return rows


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


def _graph_slots(ctx):
    """insert_batch and txn_step at T=4,096 with two valid rows aimed at
    slots (T, 1), (-1, 1), (-1, T-1) and (-T-1, 1): no device-side assert,
    and the card's state equals the CPU's (the CPU's equals the
    reference's, tests/test_torch_graph.py and test_torch_model.py)."""
    import numpy as np
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.models import conflict_graph as cg
    from cassandra_accord_tpu_torch.ops import graph_state as gs
    t, k = GRAPH["traj_T"], GRAPH["traj_K"]
    rng = np.random.default_rng(23)
    fields = _prefill(np, rng, t, k, t // 2)
    cases = {"T,1": (t, 1), "-1,1": (-1, 1), "-1,T-1": (-1, t - 1),
             "-T-1,1": (-t - 1, 1)}
    devs = (ctx["dev"], "cpu")
    for label, slots in cases.items():
        f = _batch_fields(np, rng, t, k, 2, 100000, slots, 2)
        ins = (f["slots"], f["key_inc"], f["txn_id"], f["txn_id"], f["kind"],
               np.full(2, gs.STABLE, np.int8), np.ones((2, t), np.int8))
        outs = []
        for d in devs:
            state = _state_on(torch, fields, d)
            inserted = gs.insert_batch(
                state, *(torch.from_numpy(a).to(d) for a in ins))
            got = gs.state_to_numpy(inserted)
            batch = cg.TxnBatch(**{n: torch.from_numpy(v).to(d)
                                   for n, v in f.items()})
            state, deps, done = cg.txn_step(state, batch)
            outs.append((got, gs.state_to_numpy(state), deps.cpu(),
                         done.cpu()))
        sync(ctx)
        (ins_a, st_a, deps_a, done_a), (ins_c, st_c, deps_c, done_c) = outs
        for name in ins_c:
            need(np.array_equal(ins_a[name], ins_c[name]),
                 f"slots {label}: insert_batch {name} differs card vs CPU")
            need(np.array_equal(st_a[name], st_c[name]),
                 f"slots {label}: txn_step {name} differs card vs CPU")
        need(torch.equal(deps_a, deps_c) and torch.equal(done_a, done_c),
             f"slots {label}: txn_step deps/applied differ card vs CPU")
    return {"T": t, "K": k, "cases": list(cases), "equal_to_cpu": True}


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
           "slots": _graph_slots(ctx), "ops": _graph_ops(ctx),
           "edges": _graph_edges(ctx)}
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
            k1_launches(x["launches"]) for x in times),
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

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    # the join a rank makes in the sharded step (its [T/n, K] rows, the
    # first batch), in the form join_form picks for it
    ctx["mesh_join"] = _join_call(
        torch, (on_card(fields["key_inc"][:rows]),
                on_card(fields["txn_id"][:rows]),
                on_card(fields["kind"][:rows]),
                on_card(fields["status"][:rows]),
                on_card(fields["active"][:rows]),
                on_card(batches[0]["key_inc"]), on_card(batches[0]["txn_id"]),
                on_card(batches[0]["kind"])))

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
    ctx["mesh_consult"] = _consult_calls(torch, s0)

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
    # the ranks' steps and store consults take the [T, K] kernels by the
    # rule; the dry run's consults of live stores take what it gives them
    need(launches["deps_join_dense_tk"] > 0
         and launches["max_conflict_dense_tk"] > 0,
         f"the mesh path did not launch the [T, K] kernels: {launches}")
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


# the replay phase: bench.py's replay stage (:1015-1046) on the port.  The
# 6-key recording is bench.py's record_burn (seed 7, concurrency 64, 3
# nodes, rf 3, one shard, durability, a 5 ms window) cut from 1,200 to 400
# ops.  The wide recording is the same burn over 1,000 keys: 15% of its
# ops are range reads of one or two ranges, each up to 500 keys wide
# (harness/burn.py:330, :781-791), BASELINE.md config 4's range
# transactions as protocol traffic.  Each replays through the four tiers
# bench.py names, auto being the shipped cost model, at bench.py's walk
# threshold (ACCORD_TPU_WALK_MAX=512, bench.py:39).  Every tier has a
# valve on the replay's clock (the checks' seconds are off it): when it
# closes the replay is a prefix, labelled truncated, with the events it
# reached and the live index it held.
REPLAY = dict(
    record=dict(seed=7, ops=400, concurrency=64, batch_window_us=5000,
                nodes=3, rf=3, num_shards=1, durability=True),
    # the wide recording's largest target is 32,768 (an 8 GiB index) cut to
    # 8,192 (0.5 GiB) for the script's time: beside an H100 80GB, at
    # 16,384 its device tier reached 74% of the stream in its 150-s valve
    # and its checks took 69 s more, and its host tier spent 67 s on 2
    # queries
    recordings=(("keys6", 6, (4096, 32768)), ("keys1000", 1000, (4096, 8192))),
    tiers=("walk", "host", "auto", "device"),
    index_bytes_max=8 << 30, walk_max="512", walk_sample_target=300,
    parity_sample=5, check_every=10,
    # the host tier's BLAS pass reads f32 mirrors of the [T, K] index;
    # bench.py keeps them at every size (ACCORD_TPU_F32_MAX = 2^20, :1018),
    # without them each host consult casts and transposes the index
    f32_max=str(1 << 20),
    # the host tier answers few queries at these sizes, so each is held
    # against the walk
    host_parity_sample=1,
    valves={"walk": 30.0, "host": 30.0, "auto": 60.0, "device": 150.0},
    # the wide recording's host tier gets a short valve; at the 6-key
    # T = 32,768, where the host tier builds two 4 GiB mirrors and answers
    # two queries in 65-76 s, it stops at its first query; and the wide
    # replays are cut to prefixes for the script's time (900 s): the
    # 6-key replays and their valves take about 330 s of it
    valve_cuts={"keys6_T32768": {"host": 1.0},
                "keys1000_T4096": {"host": 10.0, "auto": 15.0,
                                   "device": 15.0},
                "keys1000_T8192": {"host": 10.0, "auto": 20.0,
                                   "device": 50.0}},
    calibrations=5, budget_s=600.0)


class _ReplayClock:
    """consult_trace's clock with the recorder's inline checks taken off,
    so the replay's rates and valves count replay work only."""

    def __init__(self, chk):
        self.chk = chk

    def perf_counter(self):
        return time.perf_counter() - self.chk.check_s


class _ReadingClock:
    """A module's clock that keeps every reading it gives."""

    def __init__(self):
        self.reads = []

    def perf_counter(self):
        self.reads.append(time.perf_counter())
        return self.reads[-1]


@contextlib.contextmanager
def _replay_probe(chk, every):
    """While installed, every ``every``-th range query (rc, mcr) a device
    resolver answers is held against the cfk walk on the same store, as
    VerifyDepsResolver holds it (replay_stream's own oracle checks only the
    key queries), the checks' time going to ``chk.check_s``; and each fused
    consult's B·T·K is seen (the cost model's input)."""
    from cassandra_accord_tpu_torch.impl.resolver import CpuDepsResolver
    from cassandra_accord_tpu_torch.impl.tpu_resolver import TpuDepsResolver
    seen = {"range_calls": 0, "range_checked": 0, "consult_elems_max": 0}
    real = {n: getattr(TpuDepsResolver, n) for n in
            ("range_conflicts", "max_conflict_range", "_consult")}

    def checked(name, sort):
        def call(self, *args):
            got = real[name](self, *args)
            seen["range_calls"] += 1
            if seen["range_calls"] % every == 0:
                t0 = time.perf_counter()
                want = getattr(CpuDepsResolver(self.store), name)(*args)
                a, b = (sorted(got), sorted(want)) if sort else (got, want)
                need(a == b, f"replay {name} differs from the cfk walk")
                seen["range_checked"] += 1
                chk.check_s += time.perf_counter() - t0
            return got
        return call

    def consult(self, q, *args, **kwargs):
        seen["consult_elems_max"] = max(seen["consult_elems_max"],
                                        q.shape[0] * self._t * self._k)
        return real["_consult"](self, q, *args, **kwargs)
    TpuDepsResolver.range_conflicts = checked("range_conflicts", True)
    TpuDepsResolver.max_conflict_range = checked("max_conflict_range", False)
    TpuDepsResolver._consult = consult
    try:
        yield seen
    finally:
        for n, f in real.items():
            setattr(TpuDepsResolver, n, f)


def _width_histogram(rec):
    """Keys per query of the recorded unit, in power-of-two buckets: a key
    query's keys; a range query's registered keys inside its range (an
    upper bound of its width when it ran)."""
    keys = {k for ev in rec.unit_stream() if ev[0] == "reg" for k in ev[4]}
    hist, widest = {}, 0
    for ev in rec.unit_stream():
        if ev[0] in ("kc", "mc"):
            w = len(ev[2] if ev[0] == "kc" else ev[1])
        elif ev[0] in ("rc", "mcr"):
            rng = ev[2] if ev[0] == "rc" else ev[1]
            w = sum(1 for k in keys if rng.contains(k))
        else:
            continue
        bucket = 1 << max(0, w - 1).bit_length()
        hist[f"<={bucket}"] = hist.get(f"<={bucket}", 0) + 1
        widest = max(widest, w)
    return {"keys_per_query": dict(sorted(hist.items(),
                                          key=lambda kv: int(kv[0][2:]))),
            "widest": widest}


def _calibrations(ctx):
    """impl/tpu_resolver.py::_calibrate_threshold run afresh a few times
    (the cached value put back after), each run's round trip read off its
    clock: the threshold, round trip and host elements/s of each run (the
    threshold is their product)."""
    from cassandra_accord_tpu_torch.impl import tpu_resolver
    saved = dict(tpu_resolver._CALIBRATED)
    clock = _ReadingClock()
    runs = []
    tpu_resolver.time = clock
    try:
        for _ in range(REPLAY["calibrations"]):
            tpu_resolver._CALIBRATED.clear()
            clock.reads = []
            thr = tpu_resolver._calibrate_threshold(
                ctx["torch"].device(ctx["dev"]))
            rtt = clock.reads[1] - clock.reads[0]
            # the threshold is max(1e6, rate x round trip)
            runs.append({"threshold": thr, "round_trip_us": rtt * 1e6,
                         "host_elems_per_s": thr / rtt if thr > 1e6 else None})
    finally:
        tpu_resolver.time = time
        tpu_resolver._CALIBRATED.clear()
        tpu_resolver._CALIBRATED.update(saved)
    thr = sorted(r["threshold"] for r in runs)
    return {"runs": runs, "threshold_min": thr[0], "threshold_max": thr[-1]}


def _replay_tiers(ctx, rec, t_target, label):
    """scaled_replay of ``rec`` at ``t_target`` through every tier, each
    tier's replay_stream run between a launch-count reset and read, with a
    KernelRecorder checking every tenth call inline and the range probe;
    one line per tier as it ends."""
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.harness import consult_trace as ct
    from cassandra_accord_tpu_torch.ops import _kernels as K
    real = ct.replay_stream
    per = {}

    def instrumented(events, tier, *args, **kwargs):
        chk = KernelRecorder(torch, K, every=REPLAY["check_every"])
        ct.time = _ReplayClock(chk)
        env, every = {}, REPLAY["parity_sample"]
        if tier == "host":
            env = {"ACCORD_TPU_F32_MAX": REPLAY["f32_max"]}
            every = kwargs["parity_sample"] = REPLAY["host_parity_sample"]
        w0 = time.perf_counter()
        try:
            with chk, _replay_probe(chk, every) as seen, _environ(**env):
                K.reset_launches()                   # just before the tier
                r = real(events, tier, *args, **kwargs)
                sync(ctx)
                launches = dict(K.LAUNCHES)          # just after it
        finally:
            ct.time = time
        per[tier] = dict(launches=launches, checked_calls=chk.checked,
                         check_s=chk.check_s, probe=seen,
                         wall_s=time.perf_counter() - w0,
                         largest=chk.largest)
        emit({"phase": "replay", "label": label, "tier": tier,
              "wall_s": per[tier]["wall_s"], "queries": r.get("queries"),
              "truncated_at_event": r.get("truncated_at_event"),
              "events_total": len(events),
              "final_indexed": r.get("final_indexed"),
              "launches": launches})
        return r
    ct.replay_stream = instrumented
    try:
        out = ct.scaled_replay(
            rec, t_target, list(REPLAY["tiers"]),
            parity_sample=REPLAY["parity_sample"],
            walk_sample_target=REPLAY["walk_sample_target"],
            tier_max_seconds=dict(REPLAY["valves"],
                                  **REPLAY["valve_cuts"].get(label, {})))
    finally:
        ct.replay_stream = real
    tiers = {}
    for tier, r in out["tiers"].items():
        p = per[tier]
        tiers[tier] = {
            "queries": r.get("queries"),
            "sampled_queries": r.get("sampled_queries"),
            **{c: r.get(c, 0) for c in ("walk_consults", "host_consults",
                                        "device_consults", "native_consults")},
            "queries_per_s": r.get("queries_per_sec"),
            "commits_equiv_per_s": r.get("commits_equiv_per_sec"),
            "parity_checked": r.get("parity_checked", 0),
            "range_checked": p["probe"]["range_checked"],
            "truncated_at_event": r.get("truncated_at_event"),
            "events_reached": r.get("truncated_at_event",
                                    out["merged_events"]),
            "events_total": out["merged_events"],
            "final_indexed": r.get("final_indexed"),
            "service_batches": r.get("service", {}).get("batches"),
            "consult_elems_max": p["probe"]["consult_elems_max"],
            "launches": p["launches"], "checked_calls": p["checked_calls"],
            "check_s": p["check_s"], "wall_s": p["wall_s"]}
    largest = {}
    for p in per.values():
        for name, call in p["largest"].items():
            if call[0] >= largest.get(name, (-1,))[0]:
                largest[name] = call
    head = {k: out[k] for k in ("copies", "txn_capacity", "key_capacity",
                                "merged_events", "commits_replayed")}
    head["index_bytes"] = 2 * out["txn_capacity"] * out["key_capacity"]
    return dict(head, t_target=t_target, label=label, tiers=tiers), largest


def phase_replay(ctx):
    import gc
    from cassandra_accord_tpu_torch.harness.consult_trace import record_burn
    from cassandra_accord_tpu_torch.impl import tpu_resolver
    t0 = time.perf_counter()
    out, launches, largest = {}, {}, {}
    with _environ(ACCORD_DEVICE=ctx["dev"],
                  ACCORD_TPU_WALK_MAX=REPLAY["walk_max"]):
        for name, key_count, targets in REPLAY["recordings"]:
            w0 = time.perf_counter()
            rec = record_burn(key_count=key_count, **REPLAY["record"])
            rec_out = {"record_s": time.perf_counter() - w0,
                       "unit_events": len(rec.unit_stream()),
                       "unit_peak_live": rec.unit_peak_live(),
                       "widths": _width_histogram(rec)}
            if key_count > 6:
                rec_out["calibrations"] = _calibrations(ctx)
            emit({"phase": "replay", "recording": name, **rec_out})
            for t_target in targets:
                label = f"{name}_T{t_target}"
                r, big = _replay_tiers(ctx, rec, t_target, label)
                need(r["index_bytes"] <= REPLAY["index_bytes_max"],
                     f"{label}: index over the bound")
                tiers = r["tiers"]
                for tier in set(tiers) - {"walk"}:
                    checks = tiers[tier]["parity_checked"] + \
                        tiers[tier]["range_checked"]
                    need(checks > 0, f"{label}: {tier} checked no answer "
                         f"against the walk")
                    if k1_launches(tiers[tier]["launches"]) > 0:
                        need(tiers[tier]["checked_calls"] > 0,
                             f"{label}: {tier} checked no kernel call")
                    if key_count == 6:
                        need(tiers[tier]["parity_checked"] > 0,
                             f"{label}: {tier} parity_checked 0")
                need(tiers["device"]["device_consults"] > 0 and
                     tiers["device"]["launches"][FUSED] > 0,
                     f"{label}: the device tier made no device consult")
                r["calibrated"] = dict(tpu_resolver._CALIBRATED)
                if key_count > 6:
                    # the cost model sends a consult to the card when its
                    # B*T*K reaches the threshold it calibrated; at T=4,096
                    # a one-row consult (8,192 x 8,192 = 6.7e7 elements)
                    # sits at an H100 80GB's threshold (6.4e7 to 1.1e8
                    # across processes), so there the routing may keep
                    # every wide query on the host, and then only because
                    # each consult was below the threshold; at the largest
                    # T it must not
                    auto = tiers["auto"]
                    below = auto["consult_elems_max"] < min(
                        r["calibrated"].values(), default=0.0)
                    need(auto["device_consults"] > 0 or
                         (below and t_target < targets[-1]),
                         f"{label}: the cost model sent no wide query to the "
                         f"card (threshold {r['calibrated']}, widest B*T*K "
                         f"{auto['consult_elems_max']})")
                emit({"phase": "replay", **r})
                out[label] = r
                for tier, x in tiers.items():
                    for kname, n in x["launches"].items():
                        launches.setdefault(kname, {})[f"{label}_{tier}"] = n
                path = "replay" if key_count == 6 else "replay_wide"
                for kname, call in big.items():
                    if call[0] >= largest.get(path, {}).get(kname, (-1,))[0]:
                        largest.setdefault(path, {})[kname] = call
                del big
                gc.collect()
            del rec
    ctx["replay_launches"] = launches
    ctx["replay_largest"] = largest
    seconds = time.perf_counter() - t0
    need(seconds <= REPLAY["budget_s"],
         f"replay phase took {seconds:.1f} s > {REPLAY['budget_s']} s")
    return {"replays": {k: {"t_target": v["t_target"],
                            "txn_capacity": v["txn_capacity"],
                            "key_capacity": v["key_capacity"],
                            "tiers": {t: {c: x[c] for c in (
                                "walk_consults", "host_consults",
                                "device_consults", "events_reached",
                                "events_total", "final_indexed")}
                                for t, x in v["tiers"].items()}}
                        for k, v in out.items()},
            "calibrated": dict(tpu_resolver._CALIBRATED),
            "launches": launches, "nvidia_smi": ctx.get("smi_line")}


# the bench phase: bench_torch.py's smoke as a user runs it, then the
# stages that launch the card's kernels at the smallest sizes bench.py gives
# them (bench.py :1091, :1077, :1011 with ts=(1024,), :378 with one iter)
BENCH = dict(smoke_timeout_s=150, check_every=10, budget_s=120.0,
             calls=(("bench_kernel", (4096,), {}),
                    ("bench_service", (8192,), {}),
                    ("bench_deps_graph", (), {"ts": (1024,)}),
                    ("bench_graph", (), {"t": 8192, "iters": 1})))


def phase_bench(ctx):
    torch = ctx["torch"]
    from cassandra_accord_tpu_torch.ops import _kernels as K
    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    env = dict(os.environ, ACCORD_BENCH_DEADLINE_S="150",
               ACCORD_BENCH_HISTORY=os.path.join(OUT_DIR,
                                                 "bench_smoke_history.jsonl"))
    env.pop("ACCORD_DEVICE", None)          # the card, as a user runs it
    proc = subprocess.run([sys.executable, os.path.join(HERE, "bench_torch.py"),
                           "--smoke"], capture_output=True, text=True,
                          timeout=BENCH["smoke_timeout_s"], env=env, cwd=HERE)
    smoke_s = time.perf_counter() - t0
    lines = [x for x in proc.stdout.splitlines() if x.strip()]
    need(proc.returncode == 0 and lines,
         f"bench_torch.py --smoke exited {proc.returncode}:\n"
         f"{proc.stdout[-1500:]}\n{proc.stderr[-1500:]}")
    tail = json.loads(lines[-1])
    need(isinstance(tail, dict) and len(lines[-1]) < 4096,
         "bench_torch.py --smoke: the last line is not one compact object")
    need(tail.get("stages") == {"smoke": "ok"} and tail["incomplete"] is False
         and tail["metric"] == "smoke_commit_latency_mean_us"
         and tail["value"] > 0, f"bench_torch.py --smoke tail: {tail}")
    name = torch.cuda.get_device_name(0)
    need((tail.get("device") or {}).get("name") == name,
         f"bench_torch.py --smoke tail names {tail.get('device')}, not {name}")
    import bench_torch
    out, walls = {}, {}
    K.reset_launches()                       # just before the stages
    with KernelRecorder(torch, K, every=BENCH["check_every"]) as chk:
        for fn, args, kwargs in BENCH["calls"]:
            w0 = time.perf_counter()
            out[fn] = getattr(bench_torch, fn)(*args, **kwargs)
            walls[fn] = time.perf_counter() - w0
        sync(ctx)
        launches = dict(K.LAUNCHES)          # just after them
    need(launches[FUSED] > 0, f"bench launched {launches}")
    need(chk.k1_calls() == k1_launches(launches),
         "bench: uncounted launch")
    need(chk.checked > 0, "bench: no kernel call checked")
    ctx["bench_launches"] = launches
    _keep_largest(ctx, "bench", chk)
    seconds = time.perf_counter() - t0
    need(seconds <= BENCH["budget_s"],
         f"bench phase took {seconds:.1f} s > {BENCH['budget_s']} s")
    return {"smoke": {"wall_s": smoke_s, "tail": tail},
            "stages": out, "wall_s": walls, "launches": launches,
            "checked_calls": chk.checked, "check_s": chk.check_s,
            "nvidia_smi": ctx.get("smi_line")}


ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "warm_ms", "method_floor_ms", "wrapper_host_us", "shape", "path", "B",
            "T", "K", "nnz", "packed")
# K12's rows also carry K1 + K2 timed in turns with it in the same call
FUSED_KEYS = ("k12_ms_turns", "k1_k2_ms", "k1_k2_host_us")


def kernels_line(ctx):
    """One entry per kernel and form (K1, K2 in the CSR form; K1d, K2d in
    the dense form on [K, T] and on [T, K]; K12, both halves in one launch,
    the service's window; the step's ``write_rows``, ``frontier`` and
    ``lex_max_deps``, at the graph phase's shapes with its launch counts):
    the main path's (the burn's;
    for the [T, K] kernels the one-shot consult of config 4's batch)
    launch count and the numbers at the largest call it made (the dense
    kernels: at config 4, their own path: the service's or the one-shot
    consult of config 4's batch, which join_form sends to them), and the
    other paths' launch counts: graph,
    mesh (summed over its ranks), cli and maelstrom (summed over their runs
    on the card's backend), the Maelstrom binary's (as its process reported
    them), verify, bench, the replays' per recording, target and tier, and
    the kernels phase's service and one-shot consults of each case
    (``config4_launches``: config 4's service consult); every other measured shape (the full-size synthetic ones in both
    forms, the paths' largest calls in both forms) under ``shapes``, each
    with ``main_path_launches``: the burn's count of its kernel for the
    burn's call, else 0."""
    largest = dict(ctx.get("replay_largest", {}))
    if ctx.get("burn_checker") is not None:
        largest["burn"] = ctx["burn_checker"].largest
    calls = []
    for path in ("burn", "replay", "replay_wide"):
        for name, (_size, args, kwargs) in sorted(largest.get(path,
                                                              {}).items()):
            calls.append((name, f"{path}_largest", args, kwargs, path))
    ctx.pop("replay_largest", None)
    for name, (_size, args, kwargs) in sorted(ctx.get("cli_largest",
                                                      {}).items()):
        calls.append((name, "cli_largest", args, kwargs, "cli"))
    for path in ("maelstrom", "verify", "bench"):
        for name, (_size, args, kwargs) in sorted(
                ctx.get("largest", {}).get(path, {}).items()):
            calls.append((name, f"{path}_largest", args, kwargs, path))
    if ctx.get("graph_join") is not None:
        name, args, kwargs = ctx["graph_join"]
        calls.append((name, "graph_step_T{T}_K{K}_B{B}".format(**GRAPH),
                      args, kwargs, "graph"))
    if ctx.get("mesh_join") is not None:
        # a rank's join in the sharded step (rank 0, first batch), and
        # store 0's consult in the store-sharded consult
        label = "mesh_step_rank_T{}_K{K}_B{B}".format(
            MESH["T"] // MESH["ranks"], **MESH)
        for name, args, kwargs in ctx["mesh_join"]:
            calls.append((name, label, args, kwargs, "mesh"))
        label = "mesh_store_T{T}_K{K}_B{B}".format(**MESH)
        for name, args, kwargs in ctx["mesh_consult"]:
            calls.append((name, label, args, kwargs, "mesh"))
    # each path's largest call: a [K, T] K1 or K2 one in both forms (the
    # one join_form picks, which launched on the path, and the other), a
    # [T, K] one on its kernel, a K12 one (with K1 + K2 in turns)
    for name, label, args, kwargs, path in calls:
        for form in (("auto",) if name.endswith("_tk") or name == FUSED
                     else FORMS):
            if form != "dense" or args[0].shape[1] % 16 == 0:
                measure(ctx, name, label, args, kwargs, 20, path, form=form)
    burn = ctx.get("burn_launches", {})
    entries = []
    for name in REPLACES:
        rows = [r for r in ctx["rows"] if r["name"] == name]
        if not rows:
            continue
        # the headline: the burn's largest call for the CSR kernels (the
        # main path), config 4 for the dense ones (the burn never takes them)
        if name in CSR_KERNELS + (FUSED,):
            head = next((r for r in rows if r["path"] == "burn"), rows[0])
        else:
            head = next((r for r in rows if r["shape"] == CONFIG4), rows[0])
        # the [T, K] kernels' own path: the one-shot consult of config 4's
        # batch (launches zeroed before it, read after); the others': the burn
        # the step's kernels': the graph phase's counted steps
        oneshot = ctx.get("oneshot_launches", {})
        own, own_path = burn, "burn"
        if name in TK_KERNELS:
            own, own_path = oneshot.get(CONFIG4, {}), \
                "one-shot consult, config 4"
        elif name in STEP_KERNELS:
            own, own_path = ctx.get("graph_launches", {}), "graph step"
        e = {"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": REPLACES[name],
             **({"also_replaces": ALSO_REPLACES[name]}
                if name in ALSO_REPLACES else {}),
             "launches": own.get(name, 0), "launches_path": own_path,
             "replay_launches": ctx.get("replay_launches", {}).get(name, {}),
             "graph_launches": ctx.get("graph_launches", {}).get(name, 0),
             "mesh_launches": ctx.get("mesh_launches", {}).get(name, 0),
             "cli_launches": ctx.get("cli_launches", {}).get(name, 0),
             "maelstrom_launches":
                 ctx.get("maelstrom_launches", {}).get(name, 0),
             "maelstrom_stdio_launches":
                 ctx.get("maelstrom_stdio_launches", {}).get(name, 0),
             "verify_launches": ctx.get("verify_launches", {}).get(name, 0),
             "bench_launches": ctx.get("bench_launches", {}).get(name, 0),
             "config4_launches":
                 ctx.get("auto_launches", {}).get(CONFIG4, {}).get(name, 0),
             "kernels_auto_launches":
                 {case: v.get(name, 0)
                  for case, v in ctx.get("auto_launches", {}).items()},
             "kernels_oneshot_launches":
                 {case: v.get(name, 0) for case, v in oneshot.items()}}
        keys = ROW_KEYS + (FUSED_KEYS if name == FUSED else ())
        e.update({k: head[k] for k in keys})
        e["shapes"] = [dict({k: r[k] for k in keys},
                            main_path_launches=burn.get(name, 0)
                            if r["path"] == "burn" else 0)
                       for r in rows if r is not head]
        entries.append(e)
    return {"kernels": entries}


def new_ctx(torch, kmod, dev="cuda"):
    """The phases' shared state; ``real``: the kernel wrappers as the port
    defines them (the recorders wrap the module's attributes)."""
    return {"torch": torch, "rows": [], "dev": dev, "floors": {},
            "real": {n: getattr(kmod, n) for n in WRAPPERS}}


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
    ctx = new_ctx(torch, _kernels)
    fns = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
           "service": phase_service, "burn": phase_burn, "cli": phase_cli,
           "maelstrom": phase_maelstrom, "verify": phase_verify,
           "graph": phase_graph, "mesh": phase_mesh, "replay": phase_replay,
           "bench": phase_bench}
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
