"""Measurements behind the design of csrc/dense_join_tk.cu, on one card.

    python3 tools_torch/tk_probes.py            # every probe
    python3 tools_torch/tk_probes.py stages     # one of stages, flush, bench_loop

One JSON line per probe and shape, then the card's name and power limit:

- ``stages``: K1d/K2d on [T, K] as built, and two variants compiled from the
  same source beside it (128 slots a stage instead of 256; the products
  removed, so that the stream and the epilogue run alone), each checked
  against the plain versions (the variant without products is expected to
  differ) and timed in turns (cold L2, ``chip_smoke.device_ms``) at config
  4, the wide row and shape A.
- ``flush``: the kernels and a plain read of the index (``torch.amax``)
  after an L2 flush by a 128 MB write (``chip_smoke``'s method), after a
  flush by a 128 MB read, and warm.
- ``bench_loop``: ``bench_torch.bench_kernel``'s timed loop at shape A (T =
  65,536), unpacked and packed, each twice: host enqueue and event ms a
  call.

Variant libraries are built into ``build/tk_probes/`` (ignored by git).
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cassandra_accord_tpu_torch.ops import _kernels as K  # noqa: E402

SRC = K.CSRC / "dense_join_tk.cu"
OUT = ROOT / "build" / "tk_probes"
MSUB = "  static constexpr int kMsub = N <= 128 ? 2 : 1;"
PRODUCT = "wgmma_s8<Sh::kNw>("
# name: (source substitutions); "built" is the library the port loads
VARIANTS = {"built": (),
            "slots128": ((MSUB, "  static constexpr int kMsub = 1;"),),
            "no_products": ((PRODUCT, "(void)("),)}
# (T, K, B, index density, query density)
SHAPES = {"config4": (65536, 2048, 64, 0.5, 0.5),
          "wide_row": (65536, 512, 9, 0.004, 0.5),
          "shape_A": (65536, 512, 256, 0.004, 0.004)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_variants():
    """{name: ctypes library}: each variant's source compiled with the
    port's flags, all nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    base = SRC.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        if name == "built":
            continue
        src = base
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} not in {SRC.name}")
            src = src.replace(old, new)
        path = OUT / f"{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-I", str(K.CSRC), "-shared", "-o",
             str(OUT / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {"built": K.lib()}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{err}")
        so = ctypes.CDLL(str(OUT / f"{name}.so"))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        so.deps_join_tk_launch.argtypes = [vp] * 8 + [ctypes.c_ulonglong] + \
            [i32] * 6 + [vp] * 2
        so.deps_join_tk_launch.restype = i32
        so.max_conflict_tk_launch.argtypes = [vp] * 5 + [i32] * 3 + [vp] * 3
        so.max_conflict_tk_launch.restype = i32
        so.max_conflict_tk_scratch_ints.argtypes = [i32, i32]
        so.max_conflict_tk_scratch_ints.restype = ctypes.c_longlong
        libs[name] = so
    return libs


def inputs(t, k, b, density, qdensity, seed):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lanes = rng.integers(0, 50, (t, 5)).astype(np.int32)
    g = dict(inc=up((rng.random((t, k)) < density).astype(np.int8)),
             q=up((rng.random((b, k)) < qdensity).astype(np.int8)),
             txn_id=up(lanes),
             ts=up(lanes + rng.integers(0, 3, (t, 5)).astype(np.int32)),
             kind=up(rng.integers(0, 6, t).astype(np.int8)),
             status=up(rng.integers(0, 7, t).astype(np.int8)),
             active=up(rng.random(t) < 0.9),
             before=up(rng.integers(0, 50, (b, 5)).astype(np.int32)),
             qkind=up(rng.integers(0, 6, b).astype(np.int8)))
    jargs = (g["inc"], g["txn_id"], g["kind"], g["status"], g["active"],
             g["q"], g["before"], g["qkind"])
    margs = (g["inc"], g["ts"], g["txn_id"], g["active"], g["q"])
    return g, jargs, margs


def probe_stages(flush):
    libs = build_variants()
    for label, (t, k, b, d, qd) in SHAPES.items():
        _g, jargs, margs = inputs(t, k, b, d, qd, seed=t + b)
        want = (K.deps_join_tk_plain(*jargs), K.max_conflict_tk_plain(*margs))
        row = {"probe": "stages", "shape": label, "T": t, "K": k, "B": b}
        for name in list(libs) + list(libs)[::-1]:       # in turns
            K._LIB = libs[name]
            got = (K.deps_join_tk(*jargs), K.max_conflict_tk(*margs))
            torch.cuda.synchronize()
            r = row.setdefault(name, {"equal": [], "k1_ms": [], "k2_ms": []})
            r["equal"].append(all(torch.equal(a, w) for a, w in zip(got, want)))
            r["k1_ms"].append(cs.device_ms(
                torch, lambda: K.deps_join_tk(*jargs), 10, flush))
            r["k2_ms"].append(cs.device_ms(
                torch, lambda: K.max_conflict_tk(*margs), 10, flush))
        K._LIB = libs["built"]
        emit(row)


class ReadFlush:
    """In place of chip_smoke's flush buffer: its ``zero_`` reads 128 MB
    instead of writing it, so L2 is left holding clean lines."""

    def __init__(self, buf):
        self.words = buf.view(torch.int64)
        self.sink = torch.empty((), dtype=torch.int64, device=buf.device)

    def zero_(self):
        torch.amax(self.words, dim=0, out=self.sink)


def probe_flush(flush):
    for label, (t, k, b, d, qd) in SHAPES.items():
        g, jargs, margs = inputs(t, k, b, d, qd, seed=t + b)
        words = g["inc"].view(torch.int64).view(-1)
        row = {"probe": "flush", "shape": label, "index_bytes": t * k}
        for mode, fl in (("write", flush), ("read", ReadFlush(flush)),
                         ("warm", None)):
            row[mode] = {
                "read_index_ms": cs.device_ms(
                    torch, lambda: torch.amax(words, dim=0), 10, fl),
                "k1_ms": cs.device_ms(
                    torch, lambda: K.deps_join_tk(*jargs), 10, fl),
                "k2_ms": cs.device_ms(
                    torch, lambda: K.max_conflict_tk(*margs), 10, fl)}
        emit(row)


def probe_bench_loop():
    import bench_torch as bt
    from cassandra_accord_tpu_torch.ops import deps_kernels as dk
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    t, k, b = 65536, 512, 256
    key_inc, lanes, kind, status, active = bt._make_index(rng, t, k,
                                                          keys_per_txn=2)

    def up(a):
        return torch.from_numpy(a).to(dev)
    index = [up(x) for x in (key_inc, key_inc, lanes, lanes, kind, status,
                             active)]
    batches = [tuple(up(x) for x in bt._make_queries(rng, b, k, t))
               for _ in range(20)]
    row = {"probe": "bench_loop", "T": t, "K": k, "B": b, "calls": 20}
    for name, fn in (("consult", dk.consult),
                     ("consult_packed", dk.consult_packed)) * 2:
        fn(*index, *batches[0])                          # warm-up, as the bench
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        e0.record()
        outs = [fn(*index, *bb) for bb in batches]
        e1.record()
        host_ms = (time.perf_counter() - h0) * 1e3 / 20
        e1.synchronize()
        row.setdefault(name, []).append(
            {"host_enqueue_ms": host_ms, "event_ms": e0.elapsed_time(e1) / 20})
        del outs
    emit(row)


def main(argv=None) -> int:
    which = (argv if argv is not None else sys.argv[1:]) or \
        ["stages", "flush", "bench_loop"]
    if not torch.cuda.is_available():
        print("tk_probes: needs a CUDA card", file=sys.stderr)
        return 2
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for name in which:
        if name == "stages":
            probe_stages(flush)
        elif name == "flush":
            probe_flush(flush)
        elif name == "bench_loop":
            probe_bench_loop()
        else:
            print(f"tk_probes: unknown probe {name!r}", file=sys.stderr)
            return 2
    smi = shutil.which("nvidia-smi")
    if smi:
        print(subprocess.run([smi, "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
