"""K1d/K2d on the [K, T] index: this checkout's kernel against an earlier
checkout's, or against variants of itself, in turns on one card.

    python3 tools_torch/kt_compare.py build/parent
    python3 tools_torch/kt_compare.py --variants

``build/parent`` holds the earlier checkout (``git archive <commit>``
unpacked there); its ``csrc/dense_join.cu`` is compiled beside this one
into ``build/kt_compare/`` (ignored by git) with the port's flags, and the
dense wrappers (``_kernels.deps_join_dense`` / ``max_conflict_dense``,
whose C entry points both checkouts share) run on either
library by swapping ``_kernels._LIB``.  At each shape of PERF.md's [K, T]
table both libraries' answers are held against the plain versions, then
K1d and K2d are timed cold-L2 in CUDA graphs (``chip_smoke.device_ms``) in
turns: parent, tree, tree, parent.  One JSON line per shape, then the
card's name and power limit.

``--variants`` builds this checkout's ``dense_join.cu`` twice more with a
part removed: the products (``no_products``: the accumulators stay zero,
so the stream and the epilogue run alone) and the predicate pass of the
epilogue (``no_epilogue``: the stream and the products alone, no output
written), and times them beside the kernel as built, in turns, at config
4, the wide row and shape A.  The variants' answers are expected to
differ; only the built kernel's is held against the plain versions.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cassandra_accord_tpu_torch.ops import _kernels as K  # noqa: E402

OUT = ROOT / "build" / "kt_compare"
SRC = K.CSRC / "dense_join.cu"
# name: the source substitutions of the variant
VARIANTS = {"no_products": (("wgmma_ru8<Sh::kNw>(", "(void)("),),
            "no_epilogue": (("    for (; done < upto; ++done) {",
                             "    for (done = upto; done < upto; ++done) {"),)}
# (label, B, T, K, keys per query row, one wide row's columns, index density)
SHAPES = (("config4", 64, 65536, 2048, 1024, 0, 0.5),
          ("wide_row", 9, 65536, 512, 2, 5000, 0.004),
          ("shape_A", 256, 65536, 512, 2, 0, 0.004),
          ("mesh_rank", 256, 16384, 512, 2, 0, 0.004),
          ("six_key_replay_largest", 256, 32768, 1024, 2, 0, 0.002),
          ("wide_replay_largest", 256, 8192, 8192, 2, 0, 0.0003),
          ("bench_phase_largest", 256, 4096, 512, 2, 0, 0.004),
          ("burn_largest", 8, 256, 16, 2, 0, 0.125))
ITERS = 10


def dense_library(source: Path, include: Path, name: str) -> ctypes.CDLL:
    """A dense_join.cu as a library of its own, with the dense entry
    points' argument types."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{name}.so"
    cmd = [K._nvcc(), *K.NVCC_FLAGS, "-I", str(include), "-shared", "-o",
           str(so), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    here = K.lib()
    for name in ("deps_join_dense_launch", "max_conflict_dense_launch",
                 "deps_join_dense_scratch_ints",
                 "max_conflict_dense_scratch_ints"):
        getattr(lib, name).argtypes = getattr(here, name).argtypes
        getattr(lib, name).restype = getattr(here, name).restype
    return lib


def inputs(b, t, k, per_row, wide, density, seed):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    inc = (rng.random((k, t)) < density).astype(np.uint8)
    rows = [sorted(int(c) for c in rng.choice(k, min(per_row, k),
                                              replace=False))
            for _ in range(b)]
    if wide:
        rows[0] = sorted(int(c) for c in rng.integers(0, k, wide))
    offsets, cols = cs.to_csr(np, rows)
    lanes = rng.integers(0, 50, (t, 5)).astype(np.int32)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    g = dict(inc=up(inc), txn_id=up(lanes),
             ts=up(lanes + rng.integers(0, 3, (t, 5)).astype(np.int32)),
             kind=up(rng.integers(0, 6, t).astype(np.int8)),
             status=up(rng.integers(0, 7, t).astype(np.int8)),
             active=up(rng.random(t) < 0.9), offsets=up(offsets),
             cols=up(cols),
             before=up(rng.integers(0, 50, (b, 5)).astype(np.int32)),
             qkind=up(rng.integers(0, 6, b).astype(np.int8)))
    jargs = (g["inc"], g["txn_id"], g["kind"], g["status"], g["active"],
             g["offsets"], g["cols"], g["before"], g["qkind"])
    margs = (g["inc"], g["ts"], g["txn_id"], g["active"], g["offsets"],
             g["cols"])
    return jargs, margs


def variant_libraries():
    """{name: library}: the kernel as built and each of ``VARIANTS``."""
    libs = {"tree": K.lib()}
    base = SRC.read_text()
    for name, subs in VARIANTS.items():
        src = base
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} not in {SRC.name}")
            src = src.replace(old, new)
        path = OUT / f"{name}.cu"
        OUT.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        libs[name] = dense_library(path, K.CSRC, name)
    return libs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kt_compare: needs a CUDA device", file=sys.stderr)
        return 2
    if len(argv) > 1 and argv[1] == "--variants":
        libs = variant_libraries()
        turns = ("tree", *VARIANTS, *reversed(VARIANTS), "tree")
        shapes = [s for s in SHAPES if s[0] in ("config4", "wide_row",
                                                 "shape_A")]
    else:
        parent = Path(argv[1] if len(argv) > 1 else ROOT / "build" / "parent")
        src = parent / "cassandra_accord_tpu_torch" / "csrc"
        libs = {"tree": K.lib(),
                "parent": dense_library(src / "dense_join.cu", src, "parent")}
        turns = ("parent", "tree", "tree", "parent")
        shapes = list(SHAPES)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for i, (label, b, t, k, per_row, wide, dens) in enumerate(shapes):
        jargs, margs = inputs(b, t, k, per_row, wide, dens, seed=i)
        want = (K.deps_join_plain(*jargs), K.max_conflict_plain(*margs))
        row = {"shape": label, "B": b, "T": t, "K": k,
               "n_cols": int(jargs[6].numel()),
               "bound_ms": [
                   cs.join_bound(torch, "deps_join", jargs[0], jargs[5],
                                 jargs[6])[0],
                   cs.join_bound(torch, "max_conflict", margs[0], margs[4],
                                 margs[5])[0]]}
        for name in turns:
            K._LIB = libs[name]
            got = (K.deps_join_dense(*jargs), K.max_conflict_dense(*margs))
            torch.cuda.synchronize()
            r = row.setdefault(name, {"equal": [], "k1_ms": [], "k2_ms": []})
            r["equal"].append(all(torch.equal(a, w)
                                  for a, w in zip(got, want)))
            r["k1_ms"].append(cs.device_ms(
                torch, lambda: K.deps_join_dense(*jargs), ITERS, flush))
            r["k2_ms"].append(cs.device_ms(
                torch, lambda: K.max_conflict_dense(*margs), ITERS, flush))
        K._LIB = libs["tree"]
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
