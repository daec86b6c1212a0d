"""K12 (``_kernels.fused_consult``, the service's window in one launch)
against K1 + K2, and against variants of its own layout, in turns on one
card.

    python3 tools_torch/k12_compare.py
    python3 tools_torch/k12_compare.py --variants

At each shape of ``SHAPES`` (the paths' window shapes of PERF.md's kernel
table) K12's answers are held against its plain version and against K1 +
K2 (the CSR form), then K12 and K1 + K2 are timed cold-L2 in CUDA graphs
(``chip_smoke.device_ms``) in turns: K12, K1 + K2, K1 + K2, K12, with the
wrappers' host µs a call.  One JSON line per shape, then the card's name
and power limit.

``--variants`` builds this checkout's ``csrc/`` three more times into
``build/k12_compare/`` (ignored by git), each with K12's layout changed by
a source substitution, prints each build's registers and spills of the K12
kernels, holds each variant's answers against the plain version, and times
the variants' K12 beside the built one's (swapping ``_kernels._LIB``), in
turns:

- ``one_thread``: every row-group size on the one-thread kernel (each
  thread both halves; at R = 8 under 128 registers);
- ``one_thread_1_block``: the same with one block an SM (up to 255
  registers);
- ``halves_everywhere``: one row a group in two halves too.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cassandra_accord_tpu_torch.ops import _kernels as K  # noqa: E402

OUT = ROOT / "build" / "k12_compare"
ONE_THREAD = (("  if constexpr (R == kRowsSmall) {", "  if constexpr (true) {"),
              ("  const bool halves = fused && rows == kRows;",
               "  const bool halves = false;"))
VARIANTS = {
    "one_thread": ONE_THREAD,
    "one_thread_1_block": ONE_THREAD + (
        ("__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSM)\n"
         "fused_consult_kernel(",
         "__global__ void __launch_bounds__(kMaxThreads, 1)\n"
         "fused_consult_kernel("),),
    "halves_everywhere": (
        ("  if constexpr (R == kRowsSmall) {", "  if constexpr (false) {"),
        ("  const bool halves = fused && rows == kRows;",
         "  const bool halves = fused;")),
}
# (label, B, T, K, keys per query row, index keys per txn)
SHAPES = (("burn_largest", 8, 256, 16, 2, 2),
          ("cli_maelstrom_largest", 8, 128, 16, 1, 1),
          ("odd_T", 13, 1003, 64, 2, 2),
          ("two_tiles", 13, 2049, 64, 2, 2),
          ("bench_phase_largest", 256, 4096, 512, 2, 2),
          ("wide_replay_largest", 256, 4096, 8192, 2, 2),
          ("service_phase", 64, 65536, 512, 2, 2),
          ("shape_A", 256, 65536, 512, 2, 2),
          ("replay_largest", 256, 65536, 1024, 8, 2),
          ("wide_row_600", 9, 65536, 512, 600, 2))
ITERS = 20


def case(label, b, t, k, per_row, per_txn, dev):
    """K12's arguments at one shape (chip_smoke's synthetic index and
    queries; rows of more than 2 keys drawn uniformly)."""
    rng = np.random.default_rng(t + b + k)
    key_inc, live, lanes, ts, kind, status, active = cs.make_index(
        np, rng, t, k, per_txn)
    rows, before, qkind = cs.make_queries(np, rng, b, k, t, min(per_row, 2))
    if per_row > 2:
        rows = [sorted(int(c) for c in rng.choice(k, per_row,
                                                  replace=per_row > k))
                for _ in range(b)]
    offsets, cols = cs.to_csr(np, rows)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (up((live != 0).T.astype(np.uint8)),
            up((key_inc != 0).T.astype(np.uint8)), up(ts), up(lanes),
            up(kind), up(status), up(active), up(offsets), up(cols),
            up(before), up(qkind))


def halves(args):
    live, key, ts, lanes, kind, status, active, offsets, cols, before, \
        qkind = args
    return (K.deps_join(live, lanes, kind, status, active, offsets, cols,
                        before, qkind),
            K.max_conflict(key, ts, lanes, active, offsets, cols))


def ptxas_fused(text):
    """(kernel instantiation, registers, spill stores) of the K12 kernels
    in a build's ptxas report."""
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\S*?(fused_\w+?_kernel"
                      r"IL\w+?EL\w+?E)", line)
        if m:
            name, spill = m.group(1), 0
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((name, regs, spill))
            name = None
    return out


def variant_library(name, subs):
    """This checkout's csrc/ with ``subs`` applied, built into its own
    library under OUT; (library, ptxas report)."""
    src = OUT / name / "csrc"
    shutil.rmtree(src.parent, ignore_errors=True)
    shutil.copytree(K.CSRC, src)
    path = src / "consult.cu"
    text = path.read_text()
    for a, b in subs:
        if a not in text:
            raise RuntimeError(f"variant {name}: {a!r} not in consult.cu")
        text = text.replace(a, b)
    path.write_text(text)
    saved = (K.CSRC, K.BUILD_DIR, K._LIB, dict(K.BUILD_INFO))
    K.CSRC, K.BUILD_DIR, K._LIB = src, src.parent / "lib", None
    K.BUILD_INFO.clear()
    try:
        lib = K.lib()
        report = str(K.BUILD_INFO.get("ptxas", ""))
    finally:
        K.CSRC, K.BUILD_DIR, K._LIB = saved[:3]
        K.BUILD_INFO.clear()
        K.BUILD_INFO.update(saved[3])
    return lib, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", action="store_true")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k12_compare: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    built = K.lib()
    libs = {"built": built}
    reports = {"built": str(K.BUILD_INFO.get("ptxas", ""))}
    if opts.variants:
        for name, subs in VARIANTS.items():
            libs[name], reports[name] = variant_library(name, subs)
    for name, report in reports.items():
        print(json.dumps({"build": name, "ptxas": ptxas_fused(report)}),
              flush=True)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for label, b, t, k, per_row, per_txn in SHAPES:
        args = case(label, b, t, k, per_row, per_txn, dev)
        want = K.fused_consult_plain(*args)
        fns = {}
        for name, lib in libs.items():
            def fused(lib=lib):
                K._LIB = lib
                return K.fused_consult(*args)
            got = fused()
            torch.cuda.synchronize()
            if not all(torch.equal(a, w) for a, w in zip(got, want)):
                raise RuntimeError(f"{name} K12 differs at {label}")
            fns[f"k12_{name}"] = fused

        def pair():
            K._LIB = built
            return halves(args)
        got = pair()
        torch.cuda.synchronize()
        if not all(torch.equal(a, w) for a, w in zip(got, want)):
            raise RuntimeError(f"K1 + K2 differ at {label}")
        fns["k1_k2"] = pair
        order = list(fns) + list(reversed(list(fns)))
        ms = {n: [] for n in fns}
        for n in order:
            ms[n].append(cs.device_ms(torch, fns[n], ITERS, flush))
        host = {n: cs.host_us(torch, fns[n], ITERS) for n in fns}
        K._LIB = built
        print(json.dumps({"shape": label, "B": b, "T": t, "K": k,
                          "keys_per_row": per_row, "ms": ms,
                          "host_us": host}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
