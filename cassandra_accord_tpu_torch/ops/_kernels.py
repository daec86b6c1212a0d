"""Build, load and launch the hand-written consult kernels (csrc/).

K1 ``deps_join`` is the port of the TPU join kernel
(cassandra_accord_tpu/ops/pallas_join.py::_join_kernel); K2 ``max_conflict``
is the timestamp-proposal half of the same consult.  Each kernel is
hand-written CUDA for sm_90a and has one wrapper here, named as its
``LAUNCHES`` counter:

- ``deps_join`` / ``max_conflict`` (csrc/consult.cu), the CSR form: each
  query row ORs the [K, T] incidence rows of its own keys, so a call reads
  nnz*T index bytes.
- ``deps_join_dense`` / ``max_conflict_dense`` (csrc/dense_join.cu): the
  overlap as an int8 tensor-core product (a TMA ring and wgmma) of the
  binarized query tile against the whole [K, T] index, which a call reads
  once per 256 query rows (K*T bytes).
- ``fused_consult`` (csrc/consult.cu), K12: the service's window, the CSR
  form of K1 over ``live_T`` and of K2 over ``key_T`` in one launch with
  the slot data and the staged CSR slice read once, both answers views of
  one buffer (``consult_out``: the lanes first, then the deps) that
  ``device_service.kernel.to_host`` brings back in one copy.
- ``deps_join_tk`` / ``max_conflict_tk`` (csrc/dense_join_tk.cu, counted
  as ``deps_join_dense_tk`` / ``max_conflict_dense_tk``): the dense product
  on the index as the reference holds it, ``[T, K]``, and the ``[B, K]``
  query as they lie, so their callers (``ops/deps_kernels.py``: the
  one-shot consults, the model and sharded steps) transpose nothing.
- ``write_rows`` / ``frontier_rows`` (csrc/step_rows.cu, counted as
  ``write_rows`` / ``frontier``), so that ``models.conflict_graph.txn_step``
  reads nothing back from the card: the first writes a batch's winning rows
  into the state in place (the last row in batch order to name a slot, as
  the reference's scatter keeps it), the second clears the ready rows whose
  adjacency meets a blocked column (the reference's signed product test),
  reading only those rows.
- ``lex_max_deps`` (csrc/lex_max.cu), the step's MaxConflicts: per row of
  the [B, T] deps mask, the lex max of the slots' [T, 5] lanes by
  ``lex_max_masked``'s rule, and the row's OR, each deps byte read once.

Each source's header says what bounds it on the H100.

The rules, one per index layout, of host-known sizes only (nothing is read
back from the card to decide): ``join_form(b, t, k, n_cols)`` for the
[K, T] index (``device_service.kernel.ragged_consult_t``: "csr" takes K12,
"dense" K1d and K2d), and ``tk_refusal(k, ...)`` for the [T, K] index
(``ops/deps_kernels.py``: None takes the ``_tk`` kernels, a reason the
transpose, a CSR query with values and K1/K2).  Their constants come from
sweeps on the card (PERF.md).

Build: every ``*.cu`` under ``csrc/`` is compiled by its own ``nvcc
-gencode arch=compute_90a,code=sm_90a -O3 -c``, all started together, and
linked into one shared library with a plain C interface, at first use,
under ``build/torch_kernels/`` beside the package (named by the hash of
every source and header and the flags, so an edited source rebuilds),
loaded with ``ctypes``.  Pointers and the stream go over as ``c_void_p``.

Dispatch: each wrapper runs its PLAIN torch version (same module, same
arguments) for tensors on the CPU.  For CUDA tensors it launches its kernel
on ``torch.cuda.current_stream()`` or raises: on a failed build, a refused
launch (the C entry returns ``cudaGetLastError()``), or inputs the kernel
does not take; it never falls back to another kernel or the plain version.
``LAUNCHES`` counts the launches that reached the card.

Layout: the index incidence is pre-transposed ``[K, T]`` uint8 (0/1), the
query a CSR pair ``offsets [B+1]`` / ``cols [N]`` int32 (duplicates legal,
entries past ``offsets[B]`` ignored; a column in [-K, -1] names column + K
and the others outside [0, K) are dropped, in the kernels and the plain
versions alike, as the reference's densify), lanes ``[*, 5]`` int32, kinds
and statuses int8, ``active`` bool.  A kind code indexes the witness table
as the reference's gather does: a negative code wraps once, then every
code clamps into the table.  ``vals`` (``[N]`` int8, K1 and K2 only) gives
each column a signed value, for the ``[T, K]`` callers' route through these
wrappers: the index bytes are then read as int8 and the overlap is the
reference's, ``sum_c vals[c] * inc[c, t] > 0``.  The ``_tk`` entries take
the index as ``[T, K]`` and the query as dense ``[B, K]``, both int8
values, row-major, with the same signed overlap.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .graph_state import (INVALIDATED, TS_LANES, GraphState, last_writers,
                          put_rows, ts_less, wrap_index)

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches that reached the card, per kernel (tests and
# chip_smoke.py zero these before a run and read them after)
LAUNCHES: Dict[str, int] = {"deps_join": 0, "max_conflict": 0,
                            "deps_join_dense": 0, "max_conflict_dense": 0,
                            "deps_join_dense_tk": 0,
                            "max_conflict_dense_tk": 0, "fused_consult": 0,
                            "write_rows": 0, "frontier": 0,
                            "lex_max_deps": 0}

# the dense forms' int32 sums stay exact (255 * 2^14 keys < 2^31), and the
# [K, T] form's query bytes small
DENSE_MAX_K = 16384
# join_form's thresholds, set from the sweep of both forms on the card
# (PERF.md §6 has it): dense from 1.5 query columns per index key and 64
# query rows (the dense kernel streams the index once for up to 256 rows,
# but its products and epilogue grow with the rows: it broke even with CSR
# near 1.4 columns per key at 64 rows and near 9 to 11 at 256, where the
# rule's 6 sends rows of 6 to 9 columns per key to the slower form),
# and from K = 64: rows naming all of K = 16 keys were CSR-faster in 7 of 8
# readings, of 64 keys dense-faster in 7 of 8 (by at most 0.006 ms), of
# 256 keys dense-faster in all
DENSE_MIN_K = 64
DENSE_COLS_PER_KEY = 1.5
DENSE_ROWS = 64

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                       " the consult kernels cannot be built")


def build() -> Path:
    """Compile every csrc/*.cu (once per hash of the sources, headers and
    flags), all nvcc processes started together, link them into one shared
    library and return its path.  ``BUILD_INFO`` records the build's
    seconds and the ptxas reports."""
    srcs = sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    out = BUILD_DIR / f"libconsult_{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO.setdefault("path", str(out))
        BUILD_INFO.setdefault("seconds", 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, cmds, procs = [], [], []
        for src in (p for p in srcs if p.suffix == ".cu"):
            objs.append(str(Path(tmpdir) / f"{src.stem}.o"))
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)])
            procs.append(subprocess.Popen(cmds[-1], stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        ptxas = [proc.communicate()[1] for proc in procs]   # all finish
        for cmd, proc, err in zip(cmds, procs, ptxas):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{err}")
        tmp = str(Path(tmpdir) / "lib.so")
        cmds.append([nvcc, "-shared", "-o", tmp, *objs])
        proc = subprocess.run(cmds[-1], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builders never see a torn file
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                      ptxas="".join(ptxas),
                      command="\n".join(" ".join(c) for c in cmds))
    return out


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        so.deps_join_launch.argtypes = [vp] * 10 + [ctypes.c_ulonglong] + \
            [i32] * 6 + [vp, vp]
        so.deps_join_launch.restype = i32
        so.max_conflict_launch.argtypes = [vp] * 7 + [i32] * 3 + [vp] * 3
        so.max_conflict_launch.restype = i32
        so.max_conflict_scratch_ints.argtypes = [i32, i32, i32]
        so.max_conflict_scratch_ints.restype = ctypes.c_longlong
        so.deps_join_dense_launch.argtypes = [vp] * 9 + \
            [ctypes.c_ulonglong] + [i32] * 7 + [vp] * 3
        so.deps_join_dense_launch.restype = i32
        so.max_conflict_dense_launch.argtypes = [vp] * 6 + [i32] * 4 + \
            [vp] * 3
        so.max_conflict_dense_launch.restype = i32
        for fn in (so.deps_join_dense_scratch_ints,
                   so.max_conflict_dense_scratch_ints):
            fn.argtypes = [i32, i32, i32]
            fn.restype = ctypes.c_longlong
        so.deps_join_tk_launch.argtypes = [vp] * 8 + \
            [ctypes.c_ulonglong] + [i32] * 6 + [vp] * 2
        so.deps_join_tk_launch.restype = i32
        so.max_conflict_tk_launch.argtypes = [vp] * 5 + [i32] * 3 + [vp] * 3
        so.max_conflict_tk_launch.restype = i32
        so.max_conflict_tk_scratch_ints.argtypes = [i32, i32]
        so.max_conflict_tk_scratch_ints.restype = ctypes.c_longlong
        so.fused_consult_launch.argtypes = [vp] * 11 + \
            [ctypes.c_ulonglong] + [i32] * 6 + [vp] * 4
        so.fused_consult_launch.restype = i32
        so.fused_consult_scratch_ints.argtypes = [i32, i32]
        so.fused_consult_scratch_ints.restype = ctypes.c_longlong
        i64 = ctypes.c_longlong
        so.write_rows_launch.argtypes = [vp, vp, i32, i64, i32] + [vp] * 9 + \
            [i32] + [vp] * 4
        so.write_rows_launch.restype = i32
        so.frontier_launch.argtypes = [vp] * 3 + [i64] * 2 + [vp]
        so.frontier_launch.restype = i32
        so.lex_max_deps_launch.argtypes = [vp, vp, i32, i64, vp, vp, vp]
        so.lex_max_deps_launch.restype = i32
        _LIB = so
    return _LIB


# ---------------------------------------------------------------------------
# the witness table (Txn.Kind.witnesses) as the kernels and plain code see it
# ---------------------------------------------------------------------------

def witness_table() -> np.ndarray:
    """WITNESSES[a, b] = does a txn of kind-code a depend on conflicting txns
    of kind-code b (Txn.Kind.witnesses, Txn.java:221-262).  Built from the
    port's host enum so device and control plane can never disagree."""
    from ..primitives.timestamp import TxnKind
    n = len(TxnKind)
    w = np.zeros((n, n), dtype=np.bool_)
    for a in TxnKind:
        for b in TxnKind:
            w[a, b] = a.witnesses(b)
    return w


_WIT_NP = witness_table()
_WIT_BITS = sum(1 << (8 * a + b) for a, b in zip(*np.nonzero(_WIT_NP)))
_WIT_ON: Dict[torch.device, torch.Tensor] = {}


def witnesses_on(device: torch.device) -> torch.Tensor:
    t = _WIT_ON.get(device)
    if t is None:
        t = _WIT_ON[device] = torch.as_tensor(_WIT_NP, device=device)
    return t


def _kind_index(kind: torch.Tensor) -> torch.Tensor:
    # as the reference's gather reads a code: a negative one wraps once,
    # then every code clamps into the table (6 kinds: -1 -> 5, -7 -> 0)
    n = _WIT_NP.shape[0]
    return wrap_index(kind.long(), n).clamp(0, n - 1)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick the kernels are held to)
# ---------------------------------------------------------------------------

def dense_query(offsets: torch.Tensor, cols: torch.Tensor, k: int,
                vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CSR query as dense [B, K] int32 counts, or sums of ``vals``.
    Duplicate columns add up (int32: an int8 or uint8 sum would wrap to 0
    at 256); a column in [-k, -1] names column + k and the others outside
    [0, k) are dropped, as in the reference's densify
    (``.at[row_ids, flat_cols].add``)."""
    b = offsets.numel() - 1
    n = int(offsets[-1]) if b >= 0 else 0
    rows = torch.repeat_interleave(
        torch.arange(b, device=cols.device), (offsets[1:] - offsets[:-1]).long())
    c = wrap_index(cols[:n].long(), k)
    keep = (c >= 0) & (c < k)
    add = (torch.ones((), dtype=torch.int32, device=cols.device)
           if vals is None else vals[:n][keep].to(torch.int32))
    q = torch.zeros((b, k), dtype=torch.int32, device=cols.device)
    q.index_put_((rows[keep], c[keep]), add, accumulate=True)
    return q


def _positive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a @ b) > 0 for integer-valued operands, exactly: f64 holds every
    partial sum below 2^53 in magnitude (int8 operands: any K < 2^39)."""
    return (a.double() @ b.double()) > 0


def _share(inc_T: torch.Tensor, offsets: torch.Tensor, cols: torch.Tensor,
           vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T] key overlap.  Without ``vals``: f32 sums of non-negative
    counts, > 0 iff some product is > 0, whatever the rounding.  With
    ``vals``: the signed sum of the values times the index bytes read as
    int8, exactly."""
    q = dense_query(offsets, cols, inc_T.shape[0], vals)
    if vals is not None:
        return _positive(q, inc_T.view(torch.int8))
    return _overlap(q, inc_T)


def _overlap(q: torch.Tensor, inc_T: torch.Tensor) -> torch.Tensor:
    """[B, T] overlap of the dense [B, K] counts with the 0/1 index."""
    return (q.float() @ inc_T.float()) > 0


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] bool -> [B, T/8] uint8, little-endian (bit i of byte j = slot
    8j+i), T a multiple of 8."""
    b, t = mask.shape
    if t % 8:
        raise ValueError(f"bit-packing needs T % 8 == 0, got T={t}")
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                     device=mask.device)
    return (mask.reshape(b, t // 8, 8).to(torch.int32) * w).sum(-1) \
        .to(torch.uint8)


def _share_tk(inc: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """[B, T] key overlap of the [B, K] query and the [T, K] index, int8
    values: the signed sum of their products > 0, as the reference's bf16
    product summed in f32 (equal wherever that sum is exact), exactly."""
    return _positive(query, inc.t())


def _deps_mask(share, txn_id, kind, status, active, before, qkind, packed):
    started = ts_less(txn_id[None, :, :], before[:, None, :])          # [B, T]
    wit = witnesses_on(share.device)[_kind_index(qkind)[:, None],
                                     _kind_index(kind)[None, :]]       # [B, T]
    eligible = active & (status != INVALIDATED)                        # [T]
    deps = share & started & wit & eligible[None, :]
    return pack_bits(deps) if packed else deps


def deps_join_plain(inc_T, txn_id, kind, status, active, offsets, cols,
                    before, qkind, packed: bool = False,
                    vals=None) -> torch.Tensor:
    return _deps_mask(_share(inc_T, offsets, cols, vals), txn_id, kind,
                      status, active, before, qkind, packed)


def deps_join_tk_plain(inc, txn_id, kind, status, active, query, before,
                       qkind, packed: bool = False) -> torch.Tensor:
    """K1 on the [T, K] index and the dense [B, K] query."""
    return _deps_mask(_share_tk(inc, query), txn_id, kind, status, active,
                      before, qkind, packed)


def lex_max_masked(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lexicographic max of packed timestamps vals[B, T, L] (broadcastable)
    over axis 1, considering only entries where mask[B, T]; fully-masked rows
    yield zero lanes (= Timestamp.NONE — all real lanes are >= 0)."""
    b = mask.shape[0]
    lanes = vals.shape[-1]
    if mask.shape[1] == 0:
        return torch.zeros((b, lanes), dtype=torch.int32, device=mask.device)
    tie = mask
    out = []
    for lane in range(lanes):
        v = vals[..., lane]
        m = torch.where(tie, v, torch.full_like(v, -1))
        best = m.max(dim=1).values                     # [B]
        tie = tie & (v == best[:, None])
        out.append(best.clamp_min(0))
    return torch.stack(out, dim=-1).to(torch.int32)    # [B, L]


def lex_max_deps_plain(ts: torch.Tensor, deps: torch.Tensor):
    """``lex_max_deps`` in torch ops (the CPU's form)."""
    return lex_max_masked(ts[None], deps), deps.any(dim=1)


def _max_of(share, ts, txn_id, active):
    mask = share & active[None, :]                                     # [B, T]
    per_slot = torch.where(ts_less(ts, txn_id)[:, None], txn_id, ts)   # [T, 5]
    return lex_max_masked(per_slot[None, :, :], mask)


def max_conflict_plain(inc_T, ts, txn_id, active, offsets, cols,
                       vals=None) -> torch.Tensor:
    return _max_of(_share(inc_T, offsets, cols, vals), ts, txn_id, active)


def max_conflict_tk_plain(inc, ts, txn_id, active, query) -> torch.Tensor:
    """K2 on the [T, K] index and the dense [B, K] query."""
    return _max_of(_share_tk(inc, query), ts, txn_id, active)


def fused_consult_plain(live_T, key_T, ts, txn_id, kind, status, active,
                        offsets, cols, before, qkind, packed: bool = False):
    """K12: ``deps_join_plain`` over ``live_T`` and ``max_conflict_plain``
    over ``key_T``, the query densified once."""
    q = dense_query(offsets, cols, live_T.shape[0])
    return (_deps_mask(_overlap(q, live_T), txn_id, kind, status, active,
                       before, qkind, packed),
            _max_of(_overlap(q, key_T), ts, txn_id, active))


def consult_out(b: int, t: int, packed: bool, device) -> tuple:
    """(deps, max_lanes): the two answers of a window as views of one uint8
    buffer (a multiple of 4 bytes long), the [B, 5] int32 lanes at offset 0
    and the deps ([B, T] bool, or [B, T/8] uint8 bit-packed) from the next
    16-byte boundary, so that one copy brings both back
    (``device_service.kernel.to_host``)."""
    start = -(-b * TS_LANES * 4 // 16) * 16
    width = t // 8 if packed else t
    buf = torch.empty((start + -(-b * width // 4) * 4,), dtype=torch.uint8,
                      device=device)
    max_lanes = buf.view(torch.int32).as_strided((b, TS_LANES), (TS_LANES, 1))
    deps = (buf if packed else buf.view(torch.bool)).as_strided(
        (b, width), (width, 1), start)
    return deps, max_lanes


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# a signed query's row sums stay inside int32 (|sum| <= 2^14 a column) for
# rows of distinct columns over fewer keys than this
SIGNED_MAX_K = 2 ** 17 - 1


def _check_common(inc_T, txn_id, active, offsets, cols, before=None,
                  vals=None):
    dev = inc_T.device
    if dev.type != "cuda":
        raise ValueError(f"the consult kernels take CUDA or CPU tensors, got {dev}")
    k, t = inc_T.shape
    b = offsets.numel() - 1
    _check("inc_T", inc_T, torch.uint8, (k, t), dev)
    _check("txn_id", txn_id, torch.int32, (t, TS_LANES), dev)
    _check("active", active, torch.bool, (t,), dev)
    _check("offsets", offsets, torch.int32, (b + 1,), dev)
    _check("cols", cols, torch.int32, (cols.numel(),), dev)
    if before is not None:
        _check("before", before, torch.int32, (b, TS_LANES), dev)
    if vals is not None:
        _check("vals", vals, torch.int8, (cols.numel(),), dev)
        if k > SIGNED_MAX_K:
            raise ValueError(f"a signed query takes K <= {SIGNED_MAX_K}, "
                             f"got K={k}")
    if t >= 2 ** 31 or k >= 2 ** 31 or b >= 2 ** 19:
        raise ValueError(f"shape out of the kernels' range: B={b} T={t} K={k}")
    return b, t, k


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def tk_refusal(k: int, *tensors: torch.Tensor) -> Optional[str]:
    """Why the [T, K] kernels cannot take an index and query of K keys at
    these addresses (their tensor maps need a row stride of a multiple of
    16 bytes and 16-byte aligned bases), or None."""
    if k % 16 or not 16 <= k <= DENSE_MAX_K:
        return f"K % 16 == 0 and 16 <= K <= {DENSE_MAX_K}, got K={k}"
    bad = [x.data_ptr() % 16 for x in tensors if x.data_ptr() % 16]
    if bad:
        return f"16-byte aligned index and query, got address % 16 = {bad}"
    return None


def join_form(b: int, t: int, k: int, n_cols: int) -> str:
    """The [K, T] index's rule: "dense" (K1d and K2d) or "csr" (K12) for a
    call of B rows and ``n_cols`` CSR columns (``cols.numel()``) over T
    slots and K keys.  Dense when the rows name at least
    DENSE_COLS_PER_KEY columns per key and DENSE_ROWS rows (the CSR form
    re-reads n_cols*T index bytes, the dense form's time grows with K*T and
    the rows), K is at least DENSE_MIN_K (below it rows are short and the
    CSR form's single launch is cheaper) and at most DENSE_MAX_K, and T is
    a multiple of 16 (the index's tensor map takes a row pitch of a
    multiple of 16 bytes)."""
    tiles = -(-b // DENSE_ROWS)
    if (DENSE_MIN_K <= k <= DENSE_MAX_K and t % 16 == 0
            and n_cols >= DENSE_COLS_PER_KEY * k * tiles):
        return "dense"
    return "csr"


def _check_dense(inc_T: torch.Tensor) -> None:
    k, t = inc_T.shape
    if k > DENSE_MAX_K or t % 16 or inc_T.data_ptr() % 16:
        raise ValueError(
            f"the dense kernels take K <= {DENSE_MAX_K}, T % 16 == 0 and a "
            f"16-byte aligned index, got K={k}, T={t}, "
            f"address % 16 = {inc_T.data_ptr() % 16}")


def _scratch(n: int, name: str, dev: torch.device) -> Optional[torch.Tensor]:
    """The int32 scratch a launch asked for (``n`` < 0: minus the CUDA
    error of the entry point's device query)."""
    if n < 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {-n}")
    return torch.empty((n,), dtype=torch.int32, device=dev) if n else None


def _ptr_or_null(x: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    return None if x is None else _ptr(x)


def _launched(name: str, rc: int, out):
    """``out``, once the launch that writes it returned ``rc`` 0."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def _output(out: Optional[torch.Tensor], shape: tuple, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """A new output tensor, or ``out`` checked to be one the kernels can
    write (their vector stores need a 16-byte aligned base)."""
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    _check("out", out, dtype, shape, device)
    if out.data_ptr() % 16:
        raise ValueError(f"out must be 16-byte aligned, got address % 16 = "
                         f"{out.data_ptr() % 16}")
    return out


def _into(out: Optional[torch.Tensor], got: torch.Tensor) -> torch.Tensor:
    """A plain version's answer, written into ``out`` when one is given."""
    if out is None:
        return got
    _check("out", out, got.dtype, tuple(got.shape), got.device)
    return out.copy_(got)


def _deps_out(out, kind, status, qkind, b, t, packed, dev):
    """The deps half's checks (slot and query kind codes, statuses, the
    packed width), then its output: ``out`` checked, or a new one."""
    _check("kind", kind, torch.int8, (t,), dev)
    _check("status", status, torch.int8, (t,), dev)
    _check("qkind", qkind, torch.int8, (b,), dev)
    if packed and t % 8:
        raise ValueError(f"bit-packed output needs T % 8 == 0, got T={t}")
    return _output(out, (b, t // 8) if packed else (b, t),
                   torch.uint8 if packed else torch.bool, dev)


def _deps_args(inc_T, txn_id, kind, status, active, offsets, cols, before,
               qkind, b, t, k):
    """The leading and trailing arguments K1's and K1d's C entries share."""
    return ((_ptr(inc_T), _ptr(txn_id), _ptr(kind), _ptr(status),
             _ptr(active), _ptr(offsets), _ptr(cols)),
            (_ptr(before), _ptr(qkind), ctypes.c_ulonglong(_WIT_BITS),
             _WIT_NP.shape[0], INVALIDATED, b, t, k))


def deps_join(inc_T, txn_id, kind, status, active, offsets, cols, before,
              qkind, packed: bool = False,
              vals: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1, the CSR kernel: the dependency mask [B, T] bool, or [B, T/8]
    uint8 bit-packed; with ``vals`` the signed overlap.  ``out``: the
    tensor to write it into (one of ``consult_out``'s views)."""
    if inc_T.device.type == "cpu":
        return _into(out, deps_join_plain(inc_T, txn_id, kind, status, active,
                                          offsets, cols, before, qkind,
                                          packed, vals))
    b, t, k = _check_common(inc_T, txn_id, active, offsets, cols, before,
                            vals)
    out = _deps_out(out, kind, status, qkind, b, t, packed, inc_T.device)
    if b == 0 or t == 0:
        return out
    head, tail = _deps_args(inc_T, txn_id, kind, status, active, offsets,
                            cols, before, qkind, b, t, k)
    rc = lib().deps_join_launch(*head, _ptr_or_null(vals), *tail,
                                int(bool(packed)), _ptr(out),
                                _stream(inc_T.device))
    return _launched("deps_join", rc, out)


def deps_join_dense(inc_T, txn_id, kind, status, active, offsets, cols,
                    before, qkind, packed: bool = False,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1d, the dense kernel on the [K, T] index: ``deps_join``'s answer
    for 0/1 columns (no values); raises for K > DENSE_MAX_K, T % 16 != 0
    or an index not 16-byte aligned."""
    if inc_T.device.type == "cpu":
        return _into(out, deps_join_plain(inc_T, txn_id, kind, status, active,
                                          offsets, cols, before, qkind,
                                          packed))
    _check_dense(inc_T)
    b, t, k = _check_common(inc_T, txn_id, active, offsets, cols, before)
    out = _deps_out(out, kind, status, qkind, b, t, packed, inc_T.device)
    if b == 0 or t == 0:
        return out
    so, dev = lib(), inc_T.device
    head, tail = _deps_args(inc_T, txn_id, kind, status, active, offsets,
                            cols, before, qkind, b, t, k)
    # scratch: the query as bytes, built by the launch's first kernel
    scratch = _scratch(so.deps_join_dense_scratch_ints(b, t, k),
                       "deps_join_dense", dev)
    rc = so.deps_join_dense_launch(*head, *tail, cols.numel(),
                                   int(bool(packed)), _ptr_or_null(scratch),
                                   _ptr(out), _stream(dev))
    return _launched("deps_join_dense", rc, out)


def _check_tk(inc, query, txn_id, active, before=None):
    dev = inc.device
    if dev.type != "cuda":
        raise ValueError(f"the consult kernels take CUDA or CPU tensors, got {dev}")
    t, k = inc.shape
    b = query.shape[0]
    _check("inc", inc, torch.int8, (t, k), dev)
    _check("query", query, torch.int8, (b, k), dev)
    _check("txn_id", txn_id, torch.int32, (t, TS_LANES), dev)
    _check("active", active, torch.bool, (t,), dev)
    if before is not None:
        _check("before", before, torch.int32, (b, TS_LANES), dev)
    if t >= 2 ** 31 or b >= 2 ** 19:
        raise ValueError(f"shape out of the kernels' range: B={b} T={t} K={k}")
    why = tk_refusal(k, inc, query)
    if why is not None:
        raise ValueError(f"the [T, K] kernels take {why}")
    return b, t, k


def deps_join_tk(inc, txn_id, kind, status, active, query, before, qkind,
                 packed: bool = False) -> torch.Tensor:
    """K1d on the [T, K] index ``inc`` and the dense [B, K] ``query`` (int8
    values, the overlap their product's sign): the dependency mask [B, T]
    bool, or [B, T/8] uint8 bit-packed (csrc/dense_join_tk.cu)."""
    if inc.device.type == "cpu":
        return deps_join_tk_plain(inc, txn_id, kind, status, active, query,
                                  before, qkind, packed)
    b, t, k = _check_tk(inc, query, txn_id, active, before)
    dev = inc.device
    out = _deps_out(None, kind, status, qkind, b, t, packed, dev)
    if b == 0 or t == 0:
        return out
    rc = lib().deps_join_tk_launch(
        _ptr(inc), _ptr(query), _ptr(txn_id), _ptr(kind), _ptr(status),
        _ptr(active), _ptr(before), _ptr(qkind), ctypes.c_ulonglong(_WIT_BITS),
        _WIT_NP.shape[0], INVALIDATED, b, t, k, int(bool(packed)), _ptr(out),
        _stream(dev))
    return _launched("deps_join_dense_tk", rc, out)


def max_conflict_tk(inc, ts, txn_id, active, query) -> torch.Tensor:
    """K2d on the [T, K] index and the dense [B, K] query: per row the lex
    max [B, 5] int32 of max(ts, txn_id) over the active slots sharing a
    key, zero lanes when none (csrc/dense_join_tk.cu)."""
    if inc.device.type == "cpu":
        return max_conflict_tk_plain(inc, ts, txn_id, active, query)
    b, t, k = _check_tk(inc, query, txn_id, active)
    dev = inc.device
    _check("ts", ts, torch.int32, (t, TS_LANES), dev)
    out = torch.empty((b, TS_LANES), dtype=torch.int32, device=dev)
    if b == 0 or t == 0:
        return out.zero_()
    so = lib()
    name = "max_conflict_dense_tk"
    # scratch: the partials of a row tile several blocks share
    scratch = _scratch(so.max_conflict_tk_scratch_ints(b, t), name, dev)
    rc = so.max_conflict_tk_launch(
        _ptr(inc), _ptr(query), _ptr(ts), _ptr(txn_id), _ptr(active), b, t, k,
        _ptr_or_null(scratch), _ptr(out), _stream(dev))
    return _launched(name, rc, out)


def _check_max(inc_T, ts, txn_id, active, offsets, cols, vals, out):
    """K2's and K2d's checks: (B, T, K, the output to write)."""
    b, t, k = _check_common(inc_T, txn_id, active, offsets, cols, vals=vals)
    _check("ts", ts, torch.int32, (t, TS_LANES), inc_T.device)
    return b, t, k, _output(out, (b, TS_LANES), torch.int32, inc_T.device)


def max_conflict(inc_T, ts, txn_id, active, offsets, cols,
                 vals: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2, the CSR kernel: per query row, the lex max [B, 5] int32 of
    max(ts, txn_id) over the active slots sharing a key (zero lanes when
    none); with ``vals`` the signed overlap.  ``out``: as ``deps_join``'s."""
    if inc_T.device.type == "cpu":
        return _into(out, max_conflict_plain(inc_T, ts, txn_id, active,
                                             offsets, cols, vals))
    b, t, k, out = _check_max(inc_T, ts, txn_id, active, offsets, cols, vals,
                              out)
    if b == 0 or t == 0:
        return out.zero_()
    so, dev = lib(), inc_T.device
    # the kernel writes every row of out; scratch: the partials of a row
    # that several blocks share, with their counters
    scratch = _scratch(so.max_conflict_scratch_ints(
        b, t, int(vals is not None)), "max_conflict", dev)
    rc = so.max_conflict_launch(
        _ptr(inc_T), _ptr(ts), _ptr(txn_id), _ptr(active), _ptr(offsets),
        _ptr(cols), _ptr_or_null(vals), b, t, k, _ptr_or_null(scratch),
        _ptr(out), _stream(dev))
    return _launched("max_conflict", rc, out)


def max_conflict_dense(inc_T, ts, txn_id, active, offsets, cols,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2d, the dense kernel on the [K, T] index: ``max_conflict``'s answer
    for 0/1 columns; raises as ``deps_join_dense`` does."""
    if inc_T.device.type == "cpu":
        return _into(out, max_conflict_plain(inc_T, ts, txn_id, active,
                                             offsets, cols))
    _check_dense(inc_T)
    b, t, k, out = _check_max(inc_T, ts, txn_id, active, offsets, cols, None,
                              out)
    if b == 0 or t == 0:
        return out.zero_()
    so, dev = lib(), inc_T.device
    # scratch: the partials of a row that several blocks share and the
    # query bytes
    scratch = _scratch(so.max_conflict_dense_scratch_ints(b, t, k),
                       "max_conflict_dense", dev)
    rc = so.max_conflict_dense_launch(
        _ptr(inc_T), _ptr(ts), _ptr(txn_id), _ptr(active), _ptr(offsets),
        _ptr(cols), b, t, k, cols.numel(), _ptr_or_null(scratch), _ptr(out),
        _stream(dev))
    return _launched("max_conflict_dense", rc, out)


def fused_consult(live_T, key_T, ts, txn_id, kind, status, active, offsets,
                  cols, before, qkind, packed: bool = False):
    """K12: ``deps_join`` over ``live_T`` and ``max_conflict`` over
    ``key_T`` for one CSR query (0/1 indexes, no values) in one launch of
    the CSR kernel (csrc/consult.cu), the service's window.  Returns (deps
    [B, T] bool or [B, T/8] uint8, max_lanes [B, 5] int32), views of one
    buffer (``consult_out``)."""
    k, t = live_T.shape
    b = offsets.numel() - 1
    dev = live_T.device
    if dev.type == "cpu":
        deps, max_lanes = consult_out(b, t, packed, dev)
        got = fused_consult_plain(live_T, key_T, ts, txn_id, kind, status,
                                  active, offsets, cols, before, qkind, packed)
        return _into(deps, got[0]), _into(max_lanes, got[1])
    _check_common(live_T, txn_id, active, offsets, cols, before)
    _check("key_T", key_T, torch.uint8, (k, t), dev)
    _check("ts", ts, torch.int32, (t, TS_LANES), dev)
    deps, max_lanes = consult_out(b, t, packed, dev)
    _deps_out(deps, kind, status, qkind, b, t, packed, dev)
    if b == 0 or t == 0:
        max_lanes.zero_()
        return deps, max_lanes
    so = lib()
    # scratch: the partials of a row group that several blocks share, with
    # their counters
    scratch = _scratch(so.fused_consult_scratch_ints(b, t), "fused_consult",
                       dev)
    rc = so.fused_consult_launch(
        _ptr(live_T), _ptr(key_T), _ptr(ts), _ptr(txn_id), _ptr(kind),
        _ptr(status), _ptr(active), _ptr(offsets), _ptr(cols), _ptr(before),
        _ptr(qkind), ctypes.c_ulonglong(_WIT_BITS), _WIT_NP.shape[0],
        INVALIDATED, b, t, k, int(bool(packed)), _ptr_or_null(scratch),
        _ptr(max_lanes), _ptr(deps), _stream(dev))
    return _launched("fused_consult", rc, (deps, max_lanes))


# ---------------------------------------------------------------------------
# the conflict-graph step's row writes and execution frontier
# ---------------------------------------------------------------------------

def write_rows_plain(state: GraphState, slots, valid, key_inc=None, ts=None,
                     txn_id=None, kind=None, status=None, adj=None,
                     active=False) -> None:
    """``write_rows`` in torch ops (the CPU's form): padding rows aimed at
    T - 1, the winning rows from ``graph_state.last_writers``, then one
    ``put_rows`` a field."""
    t = state.txn_slots
    valid = valid.to(torch.bool)
    safe = torch.where(valid, wrap_index(slots.long(), t), t - 1)
    win = last_writers(safe, t, keep=valid)
    dst = safe[win]
    for name, src in (("key_inc", key_inc), ("ts", ts), ("txn_id", txn_id),
                      ("kind", kind), ("adj", adj)):
        if src is not None:
            put_rows(getattr(state, name), dst, src[win], inplace=True)
    if status is not None:
        state.status[dst] = status
    if active:
        state.active[dst] = True


def _byte_rows(x: torch.Tensor) -> torch.Tensor:
    """int8 bytes of a bool or int8 tensor, as ``put``ting it into an int8
    field converts it (a bool is viewed, not copied)."""
    x = x.contiguous()
    return x.view(torch.int8) if x.dtype == torch.bool else x.to(torch.int8)


def write_rows(state: GraphState, slots: torch.Tensor, valid: torch.Tensor,
               key_inc: Optional[torch.Tensor] = None,
               ts: Optional[torch.Tensor] = None,
               txn_id: Optional[torch.Tensor] = None,
               kind: Optional[torch.Tensor] = None,
               status: Optional[int] = None,
               adj: Optional[torch.Tensor] = None,
               active: bool = False) -> None:
    """Write batch row b's fields into slot ``slots[b]`` of ``state``, in
    place, for the rows that win: valid, the slot wrapped once inside [0,
    T), and no later row aimed at the same slot, a padding row aiming at
    T - 1 (``graph_state.last_writers``).  The fields: ``key_inc`` [B, K],
    ``ts`` and ``txn_id`` [B, 5] lanes, ``kind`` [B], ``adj`` [B, T] (bool
    or int8) rows, the status code ``status`` and, with ``active``,
    the active flag.  A field left None is not written.  On the card one
    launch (csrc/step_rows.cu) and nothing read back; on the CPU the plain
    version."""
    if state.status.device.type == "cpu":
        return write_rows_plain(state, slots, valid, key_inc, ts, txn_id,
                                kind, status, adj, active)
    dev = state.status.device
    t, k = state.txn_slots, state.key_slots
    b = slots.numel()
    if t >= 2 ** 31 or b >= 2 ** 19:
        raise ValueError(f"shape out of the kernel's range: B={b} T={t}")
    slots = slots.to(torch.int64).contiguous()
    valid = valid.to(torch.bool).contiguous()
    _check("slots", slots, torch.int64, (b,), dev)
    _check("valid", valid, torch.bool, (b,), dev)
    src = {}                          # held until the launch has read them
    for name, x, dtype, width in (
            ("key_inc", key_inc, torch.int8, (k,)),
            ("ts", ts, torch.int32, (TS_LANES,)),
            ("txn_id", txn_id, torch.int32, (TS_LANES,)),
            ("kind", kind, torch.int8, ()),
            ("adj", adj, torch.int8, (t,)),
            ("status", status, torch.int8, ()),
            ("active", active or None, torch.bool, ())):
        if x is None:
            continue
        field = getattr(state, name)
        _check(f"state.{name}", field, dtype, (t, *width), dev)
        if isinstance(x, torch.Tensor):
            x = _byte_rows(x) if dtype == torch.int8 \
                else x.to(dtype).contiguous()
            _check(name, x, dtype, (b, *width), dev)
            src[name] = x

    def pair(name):
        x = src.get(name)
        return (None, None) if x is None \
            else (_ptr(x), _ptr(getattr(state, name)))
    if b == 0 or t == 0:
        return None
    rc = lib().write_rows_launch(
        _ptr(slots), _ptr(valid), b, t, k, *pair("key_inc"), *pair("ts"),
        *pair("txn_id"), *pair("kind"),
        None if status is None else _ptr(state.status),
        0 if status is None else int(status), *pair("adj"),
        _ptr(state.active) if active else None, _stream(dev))
    _launched("write_rows", rc, None)


def frontier_rows_plain(adj: torch.Tensor, blocked: torch.Tensor,
                        ready: torch.Tensor) -> torch.Tensor:
    """``frontier_rows`` in torch ops (the CPU's form)."""
    rows = torch.nonzero(ready).squeeze(1)
    blocked = blocked.to(torch.int32)[None, :]
    ready[rows] = (adj[rows].to(torch.int32) * blocked).sum(dim=1) <= 0
    return ready


def frontier_rows(adj: torch.Tensor, blocked: torch.Tensor,
                  ready: torch.Tensor) -> torch.Tensor:
    """Clear ``ready[i]`` (an [R] bool, in place) where row i of the [R, N]
    int8 adjacency ``adj`` sums to more than 0 over the ``blocked`` [N]
    columns (the reference's product test; for 0/1 rows: some edge onto a
    blocked slot), and return ``ready``.  Only the rows that enter ready
    are read: on the card by one launch (csrc/step_rows.cu), nothing read
    back; on the CPU the plain version."""
    if adj.device.type == "cpu":
        return frontier_rows_plain(adj, blocked, ready)
    dev = adj.device
    r, n = adj.shape
    if adj.dtype not in (torch.int8, torch.bool):
        raise TypeError(f"adj must be int8 or bool, got {adj.dtype}")
    adj = _byte_rows(adj)
    blocked = blocked.to(torch.bool).contiguous()
    _check("blocked", blocked, torch.bool, (n,), dev)
    _check("ready", ready, torch.bool, (r,), dev)
    rc = lib().frontier_launch(_ptr(adj), _ptr(blocked), _ptr(ready), r, n,
                               _stream(dev))
    return _launched("frontier", rc, ready)


# ---------------------------------------------------------------------------
# the conflict-graph step's MaxConflicts
# ---------------------------------------------------------------------------

def lex_max_deps(ts: torch.Tensor, deps: torch.Tensor):
    """(conflict_max [B, 5] int32, any_dep [B] bool): per row of the [B, T]
    bool ``deps``, ``lex_max_masked`` of the [T, 5] int32 lanes ``ts`` over
    the slots it names (zero lanes when none), and whether it names any.
    On the card one launch (csrc/lex_max.cu) and nothing read back; on the
    CPU the plain version."""
    dev = deps.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"lex_max_deps takes CUDA or CPU tensors, got {dev}")
    if deps.dim() != 2:
        raise ValueError(f"deps must be [B, T], got shape {tuple(deps.shape)}")
    b, t = deps.shape
    _check("deps", deps, torch.bool, (b, t), dev)
    _check("ts", ts, torch.int32, (t, TS_LANES), dev)
    if dev.type == "cpu":
        return lex_max_deps_plain(ts, deps)
    if t >= 2 ** 31 or b >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: B={b} T={t}")
    out = torch.empty((b, TS_LANES), dtype=torch.int32, device=dev)
    any_dep = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0 or t == 0:
        return out.zero_(), any_dep.zero_()
    rc = lib().lex_max_deps_launch(_ptr(deps), _ptr(ts), b, t, _ptr(out),
                                   _ptr(any_dep), _stream(dev))
    return _launched("lex_max_deps", rc, (out, any_dep))
