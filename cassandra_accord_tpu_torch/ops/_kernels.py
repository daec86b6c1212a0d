"""Build, load and launch the hand-written consult kernels (csrc/consult.cu).

K1 ``deps_join`` is the port of the TPU join kernel
(cassandra_accord_tpu/ops/pallas_join.py::_join_kernel); K2 ``max_conflict``
is the timestamp-proposal half of the same consult.  The source's header
says what each computes and what bounds it on the H100.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into a
shared library with a plain C interface, at first use, under
``build/torch_kernels/`` beside the package (named by the source's hash, so
an edited source rebuilds), loaded with ``ctypes``.  Pointers and the stream
go over as ``c_void_p``.

Dispatch: each wrapper takes the PLAIN torch version (same module, same
arguments) only for tensors on the CPU.  For CUDA tensors it launches the
kernel on ``torch.cuda.current_stream()`` or raises — on a failed build, a
refused launch, or inputs the kernel does not take.  ``LAUNCHES`` counts
kernel launches, one per wrapper call that reached the card.

Layout: the index incidence is pre-transposed ``[K, T]`` uint8 (0/1), the
query a CSR pair ``offsets [B+1]`` / ``cols [N]`` int32 (duplicates legal,
entries past ``offsets[B]`` ignored), lanes ``[*, 5]`` int32, kinds and
statuses int8, ``active`` bool.
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

from .graph_state import INVALIDATED, TS_LANES, ts_less

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "consult.cu"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches that reached the card, per kernel (tests and chip_smoke.py
# zero these before a run and read them after)
LAUNCHES: Dict[str, int] = {"deps_join": 0, "max_conflict": 0}

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
    """Compile csrc/consult.cu (once per source hash) and return the .so path.
    ``BUILD_INFO`` records the compile's seconds and ptxas report."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libconsult_{digest}.so"
    if out.exists():
        BUILD_INFO.setdefault("path", str(out))
        BUILD_INFO.setdefault("seconds", 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders never see a torn file
    BUILD_INFO.update(path=str(out), seconds=seconds, ptxas=proc.stderr,
                      command=" ".join(cmd))
    return out


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        so.deps_join_launch.argtypes = [vp] * 9 + [ctypes.c_ulonglong] + \
            [i32] * 6 + [vp, vp]
        so.deps_join_launch.restype = i32
        so.max_conflict_launch.argtypes = [vp] * 6 + [i32] * 3 + [vp] * 3
        so.max_conflict_launch.restype = i32
        so.max_conflict_scratch_ints.argtypes = [i32, i32]
        so.max_conflict_scratch_ints.restype = ctypes.c_longlong
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
    # out-of-range codes clamp, as a gather does in the reference
    return kind.long().clamp(0, _WIT_NP.shape[0] - 1)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick the kernels are held to)
# ---------------------------------------------------------------------------

def dense_query(offsets: torch.Tensor, cols: torch.Tensor, k: int) -> torch.Tensor:
    """The CSR query as dense [B, K] int32 counts.  Duplicate columns add up
    (int32: an int8 or uint8 sum would wrap to 0 at 256); out-of-range
    columns are dropped."""
    b = offsets.numel() - 1
    n = int(offsets[-1]) if b >= 0 else 0
    rows = torch.repeat_interleave(
        torch.arange(b, device=cols.device), (offsets[1:] - offsets[:-1]).long())
    c = cols[:n].long()
    keep = (c >= 0) & (c < k)
    q = torch.zeros((b, k), dtype=torch.int32, device=cols.device)
    q.index_put_((rows[keep], c[keep]),
                 torch.ones((), dtype=torch.int32, device=cols.device),
                 accumulate=True)
    return q


def _share(inc_T: torch.Tensor, offsets: torch.Tensor,
           cols: torch.Tensor) -> torch.Tensor:
    """[B, T] key overlap.  f32 sums of non-negative counts: > 0 iff some
    product is > 0, whatever the rounding."""
    q = dense_query(offsets, cols, inc_T.shape[0])
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


def deps_join_plain(inc_T, txn_id, kind, status, active, offsets, cols,
                    before, qkind, packed: bool = False) -> torch.Tensor:
    share = _share(inc_T, offsets, cols)                               # [B, T]
    started = ts_less(txn_id[None, :, :], before[:, None, :])          # [B, T]
    wit = witnesses_on(inc_T.device)[_kind_index(qkind)[:, None],
                                     _kind_index(kind)[None, :]]       # [B, T]
    eligible = active & (status != INVALIDATED)                        # [T]
    deps = share & started & wit & eligible[None, :]
    return pack_bits(deps) if packed else deps


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


def max_conflict_plain(inc_T, ts, txn_id, active, offsets,
                       cols) -> torch.Tensor:
    mask = _share(inc_T, offsets, cols) & active[None, :]              # [B, T]
    per_slot = torch.where(ts_less(ts, txn_id)[:, None], txn_id, ts)   # [T, 5]
    return lex_max_masked(per_slot[None, :, :], mask)


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


def _check_common(inc_T, txn_id, active, offsets, cols, before=None):
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
    if t >= 2 ** 31 or k >= 2 ** 31 or b >= 2 ** 19:
        raise ValueError(f"shape out of the kernels' range: B={b} T={t} K={k}")
    return b, t, k


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def deps_join(inc_T, txn_id, kind, status, active, offsets, cols, before,
              qkind, packed: bool = False) -> torch.Tensor:
    """K1: the dependency mask [B, T] bool, or [B, T/8] uint8 bit-packed."""
    if inc_T.device.type == "cpu":
        return deps_join_plain(inc_T, txn_id, kind, status, active, offsets,
                               cols, before, qkind, packed)
    b, t, k = _check_common(inc_T, txn_id, active, offsets, cols, before)
    dev = inc_T.device
    _check("kind", kind, torch.int8, (t,), dev)
    _check("status", status, torch.int8, (t,), dev)
    _check("qkind", qkind, torch.int8, (b,), dev)
    if packed and t % 8:
        raise ValueError(f"bit-packed output needs T % 8 == 0, got T={t}")
    out = torch.empty((b, t // 8) if packed else (b, t),
                      dtype=torch.uint8 if packed else torch.bool, device=dev)
    if b == 0 or t == 0:
        return out
    rc = lib().deps_join_launch(
        _ptr(inc_T), _ptr(txn_id), _ptr(kind), _ptr(status), _ptr(active),
        _ptr(offsets), _ptr(cols), _ptr(before), _ptr(qkind),
        ctypes.c_ulonglong(_WIT_BITS), _WIT_NP.shape[0], INVALIDATED, b, t, k,
        int(bool(packed)), _ptr(out), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"deps_join launch failed: CUDA error {rc}")
    LAUNCHES["deps_join"] += 1
    return out


def max_conflict(inc_T, ts, txn_id, active, offsets, cols) -> torch.Tensor:
    """K2: per query row, the lex max [B, 5] int32 of max(ts, txn_id) over
    the active slots sharing a key (zero lanes when none)."""
    if inc_T.device.type == "cpu":
        return max_conflict_plain(inc_T, ts, txn_id, active, offsets, cols)
    b, t, k = _check_common(inc_T, txn_id, active, offsets, cols)
    dev = inc_T.device
    _check("ts", ts, torch.int32, (t, TS_LANES), dev)
    out = torch.empty((b, TS_LANES), dtype=torch.int32, device=dev)
    if b == 0 or t == 0:
        return out.zero_()
    so = lib()
    # the kernel writes every row of out; scratch (the cross-tile fold's
    # counters and partials) only when T spans several tiles
    n = so.max_conflict_scratch_ints(b, t)
    if n < 0:
        raise RuntimeError(f"max_conflict launch failed: CUDA error {-n}")
    scratch = torch.empty((n,), dtype=torch.int32, device=dev) if n else None
    rc = so.max_conflict_launch(
        _ptr(inc_T), _ptr(ts), _ptr(txn_id), _ptr(active), _ptr(offsets),
        _ptr(cols), b, t, k, None if scratch is None else _ptr(scratch),
        _ptr(out), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"max_conflict launch failed: CUDA error {rc}")
    LAUNCHES["max_conflict"] += 1
    return out
