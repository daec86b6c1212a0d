"""Native (C++) host-tier runtime components, loaded via ctypes.

The reference keeps its hot host-side structures in primitive-array Java
(KeyDeps CSR maps, SortedArrays — SURVEY §2.8); our equivalents are numpy +
device kernels, with this package providing the NATIVE host rung of the
consult cost ladder: ``consult.cpp`` compiled on first use with the
toolchain's g++ into ``_consult.so`` and called through ctypes (no pybind11
in the image; the ctypes boundary passes raw numpy buffers, zero-copy).

Build is lazy, cached by source mtime, and failure-tolerant: environments
without a compiler simply fall back to the numpy tier
(``available()`` -> False).  Force a rebuild by deleting ``_consult.so``.
"""
from __future__ import annotations

import ctypes
import os
import platform
import subprocess
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "consult.cpp")
# -march=native output is host-specific: tag the cache by machine so a shared
# checkout across heterogeneous hosts never dlopens another arch's build
_LIB = os.path.join(_DIR, f"_consult_{platform.machine()}.so")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> bool:
    # compile to a private temp path and rename into place: rename is atomic
    # on the same filesystem, so concurrent builders (parallel pytest, burns)
    # never dlopen a partially-written .so
    tmp = f"{_LIB}.tmp.{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not os.path.exists(_LIB) \
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        if not _build():
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        _load_failed = True
        return None
    f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    c = lib.consult_batch
    c.restype = ctypes.c_int
    c.argtypes = [f32p, f32p, i32p, i32p, i8p, i8p, u8p,
                  ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                  i32p, ctypes.c_int32, i32p, i8p, ctypes.c_int32,
                  u8p, ctypes.c_int32, ctypes.c_int8,
                  ctypes.c_uint8, ctypes.c_uint8,
                  ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


_witness_cache: Optional[np.ndarray] = None


def _witnesses() -> np.ndarray:
    global _witness_cache
    if _witness_cache is None:
        from ..primitives.timestamp import TxnKind
        n = len(TxnKind)
        w = np.zeros((n, n), dtype=np.uint8)
        for a in TxnKind:
            for b in TxnKind:
                w[a, b] = 1 if a.witnesses(b) else 0
        _witness_cache = np.ascontiguousarray(w)
    return _witness_cache


def consult_batch(h: dict, qcols_list, before: np.ndarray, kind: np.ndarray,
                  invalidated_code: int, want_deps: bool = True,
                  want_max: bool = True
                  ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Run the native consult over the resolver's canonical host mirror
    ``h`` (key_inc/live_inc [T,K] int8, ts/txn_id [T,5] int32, kind/status
    [T] int8, active [T] bool).  ``qcols_list``: per-query lists of key-slot
    columns.  Returns (deps [B,T] bool | None, max_lanes [B,5] int64 | None).
    """
    lib = _load()
    assert lib is not None, "native consult unavailable"
    T, K = h["key_inc"].shape
    lanes = h["ts"].shape[1]
    assert lanes <= 8, f"native consult supports <=8 lanes, got {lanes}"
    B = len(qcols_list)
    max_q = max((len(c) for c in qcols_list), default=1) or 1
    qcols = np.full((B, max_q), -1, dtype=np.int32)
    for i, cols in enumerate(qcols_list):
        qcols[i, :len(cols)] = cols
    out_deps = np.zeros((B, T), dtype=np.uint8) if want_deps else None
    out_max = np.zeros((B, lanes), dtype=np.int64) if want_max else None
    active = np.ascontiguousarray(h["active"].astype(np.uint8))
    wit = _witnesses()
    # the TRANSPOSED f32 incidence mirrors the resolver already maintains
    # for its numpy tier ([K, T], 0.0/1.0); build per call only when the
    # index is above the resolver's f32-mirror bound (rare — the cost model
    # routes that scale to the device tier)
    live_T = h.get("live_f32")
    key_T = h.get("key_inc_f32")
    if live_T is None or key_T is None:
        live_T = np.ascontiguousarray(h["live_inc"].T.astype(np.float32))
        key_T = np.ascontiguousarray(h["key_inc"].T.astype(np.float32))
    rc = lib.consult_batch(
        np.ascontiguousarray(live_T),
        np.ascontiguousarray(key_T),
        np.ascontiguousarray(h["ts"]),
        np.ascontiguousarray(h["txn_id"]),
        np.ascontiguousarray(h["kind"]),
        np.ascontiguousarray(h["status"]),
        active, T, K, lanes,
        qcols, max_q,
        np.ascontiguousarray(before.astype(np.int32)),
        np.ascontiguousarray(kind.astype(np.int8)), B,
        wit, wit.shape[0], invalidated_code,
        1 if want_deps else 0, 1 if want_max else 0,
        out_deps.ctypes.data_as(ctypes.c_void_p) if want_deps else None,
        out_max.ctypes.data_as(ctypes.c_void_p) if want_max else None)
    if rc != 0:
        # a silent all-zero result would read as "no dependencies" — fail loud
        raise RuntimeError(f"native consult_batch failed (rc={rc})")
    return (out_deps.astype(bool) if want_deps else None, out_max)
