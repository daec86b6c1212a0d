"""The service's ragged consult over the pre-transposed index buffers.

Same join semantics as ``ops.deps_kernels.consult`` — key overlap x
started-before lex compare x kind-witness mask, plus the masked lex max for
the timestamp proposal — but consuming the DoubleBufferedIndex layout
directly:

- incidence comes in PRE-TRANSPOSED ``[K, T]`` uint8 (``live_T`` for the
  deps half, ``key_T`` for the max half), so no per-consult cast or
  transpose of the index;
- the ragged query batch stays ragged: ``offsets``/``flat_cols`` are the
  CSR pair ``batch.build_batch`` already produces, and each row reads only
  the incidence rows of its own keys.  Padding rows have width 0 and match
  nothing; flat padding past ``offsets[B]`` is never read.

As the reference computes a window in one program (one jitted function,
read back with one ``device_get``), the port computes it in one launch and
reads it back in one copy: where ``_kernels.join_form`` says CSR, K12
(``fused_consult``) answers both halves; where it says dense, K1d and K2d
write into one buffer of the same layout (``_kernels.consult_out``).
``to_host`` brings that buffer back.  For CPU buffers the wrappers run
their plain torch versions (which densify the query with an int32
scatter-add).  With ``packed`` the deps mask comes back bit-packed
``[B, T/8]`` uint8, little-endian, and ``unpack_deps`` turns the rows read
back into bool rows.

``consult_batch`` is a window's whole dispatch, the one the service and the
resolver's one-shot consult share: a ``batch.ConsultBatch`` in, the host's
answers out.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..observe.profiler import span
from ..ops import _kernels
from .batch import ConsultBatch


def ragged_consult_t(live_T, key_T, ts, txn_id, kind, status, active,
                     flat_cols, offsets, before, qkind, packed: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(deps [B, T] bool or [B, T/8] uint8, max_lanes [B, 5] int32), views
    of one buffer."""
    with span("accord.kernel.consult"):
        k, t = live_T.shape
        b = offsets.numel() - 1
        if _kernels.join_form(b, t, k, flat_cols.numel()) == "csr":
            return _kernels.fused_consult(live_T, key_T, ts, txn_id, kind,
                                          status, active, offsets, flat_cols,
                                          before, qkind, packed=packed)
        deps, max_lanes = _kernels.consult_out(b, t, packed, live_T.device)
        _kernels.deps_join_dense(live_T, txn_id, kind, status, active,
                                 offsets, flat_cols, before, qkind,
                                 packed=packed, out=deps)
        _kernels.max_conflict_dense(key_T, ts, txn_id, active, offsets,
                                    flat_cols, out=max_lanes)
        return deps, max_lanes


def packs(buffers: Dict[str, torch.Tensor]) -> bool:
    """Whether a window over these buffers comes back bit-packed: only
    across a real transfer link (on the CPU packing is pure extra compute)
    and where it pays, T >= 32768 (T % 8 == 0)."""
    t = buffers["live_T"].shape[1]
    return t >= 32768 and t % 8 == 0 and buffers["live_T"].device.type != "cpu"


def consult_batch(batch: ConsultBatch, buffers: Dict[str, torch.Tensor]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """One window: upload ``batch``, one launch over ``buffers`` (the
    kernels' layout, ``index.front_from_host``), the real rows of both
    answers read back in one copy, the deps unpacked.  Returns (deps
    [rows, T] bool, max_lanes [rows, 5] int32) on the host."""
    t = buffers["live_T"].shape[1]
    packed = packs(buffers)
    query = [torch.from_numpy(a) for a in (
        batch.flat_cols, batch.offsets, batch.before, batch.kind)]
    with span("accord.service.upload"):
        query = [a.to(buffers["live_T"].device) for a in query]
    deps, max_lanes = ragged_consult_t(
        buffers["live_T"], buffers["key_T"], buffers["ts"],
        buffers["txn_id"], buffers["kind"], buffers["status"],
        buffers["active"], *query, packed=packed)
    deps, max_lanes = to_host(deps[:batch.rows], max_lanes[:batch.rows])
    if packed:
        with span("accord.service.unpack"):
            deps = unpack_deps(deps, t)
    return deps, max_lanes


def to_host(deps: torch.Tensor, max_lanes: torch.Tensor
            ) -> Tuple[np.ndarray, np.ndarray]:
    """``ragged_consult_t``'s answer as numpy arrays: the buffer both views
    lie in (``_kernels.consult_out``: the lanes at its start, the deps at
    its end) comes back in one copy and one sync (none for CPU buffers).
    Given the first rows of both views, the copy ends with those rows."""
    with span("accord.kernel.to_host"):
        start = deps.storage_offset() * deps.element_size()
        size = start + deps.numel() * deps.element_size()
        if (deps.untyped_storage().data_ptr()
                != max_lanes.untyped_storage().data_ptr()
                or max_lanes.storage_offset() != 0
                or not deps.is_contiguous() or not max_lanes.is_contiguous()):
            raise ValueError("to_host takes the views of one consult buffer "
                             "(_kernels.consult_out)")
        host = max_lanes.view(torch.uint8).as_strided((size,), (1,)) \
            .cpu().numpy()
        lanes = host[:max_lanes.numel() * 4].view(np.int32)
        out = host[start:]
        if deps.dtype == torch.bool:
            out = out.view(np.bool_)
        return (out.reshape(tuple(deps.shape)),
                lanes.reshape(tuple(max_lanes.shape)))


def unpack_deps(packed_rows: np.ndarray, t: int) -> np.ndarray:
    """Bit-packed deps rows (``[rows, T/8]`` uint8, little-endian) as
    ``[rows, t]`` bool in one fresh array: ``np.unpackbits`` writes bytes
    that are 0 or 1, which are bool as they stand, so they are viewed as
    bool and not converted."""
    return np.unpackbits(packed_rows, axis=1, count=t,
                         bitorder="little").view(np.bool_)
