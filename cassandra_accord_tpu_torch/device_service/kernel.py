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

K1 (``deps_join``) answers the deps half and K2 (``max_conflict``) the max
half: the CUDA kernels for CUDA buffers (the CSR or the dense form, by
``_kernels.join_form`` from the window's sizes unless ``form`` says),
their plain torch versions (which densify the query with an int32
scatter-add) for CPU buffers.  With
``packed`` the deps mask comes back bit-packed ``[B, T/8]`` uint8,
little-endian.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops import _kernels


def ragged_consult_t(live_T, key_T, ts, txn_id, kind, status, active,
                     flat_cols, offsets, before, qkind,
                     packed: bool = False, form: str = "auto"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(deps [B, T] bool or [B, T/8] uint8, max_lanes [B, 5] int32)."""
    deps = _kernels.deps_join(live_T, txn_id, kind, status, active, offsets,
                              flat_cols, before, qkind, packed=packed,
                              form=form)
    max_lanes = _kernels.max_conflict(key_T, ts, txn_id, active, offsets,
                                      flat_cols, form=form)
    return deps, max_lanes
