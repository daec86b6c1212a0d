"""The fused key-overlap join + predicate: the port of the TPU join kernel.

The reference (``cassandra_accord_tpu/ops/pallas_join.py``) hand-fused the
started-before x witness x eligible mask into the epilogue of a Pallas
matmul kernel (``_join_kernel``, launched at :61), with the predicate built
outside as a [B, T] f32 mask.  Here the entry point takes the [T, K] route
of ``deps_kernels._consult``: the dense kernel on the [T, K] index as given
(``_kernels.deps_join_tk``, csrc/dense_join_tk.cu: the Pallas kernel's own
operand layout, the product on the tensor cores with the predicate,
evaluated from the lane, kind, status and active vectors, fused in its
epilogue, so no [B, T] mask is built) unless ``_kernels.tk_refusal``
refuses it, else the transposed index and a CSR query through K1
(``_kernels.deps_join``); the plain torch versions run for CPU tensors.  A
drop-in for ``deps_kernels.overlap_join``.
"""
from __future__ import annotations

import torch

from .deps_kernels import _consult


def overlap_join_fused(index_key_inc: torch.Tensor,   # [T, K] int8
                       index_txn_id: torch.Tensor,    # [T, 5] int32
                       index_kind: torch.Tensor,      # [T] int8
                       index_status: torch.Tensor,    # [T] int8
                       index_active: torch.Tensor,    # [T] bool
                       batch_key_inc: torch.Tensor,   # [B, K] int8
                       batch_txn_id: torch.Tensor,    # [B, 5] int32
                       batch_kind: torch.Tensor,      # [B] int8
                       ) -> torch.Tensor:
    """Drop-in for deps_kernels.overlap_join through kernel K1.
    Returns [B, T] bool."""
    return _consult(index_key_inc, None, None, index_txn_id, index_kind,
                    index_status, index_active, batch_key_inc, batch_txn_id,
                    batch_kind)[0]
