"""The consult half of the batched dependency kernels, in torch.

Port of ``cassandra_accord_tpu/ops/deps_kernels.py`` :45-221 with the same
public signatures: ``[T, K]`` int8 index incidence, ``[B, K]`` int8 query
incidence, ``[*, 5]`` int32 timestamp lanes.

- ``overlap_join``      <- ``CommandsForKey.mapReduceActive`` per-key scans
                          (cfk/CommandsForKey.java:925-1000) + KeyDeps
                          builder merges: every in-flight txn a new txn must
                          depend on (shares a key, witness hit, active, not
                          invalidated, started before the bound).
- ``max_conflict_keys`` <- the per-key MaxConflicts consult of the replica
                          timestamp proposal (MaxConflicts.java:32).
- ``consult``/``consult_packed`` <- both halves fused per query batch.

Inside, each function converts to the kernels' layout — the incidence
transposed to ``[K, T]`` uint8, the query to CSR — and calls kernel K1
(``_kernels.deps_join``) and/or K2 (``_kernels.max_conflict``).  On CPU
tensors those wrappers run their plain torch versions; on CUDA tensors the
hand-written kernels (csrc/consult.cu).  The closure, elision, Kahn-level
and SCC kernels of the reference are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels
from ._kernels import lex_max_masked as _lex_max_masked  # noqa: F401
from ._kernels import witness_table as _witness_table

WITNESSES = torch.as_tensor(_witness_table())


def incidence_T(inc: torch.Tensor) -> torch.Tensor:
    """[T, K] 0/1 incidence -> the kernels' [K, T] uint8 layout."""
    return (inc != 0).to(torch.uint8).t().contiguous()


def query_csr(batch_key_inc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense [B, K] 0/1 query -> CSR (offsets [B+1], cols [N]) int32 over
    its nonzero entries, row-major."""
    b = batch_key_inc.shape[0]
    nz = torch.nonzero(batch_key_inc != 0)                          # [N, 2]
    counts = torch.bincount(nz[:, 0], minlength=b)
    offsets = torch.zeros((b + 1,), dtype=torch.int32,
                          device=batch_key_inc.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets, nz[:, 1].to(torch.int32).contiguous()


def _i8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int8).contiguous()


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _bool(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bool).contiguous()


def _join(inc_T, index_txn_id, index_kind, index_status, index_active,
          batch_key_inc, batch_before, batch_kind, packed=False):
    offsets, cols = query_csr(batch_key_inc)
    return _kernels.deps_join(
        inc_T, _i32(index_txn_id), _i8(index_kind), _i8(index_status),
        _bool(index_active), offsets, cols, _i32(batch_before),
        _i8(batch_kind), packed=packed)


def overlap_join(index_key_inc: torch.Tensor,   # [T, K] int8 — in-flight txns
                 index_txn_id: torch.Tensor,    # [T, 5] int32 — their TxnIds
                 index_kind: torch.Tensor,      # [T] int8
                 index_status: torch.Tensor,    # [T] int8
                 index_active: torch.Tensor,    # [T] bool
                 batch_key_inc: torch.Tensor,   # [B, K] int8 — new txns' keys
                 batch_before: torch.Tensor,    # [B, 5] int32 — started-before bound
                 batch_kind: torch.Tensor,      # [B] int8
                 ) -> torch.Tensor:
    """For each of B new transactions, the set of in-flight txns it must
    depend on: shares >=1 key, witness-matrix hit, active, not invalidated,
    and STARTED BEFORE the query bound (mapReduceActive's
    TestStartedAt.STARTED_BEFORE, SafeCommandStore.java:65-72).

    Returns deps: [B, T] bool."""
    return _join(incidence_T(index_key_inc), index_txn_id, index_kind,
                 index_status, index_active, batch_key_inc, batch_before,
                 batch_kind)


def max_conflict_keys(index_key_inc: torch.Tensor,  # [T, K] int8
                      index_ts: torch.Tensor,       # [T, 5] int32 executeAt
                      index_txn_id: torch.Tensor,   # [T, 5] int32
                      index_active: torch.Tensor,   # [T] bool
                      batch_key_inc: torch.Tensor,  # [B, K] int8
                      ) -> torch.Tensor:
    """Per query, the lexicographic max of max(executeAt, txnId) over every
    active indexed txn sharing a key.  Returns [B, 5] int32 (zero lanes =
    none)."""
    offsets, cols = query_csr(batch_key_inc)
    return _kernels.max_conflict(
        incidence_T(index_key_inc), _i32(index_ts), _i32(index_txn_id),
        _bool(index_active), offsets, cols)


def _consult(index_live_inc, index_key_inc, index_ts, index_txn_id,
             index_kind, index_status, index_active, batch_key_inc,
             batch_before, batch_kind, packed):
    offsets, cols = query_csr(batch_key_inc)
    deps = _kernels.deps_join(
        incidence_T(index_live_inc), _i32(index_txn_id), _i8(index_kind),
        _i8(index_status), _bool(index_active), offsets, cols,
        _i32(batch_before), _i8(batch_kind), packed=packed)
    max_lanes = _kernels.max_conflict(
        incidence_T(index_key_inc), _i32(index_ts), _i32(index_txn_id),
        _bool(index_active), offsets, cols)
    return deps, max_lanes


def consult(index_live_inc: torch.Tensor,  # [T, K] int8 — covered bits zeroed
            index_key_inc: torch.Tensor,   # [T, K] int8 — full incidence
            index_ts: torch.Tensor,        # [T, 5] int32 executeAt
            index_txn_id: torch.Tensor,    # [T, 5] int32
            index_kind: torch.Tensor,      # [T] int8
            index_status: torch.Tensor,    # [T] int8
            index_active: torch.Tensor,    # [T] bool
            batch_key_inc: torch.Tensor,   # [B, K] int8
            batch_before: torch.Tensor,    # [B, 5] int32
            batch_kind: torch.Tensor,      # [B] int8
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused replica consult: the dependency calculation over the LIVE
    incidence (covered bits implement cfk transitive elision,
    CommandsForKey.java:144-157) and the timestamp-proposal max over the
    FULL incidence (elision never applies to MaxConflicts).

    Returns (deps [B, T] bool, max_lanes [B, 5] int32)."""
    return _consult(index_live_inc, index_key_inc, index_ts, index_txn_id,
                    index_kind, index_status, index_active, batch_key_inc,
                    batch_before, batch_kind, packed=False)


def consult_packed(index_live_inc: torch.Tensor, index_key_inc: torch.Tensor,
                   index_ts: torch.Tensor, index_txn_id: torch.Tensor,
                   index_kind: torch.Tensor, index_status: torch.Tensor,
                   index_active: torch.Tensor, batch_key_inc: torch.Tensor,
                   batch_before: torch.Tensor, batch_kind: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``consult`` with the deps mask BIT-PACKED ([B, T/8] uint8,
    little-endian bit order, T a multiple of 8): the [B, T] bool result is
    8x larger than the answer it carries, and at T = 64k it is most of what
    crosses back to the host.  Hosts unpack with np.unpackbits."""
    return _consult(index_live_inc, index_key_inc, index_ts, index_txn_id,
                    index_kind, index_status, index_active, batch_key_inc,
                    batch_before, batch_kind, packed=True)
