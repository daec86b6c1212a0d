"""The execution frontier over CSR edge lists, in torch.

Port of ``cassandra_accord_tpu/ops/frontier_kernels.py`` :49-86 and
:407-425: the command-store release path that
``TpuDepsResolver.frontier_ready`` runs under ``frontier_exec``.  An edge
(i, j) means txn i depends on (must execute after) txn j; ``src`` holds i,
``dst`` holds j.  The reference is ``jax.jit`` code, not Pallas, so these
are torch ops on the tensors' device.

The segment max is ``scatter_reduce(..., "amax", include_self=True)`` over
a zero-initialised int32 vector.  Padding edges point at slot 0 and carry
``evalid = False``; torch has no ``mode="drop"``, so their contribution is
masked to 0 before the scatter (0 is the identity of the max over >= 0).
The kahn-levels and SCC kernels of the reference are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from .graph_state import STABLE, APPLIED, INVALIDATED


def edges_from_dense(adj) -> Tuple[np.ndarray, np.ndarray]:
    """Dense [T, T] adjacency -> (src, dst) int32 edge lists (host)."""
    src, dst = np.nonzero(np.asarray(adj))
    return src.astype(np.int32), dst.astype(np.int32)


def _pow2(n: int, floor: int = 8) -> int:
    return 1 << max(floor.bit_length() - 1, (max(1, n) - 1).bit_length())


def _pad_edges(src: np.ndarray, dst: np.ndarray,
               e_pad: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad edge lists to a pow2 bucket with a validity mask; padding edges
    point at slot 0 and are masked out of every reduction."""
    e = len(src)
    valid = np.zeros((e_pad,), dtype=bool)
    valid[:e] = True
    s = np.zeros((e_pad,), dtype=np.int32)
    d = np.zeros((e_pad,), dtype=np.int32)
    s[:e] = src
    d[:e] = dst
    return s, d, valid


def kahn_frontier_edges(src: torch.Tensor, dst: torch.Tensor,
                        evalid: torch.Tensor, status: torch.Tensor,
                        active: torch.Tensor) -> torch.Tensor:
    """Which txns are ready to execute NOW over an edge list: stable, active,
    and every dependency applied/invalidated/evicted.  One edge-parallel
    pass.  Returns [T] bool."""
    dep_done = (status == APPLIED) | (status == INVALIDATED) | ~active
    contrib = (evalid & ~dep_done[dst.long()]).to(torch.int32)
    waiting = torch.zeros(status.shape, dtype=torch.int32,
                          device=status.device).scatter_reduce(
        0, src.long(), contrib, "amax", include_self=True) > 0
    return active & (status == STABLE) & ~waiting


def frontier_ready_from_edges(edge_src: np.ndarray, edge_dst: np.ndarray,
                              status: np.ndarray, active: np.ndarray,
                              device="cuda") -> np.ndarray:
    """The command-store release path: compacted wait-graph edge arrays in,
    ready mask out, computed on ``device`` (the card unless the caller asks
    for the CPU).  Padded to pow2 buckets on (E, T) like the reference.
    [T] bool."""
    dev = resolve_device(device)
    t = len(status)
    t_pad = _pow2(t)
    e_pad = _pow2(len(edge_src))
    s, d, v = _pad_edges(edge_src.astype(np.int32), edge_dst.astype(np.int32),
                         e_pad)
    st = np.zeros((t_pad,), dtype=status.dtype)
    ac = np.zeros((t_pad,), dtype=bool)
    st[:t] = status
    ac[:t] = active
    ready = kahn_frontier_edges(
        torch.from_numpy(s).to(dev), torch.from_numpy(d).to(dev),
        torch.from_numpy(v).to(dev), torch.from_numpy(st).to(dev),
        torch.from_numpy(ac).to(dev)).cpu().numpy()
    return ready[:t]
