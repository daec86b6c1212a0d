"""Frontier-tier dependency-graph kernels over CSR edge lists, in torch.

Port of ``cassandra_accord_tpu/ops/frontier_kernels.py``: the execution
frontier, Kahn levels and SCC condensation as wavefront relaxation over an
edge list (work per round O(E), rounds bounded by graph depth or SCC
diameter), and the host helpers that expand the condensation into the dense
closure / elision twins with a packed-bitset DP in numpy (carried over
unchanged).  An edge (i, j) means txn i depends on (must execute after) txn
j; ``src`` holds i, ``dst`` holds j.  The reference is ``jax.jit`` code, not
Pallas, so these are torch ops on the tensors' device; each
``lax.while_loop`` is a Python loop with the same bounds that reads one flag
back from the device per round (``ROUNDS`` counts the rounds per loop).

The segment reductions are ``scatter_reduce(..., include_self=True)`` into
a vector holding the reduction's identity (0 for ``amax`` over values >= 0,
``t`` for ``amin`` over slot labels).  Padding edges point at slot 0 and
carry ``evalid = False``; torch has no ``mode="drop"``, so their
contribution is masked to that identity before the scatter.

The host wrappers (``*_csr``, ``closure_condensed``) take ``device``: the
card unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .deps_kernels import peel_levels, comp_any
from .graph_state import STABLE, APPLIED, INVALIDATED

# rounds run by each while loop of this module (chip_smoke.py zeroes these
# before a run and reads them after)
ROUNDS: Dict[str, int] = {"kahn_levels": 0, "trim": 0, "extract": 0,
                          "flood": 0, "back_reach": 0, "scc_levels": 0}


def reset_rounds() -> None:
    for name in ROUNDS:
        ROUNDS[name] = 0


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


def _seg_max(index: torch.Tensor, values: torch.Tensor, t: int) -> torch.Tensor:
    """[t] int32: max of ``values`` (>= 0) per ``index``, 0 where none."""
    return torch.zeros((t,), dtype=torch.int32, device=values.device) \
        .scatter_reduce(0, index, values, "amax", include_self=True)


def _seg_min(index: torch.Tensor, values: torch.Tensor, t: int) -> torch.Tensor:
    """[t] int32: min of ``values`` (<= t) per ``index``, t where none."""
    return torch.full((t,), t, dtype=torch.int32, device=values.device) \
        .scatter_reduce(0, index, values, "amin", include_self=True)


def kahn_frontier_edges(src: torch.Tensor, dst: torch.Tensor,
                        evalid: torch.Tensor, status: torch.Tensor,
                        active: torch.Tensor) -> torch.Tensor:
    """Which txns are ready to execute NOW over an edge list: stable, active,
    and every dependency applied/invalidated/evicted.  One edge-parallel
    pass.  Returns [T] bool."""
    dep_done = (status == APPLIED) | (status == INVALIDATED) | ~active
    contrib = (evalid & ~dep_done[dst.long()]).to(torch.int32)
    waiting = _seg_max(src.long(), contrib, status.shape[0]) > 0
    return active & (status == STABLE) & ~waiting


def kahn_levels_edges(src: torch.Tensor, dst: torch.Tensor,
                      evalid: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """``deps_kernels.kahn_levels`` over an edge list: the same rounds (peel
    the zero-blocked wave, one per level), each an O(E) segment max instead
    of a [T, T] product.  Cycle members never peel and keep level -1.
    Returns [T] int32."""
    t = active.shape[0]
    s, d = src.long(), dst.long()
    em = evalid & active[s] & active[d]

    def ready(done):
        ROUNDS["kahn_levels"] += 1
        return _seg_max(s, (em & ~done[d]).to(torch.int32), t) == 0

    return peel_levels(ready, active)


def scc_condense_edges(src: torch.Tensor, dst: torch.Tensor,
                       evalid: torch.Tensor, active: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``deps_kernels.scc_condense`` over an edge list, without ever forming
    reach & reach.T.  Three wavefront phases, as the reference:

    1. TRIM: peel nodes with no in- or no out-edge within the remaining core
       — singleton SCCs labeled by their own slot.
    2. EXTRACT (>= 1 SCC per round): flood the min reachable ancestor label
       forward to fixpoint ("color"); a node whose color is its own index is
       a root, and the nodes of its color class that reach it backward are
       exactly SCC(root).  Labels are the min member slot.
    3. LEVELS: the dense kernel's condensed-component peeling, with the
       per-round reductions as segment ops over the edges.

    Returns (labels [T] int32, -1 on inactive slots; level [T] int32)."""
    t = active.shape[0]
    s, d = src.long(), dst.long()
    idx = torch.arange(t, dtype=torch.int32, device=active.device)
    em = evalid & active[s] & active[d]

    def trim(core):
        while True:
            ROUNDS["trim"] += 1
            e = (em & core[s] & core[d]).to(torch.int32)
            new = core & (_seg_max(s, e, t) > 0) & (_seg_max(d, e, t) > 0)
            if not bool(torch.any(new != core)):
                return new
            core = new

    labels = torch.where(active, idx, -1)    # singletons label themselves
    core = trim(active)
    it = 0
    while it < t and bool(torch.any(core)):
        ROUNDS["extract"] += 1
        e_core = em & core[s] & core[d]
        # forward min-ancestor flood (rounds ~ SCC diameter)
        color = torch.where(core, idx, t)
        while True:
            ROUNDS["flood"] += 1
            new = torch.minimum(color, _seg_min(
                d, torch.where(e_core, color[s], t), t))
            changed = bool(torch.any(new != color))
            color = new
            if not changed:
                break
        # backward reach to each root, restricted to its color class
        same_class = e_core & (color[s] == color[d])
        flag = core & (color == idx)
        while True:
            ROUNDS["back_reach"] += 1
            reach = _seg_max(s, (same_class & flag[d]).to(torch.int32), t) > 0
            new = flag | (core & reach)
            changed = bool(torch.any(new != flag))
            flag = new
            if not changed:
                break
        labels = torch.where(flag, color, labels)
        core = trim(core & ~flag)
        it += 1

    # condensed topological levels — the dense kernel's peeling, edge-parallel
    cond_e = em & (labels[s] != labels[d])

    def ready(done):
        ROUNDS["scc_levels"] += 1
        blocked = _seg_max(s, (cond_e & ~done[d]).to(torch.int32), t) > 0
        # whole components move together
        return ~comp_any(labels, blocked & active & ~done)

    return labels, peel_levels(ready, active)


# ---------------------------------------------------------------------------
# Host wrappers (pow2 buckets; dense-twin signatures for the cross-check)
# ---------------------------------------------------------------------------

def _prep_edges(src, dst, device):
    dev = resolve_device(device)
    s, d, v = _pad_edges(src, dst, _pow2(len(src)))
    return (torch.from_numpy(s).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(v).to(dev))


def _prep(adj, active=None, device="cuda"):
    a = np.asarray(adj)
    t = a.shape[0]
    src, dst = edges_from_dense(a)
    s, d, v = _prep_edges(src, dst, device)
    act = np.ones((t,), dtype=bool) if active is None \
        else np.asarray(active, dtype=bool)
    return t, s, d, v, torch.from_numpy(act).to(s.device)


def kahn_frontier_csr(adj, status, active, device="cuda") -> np.ndarray:
    """Frontier-tier twin of ``deps_kernels.kahn_frontier`` (dense in,
    [T] bool out) — for the cross-check tier and bench."""
    t, s, d, v, act = _prep(adj, active, device)
    st = torch.from_numpy(np.ascontiguousarray(status)).to(s.device)
    return kahn_frontier_edges(s, d, v, st, act).cpu().numpy()


def kahn_levels_csr(adj, active, device="cuda") -> np.ndarray:
    t, s, d, v, act = _prep(adj, active, device)
    return kahn_levels_edges(s, d, v, act).cpu().numpy()


def scc_condense_csr(adj, active,
                     device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    t, s, d, v, act = _prep(adj, active, device)
    labels, level = scc_condense_edges(s, d, v, act)
    return labels.cpu().numpy(), level.cpu().numpy()


def closure_condensed(adj, device="cuda"):
    """The decision-bearing form of the transitive closure: per-node compact
    component index [T], packed component-level reachability [C, ceil(C/8)]
    (uint8, little-endian bits), and the nontrivial-component mask [C].
    ``reach[i, j] == comp_reach[comp[i]] bit comp[j] | (comp[i] == comp[j]
    and nontrivial)`` — ``transitive_closure_csr`` is exactly this view
    expanded dense."""
    return _condensation(np.asarray(adj), device=device)


def _condensation(a: np.ndarray, edges=None, device="cuda"):
    """(per-node compact comp index, packed comp-level reachability,
    nontrivial mask, comp count) for a dense adjacency — the shared
    substrate of ``transitive_closure_csr`` and ``elide_csr``.

    Comp-level reachability is a level-synchronous packed-bitset DP over the
    condensation DAG on the host: processing components dep-first
    (increasing Kahn level), each component's row is the OR of (dep's bit |
    dep's row) over its out-edges."""
    n = a.shape[0]
    if edges is None:
        edges = edges_from_dense(a)
    src, dst = edges
    s, d, v = _prep_edges(src, dst, device)
    labels, _ = scc_condense_edges(
        s, d, v, torch.ones((n,), dtype=torch.bool, device=s.device))
    comp_of = labels.cpu().numpy().astype(np.int64)  # label = min member slot
    comp_ids, node_comp = np.unique(comp_of, return_inverse=True)
    c = len(comp_ids)
    csrc, cdst = node_comp[src], node_comp[dst]
    # nontrivial component: >= 2 members, or a self-loop member
    sizes = np.bincount(node_comp, minlength=c)
    nontrivial = sizes > 1
    self_loops = csrc[src == dst]
    nontrivial[self_loops] = True
    # condensation edges (deduped)
    cross = csrc != cdst
    if cross.any():
        ce = np.unique(np.stack([csrc[cross], cdst[cross]], axis=1), axis=0)
        ce_src, ce_dst = ce[:, 0].astype(np.int32), ce[:, 1].astype(np.int32)
    else:
        ce_src = ce_dst = np.zeros((0,), dtype=np.int32)
    # dep-first order over the (acyclic) condensation
    cadj_levels = np.zeros((c,), dtype=np.int64)
    if len(ce_src):
        s, d, v = _prep_edges(ce_src, ce_dst, device)
        cadj_levels = kahn_levels_edges(
            s, d, v, torch.ones((c,), dtype=torch.bool, device=s.device)
        ).cpu().numpy().astype(np.int64)
    words = (c + 7) // 8
    reach_p = np.zeros((c, words), dtype=np.uint8)
    if len(ce_src):
        bit = np.zeros((c, words), dtype=np.uint8)
        bit[np.arange(c), np.arange(c) // 8] = 1 << (np.arange(c) % 8)
        order = np.argsort(ce_src, kind="stable")
        e_src, e_dst = ce_src[order], ce_dst[order]
        lev_of_edge = cadj_levels[e_src]
        for lv in np.unique(lev_of_edge):
            sel = lev_of_edge == lv
            s_lv, d_lv = e_src[sel], e_dst[sel]
            rows = reach_p[d_lv] | bit[d_lv]          # dep's row | dep's bit
            starts = np.flatnonzero(np.diff(s_lv, prepend=-1))
            merged = np.bitwise_or.reduceat(rows, starts, axis=0)
            reach_p[s_lv[starts]] |= merged
    return node_comp, reach_p, nontrivial, c


def _unpack_cols(packed: np.ndarray, c: int) -> np.ndarray:
    return np.unpackbits(packed, axis=1, bitorder="little")[:, :c].astype(bool)


def transitive_closure_csr(adj, device="cuda") -> np.ndarray:
    """Frontier-tier twin of ``deps_kernels.transitive_closure``: SCC
    condensation + packed-bitset DP over the condensation DAG, expanded back
    to a dense [T, T] bool reach matrix.  Bit-identical to the dense kernel
    on any graph (cycles included): reach[i, j] iff comp(i) reaches comp(j)
    in the condensation, or they share a nontrivial component."""
    a = np.asarray(adj) != 0
    node_comp, reach_p, nontrivial, c = _condensation(a, device=device)
    comp_reach = _unpack_cols(reach_p, c)            # [C, C]
    comp_reach[np.arange(c), np.arange(c)] |= nontrivial
    return comp_reach[np.ix_(node_comp, node_comp)]


def elide_csr(adj, device="cuda") -> np.ndarray:
    """Frontier-tier twin of ``deps_kernels.elide`` (transitive reduction,
    cycle edges kept).  An edge (i, j) is implied iff some dependency k of i
    reaches j — evaluated per EDGE against the packed component reachability
    rows, never as the dense a @ reach product."""
    a = np.asarray(adj) != 0
    n = a.shape[0]
    src, dst = edges_from_dense(a)
    if not len(src):
        resolve_device(device)
        return np.zeros_like(a)
    node_comp, reach_p, nontrivial, c = _condensation(a, edges=(src, dst),
                                                      device=device)
    words = reach_p.shape[1]
    bit = np.zeros((c, words), dtype=np.uint8)
    bit[np.arange(c), np.arange(c) // 8] = 1 << (np.arange(c) % 8)
    # reach*[k] row = comps reachable from k with >= 1 step (incl. own comp
    # when nontrivial)
    star = reach_p | np.where(nontrivial[:, None], bit, 0)
    # implied rows per node: OR of star[comp(k)] over i's dep edges (i, k)
    order = np.argsort(src, kind="stable")
    e_src, e_dst = src[order], dst[order]
    rows = star[node_comp[e_dst]]                    # [E, words]
    starts = np.flatnonzero(np.diff(e_src, prepend=-1))
    implied_p = np.zeros((n, words), dtype=np.uint8)
    implied_p[e_src[starts]] = np.bitwise_or.reduceat(rows, starts, axis=0)
    # per-edge verdict
    cj = node_comp[dst]
    implied_edge = (implied_p[src, cj // 8] >> (cj % 8).astype(np.uint8)) & 1
    in_cycle = (node_comp[src] == cj) & nontrivial[cj]
    keep = (implied_edge == 0) | in_cycle
    out = np.zeros_like(a)
    out[src[keep], dst[keep]] = True
    return out


# ---------------------------------------------------------------------------
# Resolver frontier entry (dict-of-edges ingress, no dense matrix ever)
# ---------------------------------------------------------------------------

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
