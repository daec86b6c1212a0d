"""Device data plane in torch: conflict-graph state, the consult kernels, the
closure/SCC/Kahn graph ops and the edge-frontier tier.

Timestamps cross the host<->device boundary as five non-negative int32 lanes
(Timestamp.pack_lanes) whose lexicographic order equals the host total
order.  Importing this package builds nothing: the CUDA kernels compile at
their first launch (``_kernels.build``).
"""
from .graph_state import (
    GraphState, init_state, insert_batch, set_status_batch,
    set_execute_at_batch, evict_mask, ts_less, to_host_deps, adj_edges,
    TS_LANES, state_from_numpy, state_to_numpy,
)
from .deps_kernels import (
    WITNESSES, overlap_join, max_conflict_keys, consult, consult_packed,
    max_conflict_ts, transitive_closure, elide, kahn_frontier, kahn_levels,
    scc_condense,
)
from .pallas_join import overlap_join_fused
from .frontier_kernels import (
    edges_from_dense, kahn_frontier_edges, kahn_levels_edges,
    scc_condense_edges, kahn_frontier_csr, kahn_levels_csr, scc_condense_csr,
    transitive_closure_csr, elide_csr, closure_condensed,
    frontier_ready_from_edges,
)

__all__ = [
    "GraphState", "init_state", "insert_batch", "set_status_batch",
    "set_execute_at_batch", "evict_mask", "ts_less", "to_host_deps",
    "adj_edges", "TS_LANES", "state_from_numpy", "state_to_numpy",
    "WITNESSES", "overlap_join", "max_conflict_keys", "consult",
    "consult_packed", "max_conflict_ts", "transitive_closure", "elide",
    "kahn_frontier", "kahn_levels", "scc_condense", "overlap_join_fused",
    "edges_from_dense", "kahn_frontier_edges", "kahn_levels_edges",
    "scc_condense_edges", "kahn_frontier_csr", "kahn_levels_csr",
    "scc_condense_csr", "transitive_closure_csr", "elide_csr",
    "closure_condensed", "frontier_ready_from_edges",
]
