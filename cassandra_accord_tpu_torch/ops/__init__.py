"""Device data plane in torch: the consult kernels and the release frontier.

Timestamps cross the host<->device boundary as five non-negative int32 lanes
(Timestamp.pack_lanes) whose lexicographic order equals the host total
order.  Importing this package builds nothing: the CUDA kernels compile at
their first launch (``_kernels.build``).
"""
from .graph_state import ts_less, TS_LANES
from .deps_kernels import (
    WITNESSES, overlap_join, max_conflict_keys, consult, consult_packed,
)
from .pallas_join import overlap_join_fused
from .frontier_kernels import (
    edges_from_dense, kahn_frontier_edges, frontier_ready_from_edges,
)

__all__ = [
    "ts_less", "TS_LANES",
    "WITNESSES", "overlap_join", "max_conflict_keys", "consult",
    "consult_packed", "overlap_join_fused",
    "edges_from_dense", "kahn_frontier_edges", "frontier_ready_from_edges",
]
