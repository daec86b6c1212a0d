"""Multi-device parallelism for the conflict-graph data plane, one process
per rank over torch.distributed (``launch.run_ranks`` starts them)."""
from .mesh import (
    SHARD, make_mesh, state_specs, batch_specs, shard_state,
    build_sharded_step, build_sharded_closure,
    build_sharded_store_consult, build_sharded_frontier,
)

__all__ = ["SHARD", "make_mesh", "state_specs", "batch_specs", "shard_state",
           "build_sharded_step", "build_sharded_closure",
           "build_sharded_store_consult", "build_sharded_frontier"]
