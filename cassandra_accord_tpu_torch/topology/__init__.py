from .topology import Shard, Topologies, Topology
from .manager import EpochReady, TopologyManager

__all__ = ["Shard", "Topology", "Topologies", "TopologyManager", "EpochReady"]
