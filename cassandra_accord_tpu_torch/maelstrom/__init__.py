"""Maelstrom (Jepsen workbench) adapter: JSON codec for all wire types, stdio
node binary, and an in-process simulator with partitions (accord-maelstrom)."""
from . import codec
from .node import MaelstromNode, TopologyFactory, parse_txn
from .runner import MaelstromCluster, run_workload

__all__ = ["codec", "MaelstromNode", "TopologyFactory", "parse_txn",
           "MaelstromCluster", "run_workload"]
