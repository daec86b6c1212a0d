"""Device-resident "models": tensor-tuple state + step pipelines."""
from .conflict_graph import (
    TxnBatch, preaccept_step, stabilise_step, execute_step, gc_step, txn_step, txn_step_scan,
)

__all__ = ["TxnBatch", "preaccept_step", "stabilise_step", "execute_step",
           "gc_step", "txn_step", "txn_step_scan"]
