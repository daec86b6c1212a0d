"""Entry point of the port: the conflict-graph step with example arguments.

The twin of the reference's ``__graft_entry__.entry()``: ``entry()`` returns
the full step (``models.conflict_graph.txn_step``: witness, stabilise and one
execution wave over the device-resident conflict graph) with example
arguments sized for one card, built from the same seeded draws as the
reference's, so both packages step the same state and batch.

    from cassandra_accord_tpu_torch.entry import entry
    fn, args = entry()              # on the card; raises without CUDA
    fn, args = entry(device="cpu")  # on the CPU, when asked for
    state, deps, applied = fn(*args)
"""
import numpy as np
import torch


def _example(T, K, B, device="cuda"):
    from .models import TxnBatch
    from .ops import graph_state as gs
    from .primitives.timestamp import TxnId, TxnKind, Domain

    rng = np.random.default_rng(0)
    state = gs.init_state(T, K, device)
    key_inc = np.zeros((B, K), dtype=np.int8)
    lanes = np.zeros((B, gs.TS_LANES), dtype=np.int32)
    kinds = np.zeros(B, dtype=np.int8)
    for i in range(B):
        key_inc[i, rng.choice(K, 3, replace=False)] = 1
        kind = TxnKind.WRITE if rng.random() < 0.5 else TxnKind.READ
        tid = TxnId(epoch=1, hlc=100 + i, node=1 + int(rng.integers(0, 4)),
                    kind=kind, domain=Domain.KEY)
        lanes[i] = tid.pack_lanes()
        kinds[i] = int(kind)
    dev = state.key_inc.device
    batch = TxnBatch(
        slots=torch.arange(B, dtype=torch.int32, device=dev),
        key_inc=torch.from_numpy(key_inc).to(dev),
        txn_id=torch.from_numpy(lanes).to(dev),
        kind=torch.from_numpy(kinds).to(dev),
        valid=torch.ones((B,), dtype=torch.bool, device=dev))
    return state, batch


def entry(device="cuda"):
    """(fn, example_args) — the forward step on the conflict-graph model, on
    ``device`` (the card unless the caller asks for the CPU)."""
    from .models import txn_step
    state, batch = _example(T=256, K=128, B=64, device=device)
    return txn_step, (state, batch)
