"""The lane contract of the device index, in torch.

Timestamps cross the host/device boundary as five non-negative int32 lanes
(epoch, hlc>>31, hlc&0x7FFFFFFF, flags, node) from ``Timestamp.pack_lanes``;
lexicographic order over the lanes equals the host total order, so every
device comparison is a signed int32 compare and lanes never widen.

Only what the consult and frontier paths read is here: the status codes and
``ts_less``.  The rest of the reference's graph state (``ts_next``,
``insert_batch`` and the other batch updates) belongs to the batched
conflict-graph model and is not ported yet.
"""
from __future__ import annotations

import torch

# InternalStatus codes mirrored from ..local.cfk.InternalStatus (kept as plain
# ints here so device code never imports the host control plane).
TRANSITIVELY_KNOWN = 0
PREACCEPTED = 1
ACCEPTED = 2
COMMITTED = 3
STABLE = 4
APPLIED = 5
INVALIDATED = 6

TS_LANES = 5  # (epoch, hlc_hi, hlc_lo, flags, node)


def ts_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over packed-timestamp lanes.

    a, b: [..., 5] int32 (broadcastable).  All lanes are non-negative
    (Timestamp.pack_lanes bounds, enforced at the host boundary) so signed
    compare is safe."""
    lt = a[..., TS_LANES - 1] < b[..., TS_LANES - 1]
    for lane in range(TS_LANES - 2, -1, -1):
        lt = (a[..., lane] < b[..., lane]) | ((a[..., lane] == b[..., lane]) & lt)
    return lt
