"""The ragged batch-ingress contract: flat keys + row offsets + txn-id rows.

Per-txn consult key sets are RAGGED — a PreAccept touches 1-3 keys, a range
txn hundreds — and the device wants fixed shapes.  This module is the shared
wire format between everything that produces consult batches (the resolver's
delivery-window prefetch today, the columnar protocol batches of ROADMAP
item 2 tomorrow) and the device service that consumes them:

- ``flat_cols``  [N]   int32 — every row's key-slot columns, concatenated;
- ``offsets``    [B+1] int32 — row i occupies flat_cols[offsets[i]:offsets[i+1]]
                               (empty rows are legal: offsets[i] == offsets[i+1]);
- ``before``     [B,5] int32 — per-row started-before bound (packed lanes);
- ``kind``       [B]   int8  — per-row querying-txn kind code;
- ``txn_rows``   [B,5] int32 — per-row querying TxnId lanes (zero = none).
                               RESERVED for the columnar protocol batches of
                               ROADMAP item 2 (on-device self-exclusion /
                               attribution); the current kernel does not read
                               it — attribution happens host-side.

This is the same flattened-tokens + row-offsets shape ragged paged attention
uses for variable-length sequences (PAPERS: "Ragged Paged Attention"): the
ragged dimension rides in ONE dense vector and the row structure in a small
offsets vector, so a single kernel serves every mixture of row widths.

Shape discipline (the jit-stability contract): both the row count B and the
flat length N pad UP to power-of-two buckets with a floor and a cap, so a
steady-state workload compiles O(log(max_rows) * log(max_flat)) kernel
variants TOTAL, not one per window size (the r05 replay failure mode).
Padding rows have offsets[i] == offsets[i+1] (width 0) and a saturated
started-before of 0, so they match nothing; padding flat elements carry
weight 0 and scatter nowhere.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

TS_LANES = 5

# bucket floors keep tiny windows from compiling one kernel per size 1..8;
# caps keep one window from compiling unboundedly wide shapes — a window
# larger than the cap splits into multiple dispatches of capped shape
ROW_BUCKET_FLOOR = 8
FLAT_BUCKET_FLOOR = 16


def pow2_bucket(n: int, floor: int, cap: Optional[int] = None) -> int:
    """The power-of-two shape bucket for ``n`` elements (>= floor, <= cap)."""
    b = max(floor, 1 << max(0, n - 1).bit_length())
    return min(b, cap) if cap is not None else b


class ConsultBatch:
    """One ragged consult batch, padded to jit-stable bucket shapes.

    ``rows`` is the REAL row count (pre-padding); arrays are bucket-shaped.
    ``row_ids``/``weights`` are the scatter companions of ``flat_cols``:
    element j lands in dense row ``row_ids[j]`` with weight ``weights[j]``
    (0 for padding, so padding scatters no incidence)."""

    __slots__ = ("rows", "flat", "flat_cols", "row_ids", "weights",
                 "offsets", "before", "kind", "txn_rows")

    def __init__(self, rows: int, flat: int, flat_cols: np.ndarray,
                 row_ids: np.ndarray, weights: np.ndarray,
                 offsets: np.ndarray, before: np.ndarray, kind: np.ndarray,
                 txn_rows: np.ndarray):
        self.rows = rows
        self.flat = flat
        self.flat_cols = flat_cols
        self.row_ids = row_ids
        self.weights = weights
        self.offsets = offsets
        self.before = before
        self.kind = kind
        self.txn_rows = txn_rows

    @property
    def shape_signature(self) -> Tuple[int, int]:
        """(row bucket, flat bucket) — the jit compile key of this batch."""
        return (self.before.shape[0], self.flat_cols.shape[0])

    def densify(self, k: int) -> np.ndarray:
        """The dense [rows, K] int8 key mask (host fallback / parity checks).
        Duplicate columns in a row collapse to 1, exactly as the device
        scatter's >0 consumption does."""
        q = np.zeros((self.rows, k), dtype=np.int8)
        for j in range(self.flat):
            if self.weights[j]:
                q[self.row_ids[j], self.flat_cols[j]] = 1
        return q


def build_batch(row_cols: Sequence[Sequence[int]],
                before_lanes: Sequence[Tuple[int, ...]],
                kind_codes: Sequence[int],
                txn_lanes: Optional[Sequence[Optional[Tuple[int, ...]]]] = None,
                row_cap: Optional[int] = None,
                flat_cap: Optional[int] = None) -> ConsultBatch:
    """Pack ragged per-row key-slot column lists into one ConsultBatch.

    Empty rows, duplicate columns within a row, and max-width rows are all
    legal; callers cap rows per batch BEFORE building (the window splits),
    so ``row_cap``/``flat_cap`` only bound the padding buckets."""
    b = len(row_cols)
    n = sum(len(c) for c in row_cols)
    b_pad = pow2_bucket(b, ROW_BUCKET_FLOOR, row_cap)
    n_pad = pow2_bucket(max(n, 1), FLAT_BUCKET_FLOOR, flat_cap)
    if b > b_pad or n > n_pad:
        raise ValueError(f"batch exceeds its shape cap: rows {b}>{b_pad} "
                         f"or flat {n}>{n_pad} — split before building")
    flat_cols = np.zeros((n_pad,), dtype=np.int32)
    row_ids = np.zeros((n_pad,), dtype=np.int32)
    weights = np.zeros((n_pad,), dtype=np.int8)
    offsets = np.zeros((b_pad + 1,), dtype=np.int32)
    before = np.zeros((b_pad, TS_LANES), dtype=np.int32)
    kind = np.zeros((b_pad,), dtype=np.int8)
    txn_rows = np.zeros((b_pad, TS_LANES), dtype=np.int32)
    at = 0
    for i, cols in enumerate(row_cols):
        offsets[i] = at
        for c in cols:
            flat_cols[at] = c
            row_ids[at] = i
            weights[at] = 1
            at += 1
        before[i] = before_lanes[i]
        kind[i] = kind_codes[i]
        if txn_lanes is not None and txn_lanes[i] is not None:
            txn_rows[i] = txn_lanes[i]
    offsets[b:] = at   # real tail + every padding row: width 0
    return ConsultBatch(b, n, flat_cols, row_ids, weights, offsets,
                        before, kind, txn_rows)


def split_rows(items: List, row_cap: int) -> List[List]:
    """Split a window's items into row_cap-bounded chunks (shape-cap policy:
    an oversized window becomes several capped dispatches, never a new jit
    shape)."""
    return [items[i:i + row_cap] for i in range(0, max(len(items), 1), row_cap)] \
        if items else []
