"""TxnBatch — struct-of-arrays columnar layout over command-store hot state.

One row per resident command; parallel numpy columns carry the fields the
protocol's hot scans read:

- ``tid``      [C,3] int64 — TxnId order lanes (see ``pack_order_lanes``);
- ``ea``       [C,3] int64 — executeAt order lanes (valid iff HAS_EA flag);
- ``ballot``   [C,3] int64 — promised-ballot lanes as of the last recorded
                             transition (layout/ingress attribution only —
                             ballots can move WITHOUT a status transition
                             (recovery promises), so decisions never read
                             this column);
- ``status``   [C]   int16 — SaveStatus ordinal;
- ``flags``    [C]   uint8 — TRUNCATED / AWAITS_ONLY / HAS_EA /
                             PRE_COMMITTED / IS_WRITE bits;
- ``waiting``  [C]   int32 — WaitingOn frontier width (deps row pointer
                             count; informational — release decisions read
                             the live WaitingOn, never this column);
- key-set CSR: per-row key-slot column lists (``key_rows``), the offsets
  half of the ragged flat-cols + offsets + txn-rows ``ConsultBatch``
  ingress contract (device_service/batch.py) that
  ``to_consult_batch`` packs into pow2-bucketed batch shapes.

Order-lane packing: a Timestamp orders by (epoch, hlc, flags, node).
Three int64 lanes — (epoch, hlc, flags<<32|node) — compare lexicographically
in exactly that order (epoch <= 2^48, hlc <= 2^63-1, flags <= 2^16,
node <= 2^32-1 all fit), so numpy lane compares agree bit-for-bit with
``Timestamp.__lt__``.

Capacity grows in power-of-two buckets (the same shape discipline as the
device service) so steady-state mirrors never re-allocate per txn.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..local.status import Status
from ..primitives.timestamp import Timestamp, TxnId

TS_ORDER_LANES = 3

# flags bits
F_TRUNCATED = 1 << 0      # save_status.is_truncated
F_AWAITS_ONLY = 1 << 1    # txn_id.kind.awaits_only_deps (sync points / eph reads)
F_HAS_EA = 1 << 2         # execute_at is not None
F_PRE_COMMITTED = 1 << 3  # has_been(Status.PRE_COMMITTED)
F_IS_WRITE = 1 << 4       # txn_id.is_write

_MIN_CAP = 64

# vectorization engagement floor: below this many rows the scalar loops
# beat the batched passes' fixed cost (microbenchmarked crossover; the
# release/frontier masks win 5-10x from ~2x this size up).  Shared by every
# engagement site (notify_listeners, initialise_waiting_on, _poll_in_store).
ENGAGE_FLOOR = 16


def pack_order_lanes(ts: Timestamp) -> Tuple[int, int, int]:
    """The 3-lane int64 order key of a Timestamp/TxnId/Ballot: lexicographic
    compare over the lanes == the host total order (epoch, hlc, flags, node)."""
    return (ts.epoch, ts.hlc, (ts.flags << 32) | ts.node)


def lanes_lt(a: np.ndarray, b_lanes: Tuple[int, int, int]) -> np.ndarray:
    """Vector ``a[i] < b`` over [N,3] order-lane rows (lexicographic)."""
    b0, b1, b2 = b_lanes
    return (a[:, 0] < b0) | ((a[:, 0] == b0) & (
        (a[:, 1] < b1) | ((a[:, 1] == b1) & (a[:, 2] < b2))))


def lanes_le(a: np.ndarray, b_lanes: Tuple[int, int, int]) -> np.ndarray:
    """Vector ``a[i] <= b`` (lexicographic)."""
    b0, b1, b2 = b_lanes
    return (a[:, 0] < b0) | ((a[:, 0] == b0) & (
        (a[:, 1] < b1) | ((a[:, 1] == b1) & (a[:, 2] <= b2))))


class TxnBatch:
    """The SoA mirror of one store's resident commands."""

    __slots__ = ("cap", "slot_of", "free", "tid", "ea", "ballot", "status",
                 "flags", "kind", "waiting", "key_rows")

    def __init__(self, cap: int = _MIN_CAP):
        self.cap = cap
        self.slot_of: Dict[TxnId, int] = {}
        self.free: List[int] = list(range(cap - 1, -1, -1))
        self.tid = np.zeros((cap, TS_ORDER_LANES), dtype=np.int64)
        self.ea = np.zeros((cap, TS_ORDER_LANES), dtype=np.int64)
        self.ballot = np.zeros((cap, TS_ORDER_LANES), dtype=np.int64)
        self.status = np.zeros((cap,), dtype=np.int16)
        self.flags = np.zeros((cap,), dtype=np.uint8)
        self.kind = np.zeros((cap,), dtype=np.int8)
        self.waiting = np.zeros((cap,), dtype=np.int32)
        # deps/key row pointers: per-row key-slot column list (CSR rows for
        # the ConsultBatch ingress; plain lists — they are rebuilt per
        # registration, not per query)
        self.key_rows: Dict[int, Tuple[int, ...]] = {}

    def __len__(self) -> int:
        return len(self.slot_of)

    # -- growth --------------------------------------------------------------
    def _grow(self) -> None:
        new_cap = self.cap * 2
        for name in ("tid", "ea", "ballot"):
            arr = getattr(self, name)
            wide = np.zeros((new_cap, TS_ORDER_LANES), dtype=np.int64)
            wide[: self.cap] = arr
            setattr(self, name, wide)
        for name, dt in (("status", np.int16), ("flags", np.uint8),
                         ("kind", np.int8), ("waiting", np.int32)):
            arr = getattr(self, name)
            wide = np.zeros((new_cap,), dtype=dt)
            wide[: self.cap] = arr
            setattr(self, name, wide)
        self.free.extend(range(new_cap - 1, self.cap - 1, -1))
        self.cap = new_cap

    # -- row lifecycle -------------------------------------------------------
    def ensure(self, txn_id: TxnId) -> int:
        row = self.slot_of.get(txn_id)
        if row is not None:
            return row
        if not self.free:
            self._grow()
        row = self.free.pop()
        self.slot_of[txn_id] = row
        self.tid[row] = pack_order_lanes(txn_id)
        self.ea[row] = 0
        self.ballot[row] = 0
        self.status[row] = 0
        self.waiting[row] = 0
        self.kind[row] = int(txn_id.kind)
        flags = 0
        if txn_id.kind.awaits_only_deps:
            flags |= F_AWAITS_ONLY
        if txn_id.is_write:
            flags |= F_IS_WRITE
        self.flags[row] = flags
        return row

    def update_from(self, cmd) -> int:
        """Refresh a command's row from its live state (the transition choke
        point).  Pure mirror write: reads only fields the transition already
        settled."""
        row = self.ensure(cmd.txn_id)
        ss = cmd.save_status
        self.status[row] = ss.ordinal
        flags = int(self.flags[row]) & (F_AWAITS_ONLY | F_IS_WRITE)
        if ss.is_truncated:
            flags |= F_TRUNCATED
        if ss.has_been(Status.PRE_COMMITTED):
            flags |= F_PRE_COMMITTED
        if cmd.execute_at is not None:
            flags |= F_HAS_EA
            self.ea[row] = pack_order_lanes(cmd.execute_at)
        self.flags[row] = flags
        self.ballot[row] = pack_order_lanes(cmd.promised)
        w = cmd.waiting_on
        self.waiting[row] = len(w.waiting) if w is not None else 0
        return row

    def drop(self, txn_id: TxnId) -> None:
        row = self.slot_of.pop(txn_id, None)
        if row is not None:
            self.status[row] = 0
            self.flags[row] = 0
            self.waiting[row] = 0
            self.key_rows.pop(row, None)
            self.free.append(row)

    def set_keys(self, txn_id: TxnId, key_slots: Sequence[int]) -> None:
        """Record the row's key-set (slot columns) for the ConsultBatch
        ingress bridge."""
        row = self.ensure(txn_id)
        self.key_rows[row] = tuple(key_slots)

    def note_waiting(self, txn_id: TxnId, n: int) -> None:
        row = self.slot_of.get(txn_id)
        if row is not None:
            self.waiting[row] = n

    # -- gathers -------------------------------------------------------------
    def rows_for(self, ids: Sequence[TxnId]) -> Tuple[np.ndarray, np.ndarray]:
        """(row index array, known mask) for ``ids``; unknown ids get row 0
        with known=False (callers must mask)."""
        get = self.slot_of.get
        rows = np.fromiter((get(t, -1) for t in ids), dtype=np.int64,
                           count=len(ids))
        known = rows >= 0
        if not known.all():
            rows = np.where(known, rows, 0)
        return rows, known

    def status_of(self, ids: Sequence[TxnId]) -> Tuple[np.ndarray, np.ndarray]:
        """(SaveStatus ordinal array, known mask) — one vectorized gather for
        a monitored-id scan (the progress-log settlement pass)."""
        rows, known = self.rows_for(ids)
        return self.status[rows], known

    # -- the ConsultBatch ingress bridge -------------------------------------
    def to_consult_batch(self, ids: Sequence[TxnId],
                         before_lanes: Sequence[Tuple[int, ...]],
                         kind_codes: Sequence[int],
                         row_cap: Optional[int] = None,
                         flat_cap: Optional[int] = None):
        """Pack the given rows' key sets + query bounds into the device
        service's ragged ``ConsultBatch`` (flat cols + row offsets + txn
        rows, pow2 buckets) — the ingress contract of device_service/batch.py,
        with the per-row ``txn_rows`` attribution lanes populated from this
        mirror's TxnId columns (the field the batch format reserved for the
        columnar protocol batches)."""
        from ..device_service.batch import build_batch
        row_cols: List[Tuple[int, ...]] = []
        txn_lanes: List[Optional[Tuple[int, ...]]] = []
        for tid in ids:
            row = self.slot_of.get(tid)
            row_cols.append(self.key_rows.get(row, ()) if row is not None
                            else ())
            # the canonical device-table row layout (Timestamp.pack_lanes)
            txn_lanes.append(tid.pack_lanes())
        return build_batch(row_cols, before_lanes, kind_codes,
                           txn_lanes=txn_lanes, row_cap=row_cap,
                           flat_cap=flat_cap)
