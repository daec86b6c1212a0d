"""Device-resident conflict index with copy-on-write incremental refresh.

The index lives ON the device persistently, in the layout the consult
kernels consume, sized to what is actually occupied:

- **Pre-transposed incidence**: ``live_T``/``key_T`` are ``[K, T]`` uint8
  (0/1).  The consult kernels OR whole incidence rows per query key, so the
  transpose happens once per refresh, not once per consult; no tensor cores
  are used, so no float copy is kept.
- **Occupancy views, not capacity**: slot allocation is min-heap ordered,
  so live rows/columns are a PREFIX of the arrays; buffers cover
  pow2-bucketed views of the high-watermark slot, and the join cost tracks
  what the index holds, not what it could hold.  The view widens by
  doubling; it never shrinks.
- **Copy-on-write row refresh**: ``refresh`` builds the next buffers from
  the serving ones by cloning them and scattering only the dirty rows into
  the clones, then swaps the front reference.  A buffer that a window has
  pinned (its submission-time snapshot, ``service.begin_window``) is never
  written: the pinned window keeps reading the old tensors and the
  consults after the swap read the new ones.  That pinned-old /
  serving-new pair is the double buffer.  Torch scatters in place, so an
  in-place update would change what a pinned window reads; the clone is
  what keeps the reference's functional ``.at[].set`` semantics.  Only the
  real dirty rows are written (no padding repeats), so no index repeats in
  one scatter.
- Full uploads only when cheaper than row traffic (dirty fraction above
  ``full_fraction``) or when the view/capacity changed.

Everything here also runs on CPU tensors (tests, hostless runs) when the
caller asks for the CPU device.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Set, Tuple

import numpy as np
import torch

from ..observe.profiler import span
from .batch import pow2_bucket

# row-refresh chunk cap: a bigger dirty set loops over capped chunks or tips
# into a full upload via full_fraction
ROW_REFRESH_FLOOR = 8
ROW_REFRESH_CAP = 1024

T_VIEW_FLOOR = 64
K_VIEW_FLOOR = 16

# per-slot fields and their device dtypes (the host index uses the same)
_ROW_DTYPES = {"ts": np.int32, "txn_id": np.int32, "kind": np.int8,
               "status": np.int8, "active": np.bool_}


def _to(device: torch.device, a: np.ndarray) -> torch.Tensor:
    # always a copy: on the CPU ``.to`` would otherwise alias the host
    # index, and its in-place mutations would reach the device buffers
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def _incidence_T(inc: np.ndarray) -> np.ndarray:
    """[T, K] int8 host incidence -> [K, T] uint8 (0/1)."""
    return np.ascontiguousarray((inc != 0).T).astype(np.uint8)


def front_from_host(host_arrays: Dict[str, np.ndarray], t_view: int,
                    k_view: int, device) -> Dict[str, torch.Tensor]:
    """The device buffers for the ``[:t_view, :k_view]`` view of a resolver's
    canonical numpy index (``TpuDepsResolver.host_index()`` format, the same
    in both packages): ``live_T``/``key_T`` [K, T] uint8, ``ts``/``txn_id``
    [T, 5] int32, ``kind``/``status`` [T] int8, ``active`` [T] bool."""
    h = host_arrays
    dev = torch.device(device)
    front = {name: _to(dev, h[name][:t_view].astype(dt, copy=False))
             for name, dt in _ROW_DTYPES.items()}
    front["live_T"] = _to(dev, _incidence_T(h["live_inc"][:t_view, :k_view]))
    front["key_T"] = _to(dev, _incidence_T(h["key_inc"][:t_view, :k_view]))
    return front


def apply_rows(bufs: Dict[str, torch.Tensor], rows: torch.Tensor,
               live_t: torch.Tensor, key_t: torch.Tensor,
               vals: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """New buffers: ``bufs`` with slots ``rows`` (distinct) replaced.  The
    input buffers are not modified (copy-on-write)."""
    out = {}
    for name in _ROW_DTYPES:
        b = bufs[name].clone()
        b[rows] = vals[name]
        out[name] = b
    for name, cols in (("live_T", live_t), ("key_T", key_t)):
        b = bufs[name].clone()
        b[:, rows] = cols
        out[name] = b
    return out


class DoubleBufferedIndex:
    """The persistent device copy of one resolver's canonical host index."""

    def __init__(self, device, full_fraction: float = 0.25):
        self.device = device                         # where buffers live
        self.front: Optional[Dict[str, torch.Tensor]] = None
        self.view: Tuple[int, int] = (0, 0)          # (t_view, k_view)
        self.full_fraction = full_fraction
        self.generation = 0
        # telemetry: refresh traffic + the shape ledger (the bounded-shape
        # contract both tests and the bench introspect)
        self.full_uploads = 0
        self.incremental_refreshes = 0
        self.rows_uploaded = 0
        self.jit_shapes: Set[tuple] = set()

    def drop(self) -> None:
        self.front = None
        self.view = (0, 0)

    @property
    def t_view(self) -> int:
        return self.view[0]

    def _full_upload(self, host: Dict[str, np.ndarray],
                     t_view: int, k_view: int) -> None:
        with span("accord.index.full_upload"):
            self.front = front_from_host(host, t_view, k_view, self.device)
        self.view = (t_view, k_view)
        self.generation += 1
        self.full_uploads += 1
        self.jit_shapes.add(("full", t_view, k_view))

    def refresh(self, host: Dict[str, np.ndarray],
                dirty_rows: Optional[Iterable[int]],
                t_used: int, k_used: int) -> None:
        """Bring the device copy up to date with the canonical host arrays.
        ``dirty_rows=None`` means unknown provenance (first sight / capacity
        growth / host rebuild): full upload.  ``t_used``/``k_used`` are the
        resolver's slot high-watermarks; the view covers their pow2 buckets."""
        with span("accord.index.refresh"):
            t_cap, k_cap = host["key_inc"].shape
            t_view = pow2_bucket(max(t_used, 1), T_VIEW_FLOOR, t_cap)
            k_view = pow2_bucket(max(k_used, 1), K_VIEW_FLOOR, k_cap)
            # views never shrink: shrinking would churn shapes on sawtooth
            # occupancy, and padding rows are inactive anyway
            if self.view[0] <= t_cap:
                t_view = max(t_view, self.view[0])
            if self.view[1] <= k_cap:
                k_view = max(k_view, self.view[1])
            rows = None if dirty_rows is None else sorted(dirty_rows)
            if (self.front is None or self.view != (t_view, k_view)
                    or rows is None
                    or len(rows) >= max(1, int(t_view * self.full_fraction))):
                self._full_upload(host, t_view, k_view)
                return
            if not rows:
                return
            bufs = self.front
            dev = self.device
            for lo in range(0, len(rows), ROW_REFRESH_CAP):
                chunk = np.asarray(rows[lo:lo + ROW_REFRESH_CAP],
                                   dtype=np.int64)
                r_pad = pow2_bucket(len(chunk), ROW_REFRESH_FLOOR,
                                    ROW_REFRESH_CAP)
                vals = {n: _to(dev, host[n][chunk].astype(dt, copy=False))
                        for n, dt in _ROW_DTYPES.items()}
                rows_d = _to(dev, chunk)
                live_t, key_t = (
                    _to(dev, _incidence_T(host[name][chunk, :k_view]))
                    for name in ("live_inc", "key_inc"))
                with span("accord.index.apply_rows"):
                    bufs = apply_rows(bufs, rows_d, live_t, key_t, vals)
                self.jit_shapes.add(("rows", r_pad, t_view, k_view))
                self.rows_uploaded += len(chunk)
            self.front = bufs      # swap: consults from here on see the update
            self.generation += 1
            self.incremental_refreshes += 1
