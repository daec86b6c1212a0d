"""DeviceConsultService — the persistent asynchronous batched consult tier.

One service instance serves one resolver's conflict index (one command
store).  It owns the THREE pieces a one-shot dispatch path lacks:

1. a PERSISTENT device index (index.DoubleBufferedIndex): mutations ship as
   incremental row refreshes, not whole-index re-uploads;
2. a RAGGED BATCHING WINDOW: concurrent per-txn key-set consults coalesce
   into one flattened-keys + row-offsets batch (batch.ConsultBatch), padded
   to pow2 buckets, so one dispatch round trip (launch, transfers, host
   sync) amortizes across the whole window;
3. a FUTURES submission API: ``submit(txn_keys, ...) -> AsyncResult``.
   Submissions accumulate; the first ``result()`` demand dispatches the
   whole window in ONE launch (per capped chunk) and fulfils every future.
   A window whose answers are never demanded (the resolver's exactness
   machinery invalidated them) costs ZERO launches.

Snapshot discipline: ``begin_window`` pins the index buffers as of the
window's opening; mid-window registrations mutate only the host mirrors (and
the resolver's dirty-key tracking decides what is still servable), so every
answer is exact with respect to its submission point — byte-identical to the
eager path the burn tests reconcile against.

Backend: ``torch`` runs the consult kernels (K12, both halves in one
launch, or K1d and K2d for wide rows; ops/_kernels) on the service's
device — the hand-written CUDA kernels on the card, their
plain torch versions when the caller asked for the CPU; both count as
``device_consults``: it is the kernel tier.  ``host`` is the deterministic
host tier — the resolver's own vectorized numpy pass, same answers
bit-for-bit, dispatched EAGERLY per window (no device snapshot exists to
defer against).  ``auto`` means torch.  The device is ``config.device``
(the card unless the caller asks for the CPU); a torch-backed service
raises at construction when that device does not exist.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

import torch

from ..device import resolve_device
from ..observe.profiler import span
from .batch import ConsultBatch, build_batch, pow2_bucket, split_rows
from .index import DoubleBufferedIndex

TS_LANES = 5


class AsyncResult:
    """Future for one submitted consult.  ``result()`` forces the owning
    window's dispatch (one batched launch) on first demand."""
    __slots__ = ("_window", "_post", "_value", "done")

    def __init__(self, window: "_Window", post: Optional[Callable] = None):
        self._window = window
        self._post = post
        self._value = None
        self.done = False

    def _fulfil(self, raw) -> None:
        # raw=None is the superseded-window safety net: no answer exists, so
        # the post-processor must not run (it dereferences the raw tuple);
        # consumers treat a None result as a cache miss and fall back
        self._value = self._post(raw) \
            if self._post is not None and raw is not None else raw
        self._post = None
        self.done = True

    def result(self):
        if not self.done:
            self._window.service._demand(self._window)
        return self._value


class _Window:
    """One batching window: pending submissions + the pinned index snapshot
    they must be answered against."""
    __slots__ = ("service", "buffers", "generation", "pending", "dispatched")

    def __init__(self, service: "DeviceConsultService", buffers, generation):
        self.service = service
        self.buffers = buffers          # pinned front (None = host fallback)
        self.generation = generation
        # (cols, before_lanes, kind_code, txn_lanes, future)
        self.pending: List[tuple] = []
        self.dispatched = False


class DeviceConsultService:
    def __init__(self, resolver, config=None):
        from ..config import LocalConfig
        cfg = config if config is not None else getattr(
            resolver, "config", None) or LocalConfig.from_env()
        self.resolver = resolver
        self.backend = cfg.tpu_service_backend
        if self.backend not in ("auto", "torch", "host"):
            raise ValueError("tpu_service_backend must be auto|torch|host, "
                             f"got {self.backend!r}")
        self.max_window = cfg.tpu_service_max_window
        self.device = resolve_device(cfg.device) \
            if self._torch_backed() else None
        self.index = DoubleBufferedIndex(
            self.device, full_fraction=cfg.tpu_service_refresh_full_frac)
        self._window: Optional[_Window] = None
        # -- service-level telemetry (observe/device.py collects these) ------
        self.submitted = 0              # consults submitted (futures created)
        self.answered = 0               # futures fulfilled
        self.oneshot_rows = 0           # immediate consult_rows consults
        self.batches = 0                # device/host dispatches (launches)
        self.dropped_windows = 0        # windows whose answers went undemanded
        self.batch_size_hist: Dict[int, int] = {}   # real rows -> count
        self.dispatch_seconds = 0.0     # wall time inside dispatches
        self.dispatch_count = 0
        self.dispatch_max_seconds = 0.0
        self.occupancy_sum = 0          # real rows per dispatch vs max_window
        self.pad_rows_skipped = 0       # padding rows launched, never read back
        self.jit_shapes: set = set()    # (rows_bucket, flat_bucket, t, k, packed)
        # bounded (ts, queue_depth, batch_rows) samples for the Chrome-trace
        # counter track; ts is sim-micros when the store has a clock, else a
        # dispatch ordinal.  Appending is deterministic and touches no RNG /
        # scheduling, so the zero-observer-effect contract holds.
        self._sample_cap = 4096
        self.samples: Deque[Tuple[int, int, int]] = \
            deque(maxlen=self._sample_cap)
        self.samples_dropped = 0
        # wall-clock profiler (observe.WallProfiler) — resolved lazily from
        # the owning node at first dispatch; False = probed, none attached
        self._profiler = None

    # -- clock (sim time when available) -------------------------------------
    def _now(self) -> Optional[int]:
        node = getattr(getattr(self.resolver, "store", None), "node", None)
        if node is not None:
            try:
                return int(node.now_micros())
            except Exception:  # noqa: BLE001 — clockless stand-in stores
                return None
        return None

    def _torch_backed(self) -> bool:
        return self.backend != "host"

    # -- index refresh --------------------------------------------------------
    def _refresh(self) -> None:
        """Bring the persistent buffers up to date (incremental rows against
        the occupancy-view extent — slot allocation is min-heap ordered, so
        the resolver's high-watermarks bound every live row/column)."""
        h = self.resolver.host_index()
        self.index.refresh(h, self.resolver.take_dirty_rows(),
                           getattr(self.resolver, "_max_slot", -1) + 1,
                           getattr(self.resolver, "_max_key_slot", -1) + 1)

    # -- the batching window --------------------------------------------------
    def begin_window(self) -> None:
        """Open a new window: refresh the index and pin the snapshot every
        submission in this window is answered against."""
        if self._window is not None and self._window.pending \
                and not self._window.dispatched:
            self.dropped_windows += 1
        if self._torch_backed():
            self._refresh()
            self._window = _Window(self, self.index.front,
                                   self.index.generation)
        else:
            self._window = _Window(self, None, 0)

    def end_window(self) -> None:
        if self._window is not None and self._window.pending \
                and not self._window.dispatched:
            self.dropped_windows += 1
        self._window = None

    def flush_window(self) -> None:
        """Dispatch the current window NOW (eager).  The host fallback has no
        pinned device snapshot, so deferring to demand time would answer
        against a post-mutation index and break byte-identity with the eager
        path — the resolver forces this right after submitting a host-backed
        window."""
        if self._window is not None and self._window.pending:
            self._demand(self._window)

    @property
    def deferred(self) -> bool:
        """Whether windows may defer dispatch to demand time (only the torch
        path has the pinned snapshot that makes deferral exact)."""
        return self._torch_backed()

    def submit(self, txn_key_cols, before_lanes, kind_code,
               txn_lanes=None, post: Optional[Callable] = None) -> AsyncResult:
        """Enqueue one ragged consult (key-slot columns; empty is legal) into
        the current window; returns its future.  No dispatch happens until a
        result is demanded — then the WHOLE window goes in one launch."""
        if self._window is None:
            self.begin_window()
        w = self._window
        fut = AsyncResult(w, post)
        w.pending.append((tuple(txn_key_cols), tuple(before_lanes),
                          int(kind_code), txn_lanes, fut))
        self.submitted += 1
        self._sample(len(w.pending), 0)
        return fut

    def _demand(self, window: "_Window") -> None:
        """First ``result()`` on an undispatched window: answer EVERYTHING
        pending in capped ragged batches against the pinned snapshot."""
        if window.dispatched:
            return
        window.dispatched = True
        if window is not self._window:
            # the window was superseded before any demand (exactness machinery
            # dropped the cache): its futures resolve to None — callers that
            # could still demand them hold a live cache, so this cannot happen
            # for a served answer; it is a safety net, not a code path
            for *_ignore, fut in window.pending:
                fut._fulfil(None)
            return
        for chunk in split_rows(window.pending, self.max_window):
            with span("accord.service.build_batch"):
                batch = build_batch(
                    [p[0] for p in chunk], [p[1] for p in chunk],
                    [p[2] for p in chunk], [p[3] for p in chunk],
                    row_cap=self.max_window)
            deps, max_lanes = self._dispatch(batch, window.buffers)
            for i, (*_spec, fut) in enumerate(chunk):
                fut._fulfil((deps[i], max_lanes[i]))
                self.answered += 1

    # -- one-shot bridge (the resolver's immediate dense consults) -----------
    def consult_rows(self, q: np.ndarray, before: np.ndarray,
                     kind: np.ndarray):
        """Immediate batched consult for already-dense query rows (the
        resolver ``_consult`` bridge).  Uses the CURRENT index (refreshing
        incrementally), one ragged launch per capped chunk."""
        if q.shape[0] == 0:
            return (np.zeros((0, 1), dtype=bool),
                    np.zeros((0, TS_LANES), dtype=np.int64))
        rows = [tuple(np.nonzero(q[i])[0].tolist()) for i in range(q.shape[0])]
        self.oneshot_rows += len(rows)
        if self._torch_backed():
            self._refresh()
            buffers = self.index.front
        else:
            buffers = None
        deps_out = []
        lanes_out = []
        idxs = list(range(len(rows)))
        for chunk in split_rows(idxs, self.max_window):
            with span("accord.service.build_batch"):
                batch = build_batch([rows[i] for i in chunk],
                                    [tuple(int(v) for v in before[i])
                                     for i in chunk],
                                    [int(kind[i]) for i in chunk],
                                    row_cap=self.max_window)
            deps, max_lanes = self._dispatch(batch, buffers)
            deps_out.append(deps)
            lanes_out.append(max_lanes)
        return np.concatenate(deps_out), np.concatenate(lanes_out)

    # -- dispatch -------------------------------------------------------------
    def _dispatch(self, batch: ConsultBatch, buffers):
        """One launch: ragged batch in, (deps [rows, T] bool, max_lanes
        [rows, 5]) out — counters incremented ONCE PER SUBMITTED CONSULT
        (batch.rows), never per launch (the r03 bookkeeping fix)."""
        with span("accord.service.dispatch"):
            if self._profiler is None:
                node = getattr(getattr(self.resolver, "store", None), "node",
                               None)
                self._profiler = getattr(node, "profiler", None) or False
            t0 = time.perf_counter()
            compiled = False
            if buffers is not None:
                n_shapes = len(self.jit_shapes)
                deps, max_lanes = self._dispatch_torch(batch, buffers)
                compiled = len(self.jit_shapes) > n_shapes
                self.resolver.device_consults += batch.rows
            else:
                h = self.resolver.host_index()
                q = batch.densify(h["key_inc"].shape[1])
                # the deterministic host fallback IS the resolver's own host
                # tier (it does its own per-consult counting)
                deps, max_lanes = self.resolver._consult_host(
                    q, batch.before[:batch.rows].astype(np.int64),
                    batch.kind[:batch.rows])
            dt = time.perf_counter() - t0
            self.batches += 1
            self.batch_size_hist[batch.rows] = \
                self.batch_size_hist.get(batch.rows, 0) + 1
            self.dispatch_seconds += dt
            self.dispatch_count += 1
            self.dispatch_max_seconds = max(self.dispatch_max_seconds, dt)
            self.occupancy_sum += batch.rows
            self._sample(0, batch.rows)
            if self._profiler and buffers is not None:
                # launch breakdown for the wall profiler: dispatch RTT, h2d
                # (the ragged batch arrays) and d2h (densified results)
                # bytes, and whether this launch used a new shape.  Wall-plane
                # only — nothing here feeds the deterministic registry.
                h2d = (batch.flat_cols.nbytes + batch.offsets.nbytes
                       + batch.before.nbytes + batch.kind.nbytes)
                self._profiler.on_device_launch(
                    batch.rows, dt, h2d, deps.nbytes + max_lanes.nbytes,
                    compiled)
            return deps, max_lanes

    def _dispatch_torch(self, batch: ConsultBatch, buffers):
        from .kernel import ragged_consult_t, to_host, unpack_deps
        k, t = buffers["live_T"].shape
        dev = buffers["live_T"].device
        # bit-packing the result only pays when it crosses a real transfer
        # link; on the CPU it is pure extra compute
        packed = t >= 32768 and t % 8 == 0 and dev.type != "cpu"
        self.jit_shapes.add(batch.shape_signature + (t, k, packed))

        query = [torch.from_numpy(a) for a in (
            batch.flat_cols, batch.offsets, batch.before, batch.kind)]
        with span("accord.service.upload"):
            query = [a.to(dev) for a in query]
        # one launch; the real rows of both answers, prefixes of the one
        # buffer, read back in one copy (kernel.py)
        deps, max_lanes = ragged_consult_t(
            buffers["live_T"], buffers["key_T"], buffers["ts"],
            buffers["txn_id"], buffers["kind"], buffers["status"],
            buffers["active"], *query, packed=packed)
        self.pad_rows_skipped += deps.shape[0] - batch.rows
        deps, max_lanes = to_host(deps[:batch.rows], max_lanes[:batch.rows])
        if packed:
            with span("accord.service.unpack"):
                deps = unpack_deps(deps, t)
        return deps, max_lanes

    # -- telemetry ------------------------------------------------------------
    def _sample(self, queue_depth: int, batch_rows: int) -> None:
        # ring semantics: a long soak keeps the RECENT trajectory (the
        # windowed timeline and the Perfetto track both want the tail into a
        # stall, not the warm-up) — drop the OLDEST sample past the cap
        ts = self._now()
        if ts is None:
            ts = self.samples_dropped + len(self.samples)
        if len(self.samples) >= self._sample_cap:
            self.samples_dropped += 1    # deque(maxlen) evicts the oldest
        self.samples.append((ts, queue_depth, batch_rows))

    def stats(self) -> Dict[str, object]:
        occ = (self.occupancy_sum / (self.dispatch_count * self.max_window)
               if self.dispatch_count else 0.0)
        lat = (self.dispatch_seconds / self.dispatch_count
               if self.dispatch_count else 0.0)
        return {
            "submitted": self.submitted,
            "answered": self.answered,
            "oneshot_rows": self.oneshot_rows,
            "batches": self.batches,
            "dropped_windows": self.dropped_windows,
            "batch_size_hist": dict(sorted(self.batch_size_hist.items())),
            "mean_batch_rows": round(self.occupancy_sum
                                     / max(1, self.dispatch_count), 2),
            "window_occupancy": round(occ, 4),
            "pad_rows_skipped": self.pad_rows_skipped,
            "dispatch_mean_s": round(lat, 6),
            "dispatch_max_s": round(self.dispatch_max_seconds, 6),
            "jit_shapes": len(self.jit_shapes | self.index.jit_shapes),
            "index_full_uploads": self.index.full_uploads,
            "index_incremental_refreshes": self.index.incremental_refreshes,
            "index_rows_uploaded": self.index.rows_uploaded,
            "samples_dropped": self.samples_dropped,
        }
