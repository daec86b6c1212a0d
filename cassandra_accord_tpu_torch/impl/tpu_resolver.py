"""TpuDepsResolver — the accelerator conflict-index data plane (torch port).

The class keeps the reference's name and ``tpu_*`` configuration so one
kwargs dict configures both packages; here "tpu" reads "device tier", and
the device is ``config.device`` (the card unless the caller asks for the
CPU).

The per-store conflict index (the reference's CommandsForKey sorted arrays +
MaxConflicts map, cfk/CommandsForKey.java:615-628, MaxConflicts.java:32) is a
fixed-capacity ARRAY index — a key-incidence matrix, packed timestamp lanes,
kind/status codes and an active mask over txn slots — instead of the
reference's per-key pointer-chased sorted arrays.

Every dependency query (``SafeCommandStore.map_reduce_active`` →
``calculate_partial_deps``, PreAccept.java:245-267) and timestamp-proposal
consult (``max_conflict``) is ONE fused join over that index
(ops.deps_kernels.consult): key-overlap matmul × started-before lex compare ×
kind-witness mask, plus the masked lexicographic max for the timestamp
proposal — not the reference's scalar per-key scans
(cfk/CommandsForKey.java:925-1000).

TRANSITIVE ELISION (cfk/CommandsForKey.java:144-157; local/cfk.py
map_reduce_active is the oracle): committed txns executing before the latest
committed WRITE below the query bound are covered by it and excluded from
deps answers.  The index maintains this incrementally as per-incidence
COVERED bits (monotone while the per-key covering bound E_k = max committed
write executeAt only grows; prune of a covering write un-covers survivors):

- ``live`` incidence matrix = full incidence minus covered bits → one matmul
  answers an elided deps query EXACTLY for any bound above E_k (the common
  case: PreAccept/Accept bounds are fresh timestamps);
- bounds at-or-below E_k take a per-key vectorized pass that recomputes the
  covering write for that bound (rare; exact);
- max-conflict always uses the FULL incidence (elision never applies to the
  timestamp proposal).

Two execution tiers answer the SAME join bit-identically, picked per call by
a cost model (the accelerator-native split: dispatch to the device only when the
work amortizes launch+transfer):

- host tier  — one vectorized numpy pass (BLAS f32 matmuls + lane-wise lex
               compares).  No launch overhead; serves small windows.
- device tier — the consult kernels on the device: K12 (deps and max in
               one launch; K1d and K2d for wide rows) of ops/_kernels over
               the [K, T] incidence, through the persistent service or a
               one-shot call of the service's dispatch (consult_batch).
               Serves large batches / deep indexes.

The canonical index lives in host numpy (mutations are in-place row writes);
the device copy is synced lazily when the device tier is chosen.  Tier choice
never affects answers (both tiers are parity-checked against the cfk walk by
VerifyDepsResolver), only speed.

Queries batch across messages: a coalesced delivery window
(harness/cluster.py ``batch_window_us``) declares its upcoming
PreAccept/Accept consults via ``prefetch``, which answers ALL of them in one
fused consult.  Live queries are then served from the cached answers with
EXACT sequential semantics:

- every index mutation since the prefetch marks its keys dirty;
- a clean cached answer is served only when no dirty key intersects it;
- dirt from txns NEW since the prefetch is PATCHED in from the (always
  current, therefore sequentially exact) host mirrors — including the
  querying txn itself, whose own registration precedes its deps walk;
- a WRITE entering the committed lattice mid-window marks its keys HARD
  (its arrival moves the covering bound for arbitrary bounds on those keys);
  hard keys always fall back;
- patching is only attempted for bounds above E_k (below it the covered bits
  are not the right elision set), and upgrades of pre-existing txns always
  fall back.

Anything unprovable falls back to an individual consult, so batching is a
pure fast path.

Slot lifecycle: slots are recycled once a txn is fully pruned from every key
it touched (the cfk prune protocol driven by RedundantBefore GC,
command_store._prune_below_fences / run_gc); capacity doubles by host rebuild
when the free list empties.
"""
from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Set, Tuple, TYPE_CHECKING

import numpy as np

from ..device_service.service import AsyncResult
from ..primitives.keys import Range, RoutingKey
from ..primitives.timestamp import Timestamp, TxnId, TxnKind
from ..utils.invariants import check_state
from .resolver import DepsResolver

if TYPE_CHECKING:
    from ..local.command_store import CommandStore
    from ..local.cfk import InternalStatus

TS_LANES = 5
_WRITE = int(TxnKind.WRITE)

_WITNESSES: Optional[np.ndarray] = None
_INVALIDATED: Optional[int] = None
_COMMITTED: Optional[int] = None


def _witnesses() -> np.ndarray:
    global _WITNESSES
    if _WITNESSES is None:
        from ..ops.deps_kernels import _witness_table
        _WITNESSES = _witness_table()
    return _WITNESSES


def _status_codes() -> Tuple[int, int]:
    """(COMMITTED, INVALIDATED) from the one source of truth (local.cfk), so
    the host tier's masks can never diverge from the cfk walk or the kernel."""
    global _COMMITTED, _INVALIDATED
    if _COMMITTED is None:
        from ..local.cfk import InternalStatus
        _COMMITTED = int(InternalStatus.COMMITTED)
        _INVALIDATED = int(InternalStatus.INVALIDATED)
    return _COMMITTED, _INVALIDATED


_APPLIED: Optional[int] = None


def _applied_code() -> int:
    global _APPLIED
    if _APPLIED is None:
        from ..local.cfk import InternalStatus
        _APPLIED = int(InternalStatus.APPLIED)
    return _APPLIED


def _pack_before(before: Timestamp) -> Tuple[int, int, int, int, int]:
    """Pack a query bound, saturating out-of-device-range bounds (e.g. the
    ephemeral-read Timestamp.MAX sentinel) to lanes above every real packed
    timestamp (all real lanes are < 2^31-1)."""
    try:
        return before.pack_lanes()
    except Exception:  # noqa: BLE001 — bound exceeds device packing range
        m = 0x7FFFFFFF
        return (m, m, m, m, m)


def _post_mc(raw):
    """Deferred-mc post-processor: unpack the service's max lanes."""
    ts = Timestamp.unpack_lanes(tuple(int(v) for v in raw[1]))
    return None if ts == Timestamp.NONE else ts


def _lex_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lexicographic a < b over packed lanes [..., 5] (numpy; mirrors
    ops.graph_state.ts_less exactly)."""
    lt = a[..., TS_LANES - 1] < b[..., TS_LANES - 1]
    for lane in range(TS_LANES - 2, -1, -1):
        lt = (a[..., lane] < b[..., lane]) | ((a[..., lane] == b[..., lane]) & lt)
    return lt


def _lex_max_rows(rows: np.ndarray) -> np.ndarray:
    """Lexicographic max over rows [N, 5] (N >= 1)."""
    sel = np.ones(rows.shape[0], dtype=bool)
    for lane in range(TS_LANES):
        best = rows[sel, lane].max()
        sel = sel & (rows[:, lane] == best)
    return rows[np.flatnonzero(sel)[0]]


class _TxnMirror:
    """Host bookkeeping for one indexed txn (rebuilds + attribution + the
    covered-key set for transitive elision)."""
    __slots__ = ("slot", "kind_code", "status", "execute_at", "keys", "covered",
                 "durable")

    def __init__(self, slot: int, kind_code: int, status: int,
                 execute_at: Timestamp, keys: Set[RoutingKey]):
        self.slot = slot
        self.kind_code = kind_code
        self.status = status
        self.execute_at = execute_at
        self.keys = keys
        self.covered: Set[RoutingKey] = set()
        self.durable = False   # per-txn UNIVERSAL durability (elision gate)


class TpuDepsResolver(DepsResolver):
    def __init__(self, store: "CommandStore", txn_capacity: Optional[int] = None,
                 key_capacity: Optional[int] = None, config=None):
        from ..config import LocalConfig
        cfg = config if config is not None else LocalConfig.from_env()
        self.config = cfg
        # initial capacities: growth doubles them (a host rebuild + a new jit
        # shape each time), so long-running/bench deployments start big
        if txn_capacity is None:
            txn_capacity = cfg.tpu_txn_slots
        if key_capacity is None:
            key_capacity = cfg.tpu_key_slots
        self.store = store
        self.txns: Dict[TxnId, _TxnMirror] = {}
        self.txn_at: Dict[int, TxnId] = {}          # slot -> txn (attribution)
        self.key_slot: Dict[RoutingKey, int] = {}
        self.key_refs: Dict[RoutingKey, int] = {}   # live incidences per key
        self.free_slots: List[int] = list(range(txn_capacity))
        heapq.heapify(self.free_slots)
        self.free_key_slots: List[int] = list(range(key_capacity))
        heapq.heapify(self.free_key_slots)
        # transitive-elision bookkeeping (mirrors cfk._committed_writes +
        # the covering bound per key)
        self.key_maxw: Dict[RoutingKey, Timestamp] = {}      # E_k (max cw ea)
        self.key_maxw_tid: Dict[RoutingKey, TxnId] = {}      # that write's tid
        self.key_cw: Dict[RoutingKey, Dict[TxnId, Timestamp]] = {}
        self.key_uncovered: Dict[RoutingKey, Set[TxnId]] = {}
        self.key_covered: Dict[RoutingKey, Set[TxnId]] = {}
        # max-conflict floor per key over PRUNED incidences (mirror of
        # cfk._pruned_max): a timestamp proposal must exceed every txn the
        # key ever witnessed, resident in the index or not
        self.key_mc_floor: Dict[RoutingKey, Timestamp] = {}
        # elision soundness gate (cfk.map_reduce_active doc): a txn may only
        # be covered once below the key's MAJORITY-durable watermark; the
        # store bumps durable_gen on watermark advances and we re-sweep lazily
        self._durable_gen_seen = -1
        # pending (txn_id) inserts/updates, (slot, key_slot) bit ops, and
        # chronological live-matrix ops (cover=0 / uncover=1)
        self._dirty_txns: Set[TxnId] = set()
        self._clear_bits: List[Tuple[int, int]] = []
        self._deactivate: List[int] = []
        self._live_ops: List[Tuple[int, int, int]] = []
        self._t = txn_capacity
        self._k = key_capacity
        self._h: Optional[dict] = None   # canonical numpy index (lazy)
        self._device = None              # device copy (lazy, synced on use)
        self._torch_dev = None           # resolved config.device (lazy)
        self._device_clean = False
        # tier selection: 'auto' cost model, or forced for tests/benches
        self.tier = cfg.tpu_tier
        self._threshold_elems: Optional[float] = None
        # below this many indexed txns the per-key scalar walk (the cfk
        # oracle itself) beats the vectorized tiers' fixed overhead — the
        # third rung of the cost ladder: walk / host-vector / device
        self._walk_max = cfg.tpu_walk_max
        # narrow-query walk routing past _walk_max (flat-cost walks)
        self._walk_width = cfg.tpu_walk_width
        # above this capacity the persistent f32 host-tier mirrors (2 × K×T×4
        # bytes) are not worth their memory — the canonical index stays int8
        # (2 × T×K bytes) and the host tier casts per call (rare: the cost
        # model prefers the device tier at that scale anyway)
        self._f32_max = cfg.tpu_f32_max
        self._walk: Optional[DepsResolver] = None
        # consult counters: ONE increment PER SUBMITTED CONSULT (a batched
        # launch of B queries counts B — the r03-comparable bookkeeping; the
        # old per-launch counting understated device traffic by the batch
        # factor and made device-vs-host ratios incomparable)
        self.walk_consults = 0
        self.host_consults = 0
        self.native_consults = 0
        self.device_consults = 0
        # total wall seconds inside fused-consult tier dispatch (whichever
        # tier answered) — the wall profiler's device-consult-wait line.
        # WALL-clock: never enters the deterministic registry or burn stats
        self.consult_wall_s = 0.0
        # persistent batched device consult service (device_service/): owns
        # the device-resident index (incremental double-buffered refresh),
        # the ragged batching window, and the futures submission API.  The
        # device tier routes through it unless tpu_service == "off" (legacy
        # one-shot dispatch, kept as the bench baseline).
        self.service_enabled = cfg.tpu_service != "off"
        self._service_obj = None
        # rows of the canonical index touched since the service last
        # refreshed its buffers (None = full upload needed: first sight,
        # capacity growth, host rebuild)
        self._dirty_rows: Optional[Set[int]] = None
        # slot high-watermarks: min-heap allocation keeps live slots a
        # prefix, so these bound the service's occupancy-view extents
        self._max_slot = -1
        self._max_key_slot = -1
        # host-tier engine: 'auto' uses the native C++ consult when built and
        # the query key-counts are sparse (its O(B*T*k_q) walk beats the
        # dense BLAS pass), 'numpy'/'native' force a rung
        self._host_engine = cfg.tpu_host_engine
        # execute-phase wait-graph mirror (Commands WaitingOn edges), the input
        # to the kernel-computed execution frontier
        self.edges: Dict[TxnId, Set[TxnId]] = {}
        # prefetched-answer cache for the current delivery window (None = no
        # window active): sig -> answer, plus keys dirtied/hardened since
        self._cache: Optional[Dict[tuple, object]] = None
        self._cache_dirty: Dict[RoutingKey, Set[TxnId]] = {}
        self._cache_hard: Set[RoutingKey] = set()
        self._prefetch_preexisting: Set[TxnId] = set()
        self.prefetch_hits = 0
        self.prefetch_patched = 0
        self.prefetch_misses = 0

    # -- the persistent device consult service --------------------------------
    def service(self):
        """This resolver's DeviceConsultService (lazy; one per store)."""
        if self._service_obj is None:
            from ..device_service.service import DeviceConsultService
            self._service_obj = DeviceConsultService(self, config=self.config)
        return self._service_obj

    def device(self):
        """The torch device of the device tier (``config.device``; raises
        when it names a card that is not there)."""
        if self._torch_dev is None:
            from ..device import resolve_device
            self._torch_dev = resolve_device(self.config.device)
        return self._torch_dev

    def take_dirty_rows(self) -> Optional[Set[int]]:
        """Rows changed since the service's last buffer refresh (None = the
        whole index must re-upload).  Consumes the tracking set."""
        rows = self._dirty_rows
        self._dirty_rows = set()
        return rows

    @property
    def service_submitted(self) -> int:
        return self._service_obj.submitted if self._service_obj else 0

    @property
    def service_batches(self) -> int:
        return self._service_obj.batches if self._service_obj else 0

    # -- registration (cfk.update semantics) ---------------------------------
    def register(self, txn_id: TxnId, status, execute_at, keys) -> None:
        from ..local.cfk import InternalStatus as IS
        status_i = int(status)
        committed_i, invalidated_i = _status_codes()
        m = self.txns.get(txn_id)
        was: Optional[int] = None if m is None else m.status
        if m is None:
            slot = self._alloc_slot()
            ea = execute_at if execute_at is not None else txn_id.as_timestamp()
            m = _TxnMirror(slot, int(txn_id.kind), status_i, ea, set())
            self.txns[txn_id] = m
            self.txn_at[slot] = txn_id
        elif status_i == invalidated_i and committed_i <= m.status \
                and m.status != invalidated_i:
            # committed txns can never be invalidated (cfk.update's guard):
            # ignore the registration ENTIRELY — adding its keys while
            # refusing its status would split the cfk and resolver planes
            return
        else:
            # monotonic status; executeAt moves on upgrade or while ACCEPTED,
            # and is FINAL from COMMITTED on (cfk.update's invariant)
            if status_i > m.status:
                if execute_at is not None and m.status < committed_i:
                    m.execute_at = execute_at
                m.status = status_i
            elif status_i == m.status and execute_at is not None \
                    and status_i == int(IS.ACCEPTED):
                m.execute_at = execute_at
        added_key = False
        for rk in keys:
            if rk not in m.keys:
                # allocate the key slot BEFORE recording the incidence: growth
                # rebuilds iterate txn key sets and need every slot assigned
                if rk not in self.key_slot:
                    self.key_slot[rk] = self._alloc_key_slot()
                m.keys.add(rk)
                added_key = True
                self.key_refs[rk] = self.key_refs.get(rk, 0) + 1
        self._dirty_txns.add(txn_id)
        if self._cache is not None and added_key \
                and txn_id in self._prefetch_preexisting:
            # a PRE-EXISTING txn grew its footprint mid-window: its base
            # contributions in cached answers are un-patchable — drop the cache
            # (rare: routes only widen on cross-epoch re-contact)
            self._cache = None
        if self._cache is not None:
            # conservatively dirty the txn's WHOLE footprint: a status/executeAt
            # upgrade changes its contribution on every key it touches
            for rk in m.keys:
                self._cache_dirty.setdefault(rk, set()).add(txn_id)
        if (was is None or was < committed_i) \
                and committed_i <= m.status != invalidated_i:
            self._on_committed(txn_id, m)
        elif added_key and m.status != invalidated_i and committed_i <= m.status:
            # already-committed txn gained keys: index its committed presence
            # on the new keys too (same lattice-entry handling, new keys only)
            self._on_committed(txn_id, m)

    def _coverable_now(self, rk: RoutingKey, txn_id: TxnId, m: _TxnMirror,
                       e_k: Optional[Timestamp] = None,
                       bound: Optional[TxnId] = None) -> bool:
        """Cover condition = below the covering write AND below the key's
        majority-durable watermark (the elision soundness gate).  Callers in
        loops pass the hoisted per-key e_k/bound."""
        if e_k is None:
            e_k = self.key_maxw.get(rk)
        if e_k is None or not m.execute_at < e_k:
            return False
        if m.durable:
            # the flag path additionally needs the covering write to have
            # WITNESSED the entry (tid below the cover's tid): a reordered
            # cover (ea above, tid below) never chained through it, and
            # eliding it would break local-apply transitivity (cfk
            # map_reduce_active's maxcw_tid condition)
            tid_k = self.key_maxw_tid.get(rk)
            if tid_k is not None and txn_id < tid_k:
                return True
        if bound is None:
            bound = self._durable_majority(rk)
        return bound is not None and txn_id < bound

    def _on_committed(self, txn_id: TxnId, m: _TxnMirror) -> None:
        """The txn entered the committed lattice (executeAt now final):
        maintain the covering bounds and covered bits (cfk elision mirror)."""
        coverable = TxnKind.WRITE.witnesses(TxnKind(m.kind_code))
        is_w = m.kind_code == _WRITE
        for rk in m.keys:
            cw = self.key_cw.get(rk)
            if cw is not None and txn_id in cw:
                continue    # this key already processed (added-keys re-entry)
            if rk in self.key_covered and txn_id in self.key_covered[rk]:
                continue
            if coverable and self._coverable_now(rk, txn_id, m):
                self._cover(rk, txn_id, m)
            elif coverable:
                self.key_uncovered.setdefault(rk, set()).add(txn_id)
            e_k = self.key_maxw.get(rk)
            if is_w:
                self.key_cw.setdefault(rk, {})[txn_id] = m.execute_at
                if self._cache is not None:
                    # a new committed write moves the covering bound for
                    # arbitrary query bounds on this key: cached answers there
                    # are unservable for the rest of the window
                    self._cache_hard.add(rk)
                if e_k is None or m.execute_at > e_k:
                    old_tid = self.key_maxw_tid.get(rk)
                    self.key_maxw[rk] = m.execute_at
                    self.key_maxw_tid[rk] = txn_id
                    if old_tid is not None and txn_id < old_tid:
                        # REORDERED cover (ea up, tid down): flag-covered
                        # entries above the new tid are no longer provably
                        # witnessed by the cover — re-expose, then re-cover
                        # whatever the watermark still allows
                        self._unc_over_tid(rk, txn_id)
                    self._sweep(rk)

    def _unc_over_tid(self, rk: RoutingKey, new_tid: TxnId) -> None:
        """Un-cover entries whose cover validity depended on a higher frontier
        tid; the follow-up _sweep re-covers any that remain eligible (e.g.
        via the watermark path).  Un-covering is always safe — it only
        re-emits."""
        ks = self.key_slot.get(rk)
        cov = self.key_covered.get(rk)
        if ks is None or not cov:
            return
        self._cache = None
        for t in [t for t in cov if not t < new_tid]:
            mt = self.txns.get(t)
            if mt is None:
                continue
            cov.discard(t)
            mt.covered.discard(rk)
            self.key_uncovered.setdefault(rk, set()).add(t)
            self._live_ops.append((mt.slot, ks, 1))

    def _sweep(self, rk: RoutingKey) -> None:
        """The covering bound (E_k or the durability gate) advanced: cover
        every committed coverable txn now below both."""
        unc = self.key_uncovered.get(rk)
        if not unc:
            return
        e_k = self.key_maxw.get(rk)
        bound = self._durable_majority(rk)       # loop-invariant: hoisted
        if e_k is None:
            return
        for t in list(unc):
            mt = self.txns.get(t)
            if mt is not None and self._coverable_now(rk, t, mt, e_k, bound):
                unc.discard(t)
                self._cover(rk, t, mt)

    def _maybe_resweep_durable(self) -> None:
        """The store's durability watermarks advanced since we last looked:
        the elision gate may have widened — re-sweep keys with uncovered
        committed entries (lazy, amortised against durable_gen)."""
        gen = getattr(self.store, "durable_gen", None)
        if gen is None or gen == self._durable_gen_seen:
            return
        self._durable_gen_seen = gen
        self._cache = None   # cached answers predate the wider gate
        for rk in list(self.key_uncovered):
            if self.key_uncovered.get(rk):
                self._sweep(rk)

    def _cover(self, rk: RoutingKey, txn_id: TxnId, m: _TxnMirror) -> None:
        m.covered.add(rk)
        self.key_covered.setdefault(rk, set()).add(txn_id)
        self._live_ops.append((m.slot, self.key_slot[rk], 0))

    def mark_durable(self, txn_id: TxnId) -> None:
        """Per-txn UNIVERSAL durability (every Apply acked): the elision
        gate widens for this txn on every key it touches (the device-plane
        mirror of cfk.mark_durable)."""
        m = self.txns.get(txn_id)
        if m is None:
            return
        if not m.durable:
            # the flag changes per-bound answers (the walk/_slow_hits flag
            # path) even when no covered bit flips here — cached window
            # answers computed before it are unservable
            self._cache = None
        m.durable = True
        self._dirty_txns.add(txn_id)   # h["durable"] row updates on flush
        committed_i, invalidated_i = _status_codes()
        if m.status < committed_i or m.status == invalidated_i \
                or not TxnKind.WRITE.witnesses(TxnKind(m.kind_code)):
            return
        covered_any = False
        for rk in list(m.keys - m.covered):
            unc = self.key_uncovered.get(rk)
            if unc is None or txn_id not in unc:
                continue
            if self._coverable_now(rk, txn_id, m):
                unc.discard(txn_id)
                self._cover(rk, txn_id, m)
                covered_any = True
        if covered_any:
            self._cache = None   # cached answers predate the wider gate

    def on_pruned(self, key: RoutingKey, txn_ids) -> None:
        self._cache = None   # prunes mid-window are rare: drop the whole cache
        ks = self.key_slot.get(key)
        if ks is None:
            return
        cw = self.key_cw.get(key)
        cw_removed = False
        for txn_id in txn_ids:
            m = self.txns.get(txn_id)
            if m is None or key not in m.keys:
                continue
            c = m.execute_at if not m.execute_at < txn_id.as_timestamp() \
                else txn_id.as_timestamp()
            f = self.key_mc_floor.get(key)
            if f is None or c > f:
                self.key_mc_floor[key] = c
            m.keys.discard(key)
            m.covered.discard(key)
            self._clear_bits.append((m.slot, ks))
            if cw is not None and cw.pop(txn_id, None) is not None:
                cw_removed = True
            u = self.key_uncovered.get(key)
            if u is not None:
                u.discard(txn_id)
            c = self.key_covered.get(key)
            if c is not None:
                c.discard(txn_id)
            self._release_key(key)
            if not m.keys:
                # fully pruned: recycle the slot — purging any buffered
                # cover/uncover ops for it, which must never replay onto a
                # future occupant of the same slot
                self._deactivate.append(m.slot)
                if self._live_ops:
                    self._live_ops = [op for op in self._live_ops
                                      if op[0] != m.slot]
                del self.txns[txn_id]
                del self.txn_at[m.slot]
                self._dirty_txns.discard(txn_id)
                self.edges.pop(txn_id, None)
                heapq.heappush(self.free_slots, m.slot)
        if cw_removed and key in self.key_slot:
            # the covering bound may have receded: un-cover survivors whose
            # cover no longer holds (cfk recomputes per query; we re-expose)
            if cw:
                new_tid, new_e = max(cw.items(), key=lambda kv: (kv[1], kv[0]))
            else:
                new_tid, new_e = None, None
            if new_e is None:
                self.key_maxw.pop(key, None)
                self.key_maxw_tid.pop(key, None)
            else:
                self.key_maxw[key] = new_e
                self.key_maxw_tid[key] = new_tid
            bound = self._durable_majority(key)
            for t in list(self.key_covered.get(key, ())):
                mt = self.txns.get(t)
                if mt is None:
                    continue
                if not self._coverable_now(key, t, mt, new_e, bound):
                    self.key_covered[key].discard(t)
                    mt.covered.discard(key)
                    self.key_uncovered.setdefault(key, set()).add(t)
                    self._live_ops.append((mt.slot, ks, 1))

    def _release_key(self, key: RoutingKey) -> None:
        """Drop a live incidence; recycle the key slot when none remain (the
        index column is already zeroed by the per-incidence clears)."""
        n = self.key_refs.get(key, 0) - 1
        if n > 0:
            self.key_refs[key] = n
        else:
            self.key_refs.pop(key, None)
            for d in (self.key_maxw, self.key_cw, self.key_uncovered,
                      self.key_covered):
                d.pop(key, None)
            ks = self.key_slot.pop(key, None)
            if ks is not None:
                # purge buffered cover/uncover ops on the recycled COLUMN —
                # they must never replay onto a future key in this slot
                if self._live_ops:
                    self._live_ops = [op for op in self._live_ops
                                      if op[1] != ks]
                heapq.heappush(self.free_key_slots, ks)

    # -- batched prefetch (delivery-window coalescing) ------------------------
    def prefetch(self, specs) -> None:
        """Answer every declared query in ONE fused consult and cache the
        answers for the window (see module doc for the exactness rules).
        Specs whose bound is at/below a queried key's covering bound take the
        exact per-key slow path instead of the batched matmul."""
        self._maybe_resweep_durable()   # BEFORE the cache is built
        widest = max((len(s.keys) for s in specs), default=0)
        if self._use_walk(width=widest):
            # below the vectorization threshold — or a window of uniformly
            # narrow queries against a big index, where per-query walks beat
            # a dense batch pass — the walk answers each query cheaper than
            # batch + cache bookkeeping
            self._cache = None
            return
        self._cache = {}
        self._cache_dirty = {}
        self._cache_hard = set()
        # ids indexed as of the prefetch: mutations by NEW txns can be patched
        # into cached answers exactly; upgrades of these force a fallback
        self._prefetch_preexisting = set(self.txns)
        live: List[Tuple[tuple, str, List[RoutingKey], object]] = []
        slow: List[Tuple[tuple, List[RoutingKey], object, TxnId]] = []
        for spec in specs:
            known = [rk for rk in spec.keys if rk in self.key_slot]
            if spec.op == "kc":
                sig = ("kc", spec.by, frozenset(known), spec.before)
                if not known or not self.txns:
                    self._cache[sig] = []
                elif self._all_fast(known, spec.before):
                    live.append((sig, "kc", known, spec.before))
                else:
                    slow.append((sig, known, spec.before, spec.by))
            else:
                sig = ("mc", frozenset(known))
                if not known or not self.txns:
                    self._cache[sig] = None
                else:
                    live.append((sig, "mc", known, None))
        for sig, known, before, by in slow:
            self._cache[sig] = self._slow_hits(by, known, before)
        if not live:
            return
        b = len(live)
        if self._use_service(b):
            # futures path: the window's consults submit as ONE ragged batch
            # into the persistent service; nothing dispatches until the first
            # cached answer is DEMANDED (a fully-invalidated window costs
            # zero launches), and every answer is computed against the index
            # snapshot pinned here (service.begin_window) — byte-identical
            # to the eager path, since the cache exactness rules only serve
            # answers whose inputs did not change since the prefetch
            self._flush()
            svc = self.service()
            svc.begin_window()
            for sig, op, known, before in live:
                cols = [self.key_slot[rk] for rk in known]
                if op == "kc":
                    # txn_lanes: the querying TxnId in the ConsultBatch's
                    # txn_rows attribution lanes — the field the ragged
                    # ingress contract reserved for the columnar protocol
                    # batches (device_service/batch.py doc; the kernel does
                    # not read it, so answers are unchanged)
                    self._cache[sig] = svc.submit(
                        cols, _pack_before(before), int(sig[1].kind),
                        txn_lanes=sig[1].pack_lanes(),
                        post=self._post_kc(known))
                else:
                    self._cache[sig] = svc.submit(
                        cols, (0, 0, 0, 0, 0), 0, post=_post_mc)
            if not svc.deferred:
                # host fallback: no pinned snapshot — answer the window NOW
                # so mid-window mutations cannot leak into (and duplicate
                # against) the cache's delta patching
                svc.flush_window()
            return
        q = np.zeros((b, self._k), dtype=np.int8)
        before_lanes = np.zeros((b, TS_LANES), dtype=np.int32)
        kind = np.zeros((b,), dtype=np.int8)
        for i, (sig, op, known, before) in enumerate(live):
            for rk in known:
                q[i, self.key_slot[rk]] = 1
            if op == "kc":
                before_lanes[i] = _pack_before(before)
                kind[i] = int(sig[1].kind)
        deps, max_lanes = self._consult(q, before_lanes, kind)
        for i, (sig, op, known, _before) in enumerate(live):
            if op == "kc":
                self._cache[sig] = self._attribute(deps[i], set(known))
            else:
                ts = Timestamp.unpack_lanes(tuple(int(v) for v in max_lanes[i]))
                self._cache[sig] = None if ts == Timestamp.NONE else ts

    def end_batch(self) -> None:
        self._cache = None
        self._cache_dirty = {}
        self._cache_hard = set()
        if self._service_obj is not None:
            self._service_obj.end_window()

    def _use_service(self, b: int) -> bool:
        """Route this window/batch through the persistent device service?
        Same cost gate as the device tier (the service IS the device tier
        when enabled)."""
        if not self.service_enabled:
            return False
        if self.tier == "device":
            return True
        return self.tier == "auto" \
            and b * self._t * self._k >= self._device_threshold()

    def _post_kc(self, known):
        """Attribution post-processor for a deferred kc consult (applied at
        demand time; exactness of demand-time attribution is guaranteed by
        the cache dirty/hard rules — any input change forces a fallback)."""
        known_set = set(known)

        def post(raw):
            return self._attribute(raw[0], known_set)
        return post

    def _fast(self, rk: RoutingKey, before: Timestamp) -> bool:
        """Covered bits implement elision exactly for this (key, bound) iff
        the bound is above the covering bound E_k."""
        e_k = self.key_maxw.get(rk)
        return e_k is None or e_k < before

    def _all_fast(self, known, before: Timestamp) -> bool:
        return all(self._fast(rk, before) for rk in known)

    def _cached(self, sig, known, exempt: Optional[TxnId],
                before: Optional[Timestamp]):
        """A cached answer, made exact against mutations since the prefetch
        (module doc): hard keys and pre-existing upgrades fall back; NEW-txn
        dirt is patched; patching requires the bound above E_k (kc only;
        before=None means mc, where elision never applies).

        Returns (hit, answer, delta_ids); (False, None, None) on fallback."""
        if self._cache is None:
            return False, None, None
        if sig not in self._cache:
            self.prefetch_misses += 1
            return False, None, None
        delta_ids: Set[TxnId] = set()
        dirty = self._cache_dirty
        hard = self._cache_hard
        if dirty or hard:
            pre = self._prefetch_preexisting
            for rk in known:
                if rk in hard:
                    self.prefetch_misses += 1
                    return False, None, None
                for d in dirty.get(rk, ()):
                    if d == exempt and d in pre:
                        # upgrade of the querying txn itself: kc-invariant
                        # (txn_id/kind static, stays eligible; key additions
                        # to pre-existing txns nuke the cache in register)
                        continue
                    if d in pre or d not in self.txns:
                        self.prefetch_misses += 1
                        return False, None, None
                    if before is not None and not self._fast(rk, before):
                        self.prefetch_misses += 1
                        return False, None, None
                    # NEW txns — including the querying txn itself, which the
                    # CPU oracle's cfk walk also reports when txn_id < before
                    # (the Accept deps walk at before=executeAt) — are patched
                    # from the mirrors under the exact same predicates
                    delta_ids.add(d)
        ans = self._cache[sig]
        if isinstance(ans, AsyncResult):
            # deferred service consult: first demand dispatches the whole
            # window in one launch; memoize so repeated hits stay O(1)
            ans = ans.result()
            if ans is None:
                # superseded-window safety net fired: no answer — fall back
                self.prefetch_misses += 1
                return False, None, None
            self._cache[sig] = ans
        if delta_ids:
            self.prefetch_patched += 1
        else:
            self.prefetch_hits += 1
        return True, ans, delta_ids

    # -- execution-frontier plane ---------------------------------------------
    def is_indexed(self, txn_id: TxnId) -> bool:
        return txn_id in self.txns

    def register_waiting(self, waiter: TxnId, deps) -> None:
        self.edges[waiter] = set(deps)

    def remove_waiting(self, waiter: TxnId, dep: TxnId) -> None:
        s = self.edges.get(waiter)
        if s is not None:
            s.discard(dep)

    def note_terminal(self, txn_id: TxnId, invalidated: bool = False) -> None:
        """Terminal-transition mirror update, DECOUPLED from key indexing
        (see DepsResolver.note_terminal).  The live witness path misses
        terminal transitions in three shapes — cfk refuses demoted-cold /
        pruned entries, truncation never calls register_witness, and GC's
        physical erase deletes the command outright — each of which left the
        mirror status at STABLE so the kernel frontier reported the slot
        ready forever (the KNOWN_ISSUES device-only parity violation).

        Only frontier-relevant state moves: the status code and the txn's
        own wait edges.  Deps-plane answers are untouched — APPLIED has the
        same join eligibility as STABLE, and INVALIDATED is gated by
        cfk.update's committed-never-invalidated rule exactly like
        ``register`` (it only fires where the cfk walk also excludes the
        entry: never-committed, or already demoted/pruned out of the hot
        set), so cpu/tpu query parity is preserved."""
        self.edges.pop(txn_id, None)   # a terminal txn is no longer a waiter
        m = self.txns.get(txn_id)
        if m is None:
            return
        committed_i, invalidated_i = _status_codes()
        if invalidated:
            if m.status < committed_i:
                m.status = invalidated_i
                self._dirty_txns.add(txn_id)
                # eligibility changed mid-window: cached prefetch answers
                # predate it (rare — only cfk-refused invalidations land here)
                self._cache = None
        else:
            applied_i = _applied_code()
            if m.status < applied_i:
                m.status = applied_i
                self._dirty_txns.add(txn_id)

    def frontier_ready(self) -> Set[TxnId]:
        """The execution frontier as ONE kernel pass
        (ops.frontier_kernels.kahn_frontier_edges over the mirrored wait
        graph): every indexed STABLE txn whose remaining wait edges all
        point at done/evicted slots.  Edges to txns outside the index (range
        txns, cross-epoch deps) conservatively block their waiter.  This is
        the batch-executor view of the same frontier the event-driven
        WaitingOn drains one notification at a time (Commands.java:617-775);
        the burn harness asserts the two agree at quiescent points.

        The wait graph is COMPACTED to the slots that participate in edges
        and handed to the frontier tier as CSR edge arrays — the previous
        dense formulation materialized a pow2 [n, n] adjacency per release
        tick and ran a matmul over it, quadratic in the involved set for a
        graph that is sparse by construction (elision bounds deps to
        concurrency)."""
        from ..ops import frontier_kernels as fk
        self._flush()
        h = self._h
        stable_i = 4   # ops.graph_state.STABLE == cfk.InternalStatus.STABLE
        involved: List[int] = []
        pos: Dict[int, int] = {}

        def slot_of(tid: TxnId) -> Optional[int]:
            m = self.txns.get(tid)
            return None if m is None else m.slot

        edge_pairs: List[Tuple[int, int]] = []
        external_waiters: Set[int] = set()
        for waiter, deps in self.edges.items():
            ws = slot_of(waiter)
            if ws is None or not deps:
                continue
            for d in deps:
                ds = slot_of(d)
                if ds is None:
                    external_waiters.add(ws)
                else:
                    edge_pairs.append((ws, ds))
        for a, b in edge_pairs:
            for s in (a, b):
                if s not in pos:
                    pos[s] = len(involved)
                    involved.append(s)
        for s in external_waiters:
            if s not in pos:
                pos[s] = len(involved)
                involved.append(s)
        ready_ids: Set[TxnId] = set()
        # stable slots with no wait edges at all are ready outright
        waiting_slots = {a for a, _ in edge_pairs} | external_waiters
        for s in np.nonzero(h["active"] & (h["status"] == stable_i))[0]:
            s = int(s)
            if s not in waiting_slots and s in self.txn_at:
                ready_ids.add(self.txn_at[s])
        if involved:
            idx = np.asarray(involved)
            src = np.fromiter((pos[a] for a, _ in edge_pairs),
                              dtype=np.int32, count=len(edge_pairs))
            dst = np.fromiter((pos[b] for _, b in edge_pairs),
                              dtype=np.int32, count=len(edge_pairs))
            ready = fk.frontier_ready_from_edges(
                src, dst, h["status"][idx], h["active"][idx],
                device=self.device())
            for i in np.nonzero(ready)[0]:
                s = involved[int(i)]
                if s not in external_waiters and s in self.txn_at:
                    ready_ids.add(self.txn_at[s])
        return ready_ids

    def _use_walk(self, width: Optional[int] = None) -> bool:
        if self.tier == "auto":
            if len(self.txns) <= self._walk_max:
                return True
            # the flat-cost redesign (cold-tier demotion) makes the scalar
            # cfk walk O(hot-set) per key REGARDLESS of index size: narrow
            # queries always walk; only wide footprints amortize a dense
            # O(T*K) vectorized pass (measured: at T=65k the dense host pass
            # collapses to ~60 q/s while the walk holds thousands)
            return width is not None and width <= self._walk_width
        return self.tier == "walk"

    def _walk_tier(self) -> DepsResolver:
        """The scalar per-key cfk walk (the oracle itself) as the smallest
        rung of the cost ladder — at shallow indexes its near-zero constant
        factor beats any vectorized pass."""
        if self._walk is None:
            from .resolver import CpuDepsResolver
            self._walk = CpuDepsResolver(self.store)
        self.walk_consults += 1
        return self._walk

    # -- queries -------------------------------------------------------------
    def key_conflicts(self, by: TxnId, keys, before: Timestamp):
        # O(1) gen probe BEFORE any cached hit: a mid-window durability
        # advance widens the elision gate and invalidates prefetched answers
        self._maybe_resweep_durable()
        known = [rk for rk in keys if rk in self.key_slot]
        if not known or not self.txns:
            return []
        if by.kind.is_sync_point:
            # fence queries exclude the per-txn durable elision flag (see
            # CpuDepsResolver.key_conflicts) — the covered bits bake it in,
            # so sync points always take the exact walk
            return self._walk_tier().key_conflicts(by, keys, before)
        if self._use_walk(width=len(known)):
            return self._walk_tier().key_conflicts(by, keys, before)
        hit, ans, delta = self._cached(("kc", by, frozenset(known), before),
                                       known, by, before)
        if hit:
            out = list(ans)
            if delta:
                known_set = set(known)
                wit = by.kind.witnesses
                _, invalidated_i = _status_codes()
                for d in sorted(delta):
                    m = self.txns[d]
                    if m.status == invalidated_i or not wit(TxnKind(m.kind_code)) \
                            or not d.as_timestamp() < before:
                        continue
                    # a NEW committed txn below the covering bound is elided
                    # by the cfk walk too: honor its covered set
                    for rk in (m.keys - m.covered) & known_set:
                        out.append((rk, d))
            return out
        if self._all_fast(known, before):
            q = np.zeros((1, self._k), dtype=np.int8)
            for rk in known:
                q[0, self.key_slot[rk]] = 1
            before_lanes = np.asarray([_pack_before(before)], dtype=np.int32)
            kind = np.asarray([int(by.kind)], dtype=np.int8)
            deps, _ = self._consult(q, before_lanes, kind, want_max=False)
            return self._attribute(deps[0], set(known))
        return self._slow_hits(by, known, before)

    def range_conflicts(self, by: TxnId, rng: Range, before: Timestamp):
        keys = [rk for rk in self.key_slot if rng.contains(rk)]
        return self.key_conflicts(by, keys, before)

    def max_conflict_keys(self, keys) -> Optional[Timestamp]:
        self._maybe_resweep_durable()   # see key_conflicts
        floor: Optional[Timestamp] = None
        for rk in keys:
            f = self.key_mc_floor.get(rk)
            if f is not None and (floor is None or f > floor):
                floor = f

        def with_floor(ts: Optional[Timestamp]) -> Optional[Timestamp]:
            if ts is None:
                return floor
            return ts if floor is None or ts > floor else floor

        known = [rk for rk in keys if rk in self.key_slot]
        if not known or not self.txns:
            return floor
        if self._use_walk(width=len(known)):
            # the walk tier (cfk) carries its own pruned floor already
            return self._walk_tier().max_conflict_keys(keys)
        hit, ans, delta = self._cached(("mc", frozenset(known)), known, None,
                                       None)
        if hit:
            if delta:
                known_set = set(known)
                for d in delta:
                    m = self.txns[d]
                    if m.keys & known_set:
                        c = m.execute_at if not m.execute_at < d.as_timestamp() \
                            else d.as_timestamp()
                        if ans is None or ans < c:
                            ans = c
            return with_floor(ans)
        q = np.zeros((1, self._k), dtype=np.int8)
        for rk in known:
            q[0, self.key_slot[rk]] = 1
        _, lanes = self._consult(q, np.zeros((1, TS_LANES), dtype=np.int32),
                                 np.zeros((1,), dtype=np.int8), want_deps=False)
        ts = Timestamp.unpack_lanes(tuple(int(v) for v in lanes[0]))
        return with_floor(None if ts == Timestamp.NONE else ts)

    def max_conflict_range(self, rng: Range) -> Optional[Timestamp]:
        keys = {rk for rk in self.key_slot if rng.contains(rk)}
        keys |= {rk for rk in self.key_mc_floor if rng.contains(rk)}
        return self.max_conflict_keys(sorted(keys))

    # -- the fused consult: tier dispatch ------------------------------------
    def _consult(self, q: np.ndarray, before: np.ndarray, kind: np.ndarray,
                 want_deps: bool = True, want_max: bool = True):
        """Answer a [B]-query batch: (deps [B, T] bool over the LIVE index,
        max_lanes [B, 5] over the FULL index).  Callers guarantee every deps
        row's bound is above its keys' covering bounds (fast rows).  Host and
        device tiers compute the identical join; the cost model picks by
        B·T·K vs the calibrated launch-amortization threshold."""
        self._flush()
        b = q.shape[0]
        t0 = time.perf_counter()
        try:
            if self.tier == "device" or (
                    self.tier == "auto"
                    and b * self._t * self._k >= self._device_threshold()):
                if self.service_enabled:
                    # the persistent service: incremental buffer refresh +
                    # ragged launch (vs the legacy one-shot whole-index
                    # re-upload below)
                    return self.service().consult_rows(q, before, kind)
                return self._consult_device(q, before, kind)
            return self._consult_host(q, before, kind, want_deps, want_max)
        finally:
            self.consult_wall_s += time.perf_counter() - t0

    def _device_threshold(self) -> float:
        """elems = B·T·K above which the device tier wins: calibrated once
        from a measured launch round-trip and the host tier's element rate."""
        if self._threshold_elems is None:
            override = getattr(self, "config", None)
            override = override.tpu_dispatch_elems if override else None
            if override is not None:
                self._threshold_elems = override
            else:
                self._threshold_elems = _calibrate_threshold(self.device())
        return self._threshold_elems

    def _consult_host(self, q, before, kind, want_deps=True, want_max=True):
        """The join as one vectorized numpy pass (BLAS f32 matmuls — exact for
        0/1 values — + lane-wise lex compares).  Mirrors ops.deps_kernels.
        consult bit-for-bit.  Sparse query batches route to the native C++
        engine (native/consult.cpp) when it is built: protocol queries touch
        1-3 keys, where its O(B·T·k_q) column walk beats the dense O(B·T·K)
        BLAS pass with zero temporaries."""
        if self._host_engine != "numpy":
            from .. import native
            if native.available():   # cached bool: free when not built
                qcols = [np.nonzero(row)[0] for row in q]
                nnz = sum(len(c) for c in qcols)
                if self._host_engine == "native" or nnz <= 8 * len(qcols):
                    self.native_consults += len(qcols)
                    _, invalidated_i = _status_codes()
                    deps, max_lanes = native.consult_batch(
                        self._h, qcols, before, kind, invalidated_i,
                        want_deps=want_deps, want_max=want_max)
                    return deps, max_lanes
        self.host_consults += q.shape[0]
        h = self._h
        if "key_inc_f32" not in h:
            # above the f32-mirror bound: cast per call (the cost model rarely
            # routes here at that scale — device tier amortizes far better)
            h = dict(h)
            h["key_inc_f32"] = np.ascontiguousarray(
                h["key_inc"].T.astype(np.float32))
            h["live_f32"] = np.ascontiguousarray(
                h["live_inc"].T.astype(np.float32))
        committed_i, invalidated_i = _status_codes()
        deps = None
        if want_deps:
            share_live = (q.astype(np.float32) @ h["live_f32"]) > 0.0       # [B,T]
            started = _lex_less(h["txn_id"][None, :, :], before[:, None, :])
            wit = _witnesses()[kind[:, None].astype(np.int64),
                               h["kind"][None, :].astype(np.int64)]
            eligible = h["active"] & (h["status"] != invalidated_i)
            deps = share_live & started & wit & eligible[None, :]
        max_lanes = None
        if want_max:
            share_full = (q.astype(np.float32) @ h["key_inc_f32"]) > 0.0    # [B,T]
            mc_mask = share_full & h["active"][None, :]
            per_slot = np.where(_lex_less(h["ts"], h["txn_id"])[:, None],
                                h["txn_id"], h["ts"])                       # [T,5]
            b = q.shape[0]
            tie = mc_mask
            max_lanes = np.zeros((b, TS_LANES), dtype=np.int64)
            for lane in range(TS_LANES):
                vals = np.where(tie, per_slot[None, :, lane], -1)
                best = vals.max(axis=1)
                tie = tie & (per_slot[None, :, lane] == best[:, None])
                max_lanes[:, lane] = np.maximum(best, 0)
        return deps, max_lanes

    def _consult_device(self, q, before, kind):
        """The consult on the device — the service's own dispatch
        (``device_service.kernel.consult_batch``: one launch for the whole
        batch, both answers read back in one copy) over the buffers
        ``_sync_device`` keeps in the kernels' layout.  The rows go over as
        one ragged batch, padded to power-of-two buckets."""
        from ..device_service.batch import build_batch
        from ..device_service.kernel import consult_batch
        self.device_consults += q.shape[0]
        self._sync_device()
        batch = build_batch([np.nonzero(row)[0] for row in q], before, kind)
        return consult_batch(batch, self._device)

    def _sync_device(self) -> None:
        """Upload the canonical host index to the device if stale (lazy: only
        the device tier pays for device residency), in the layout the
        kernels read (``device_service.index.front_from_host``)."""
        if self._device_clean and self._device is not None:
            return
        from ..device_service.index import front_from_host
        self._device = front_from_host(self._h, self._t, self._k,
                                       self.device())
        self._device_clean = True

    # -- the exact per-key path (bounds at/below the covering bound) ---------
    def _slow_hits(self, by: TxnId, known, before: Timestamp
                   ) -> List[Tuple[RoutingKey, TxnId]]:
        """Per-key vectorized recompute of the covering write FOR THIS BOUND —
        the exact analog of cfk.map_reduce_active's maxCommittedWriteBefore
        search (rare: only bounds at/below E_k take this)."""
        self._flush()
        self.host_consults += 1
        h = self._h
        committed_i, invalidated_i = _status_codes()
        bl = np.asarray(_pack_before(before), dtype=np.int64)
        started = _lex_less(h["txn_id"], bl)                    # [T]
        wit = _witnesses()[int(by.kind), h["kind"].astype(np.int64)]
        eligible = h["active"] & (h["status"] != invalidated_i)
        committed = (h["status"] >= committed_i) & (h["status"] != invalidated_i)
        write_wit = _witnesses()[_WRITE, h["kind"].astype(np.int64)]
        is_w = h["kind"] == _WRITE
        ea_before = _lex_less(h["ts"], bl)                      # [T]
        out: List[Tuple[RoutingKey, TxnId]] = []
        for rk in known:
            col = h["key_inc"][:, self.key_slot[rk]] != 0
            cand = col & started & wit & eligible
            cw = col & committed & is_w & ea_before
            bound = self._durable_majority(rk)
            if cw.any():
                # the covering write = lexicographic max (executeAt, txnId)
                # among committed writes before the bound — BOTH coordinates,
                # matching cfk._covering_write_before (vectorized lexsort:
                # np.lexsort keys are least-significant FIRST)
                idx = np.nonzero(cw)[0]
                combined = np.concatenate([h["ts"][idx], h["txn_id"][idx]],
                                          axis=1)
                best = idx[np.lexsort(combined.T[::-1])[-1]]
                maxcw = h["ts"][best]
                maxcw_tid = h["txn_id"][best]
                # durability gate: (per-txn flag AND witnessed by the cover)
                # OR below the key's majority watermark — bit-identical to
                # cfk.map_reduce_active
                gate = h["durable"] & _lex_less(h["txn_id"], maxcw_tid)
                if bound is not None:
                    bound_lanes = np.asarray(_pack_before(bound), dtype=np.int64)
                    gate = gate | _lex_less(h["txn_id"], bound_lanes)
                elide = committed & _lex_less(h["ts"], maxcw) & write_wit & gate
                cand = cand & ~elide
            for slot in np.nonzero(cand)[0]:
                tid = self.txn_at.get(int(slot))
                if tid is not None:
                    out.append((rk, tid))
        return out

    # -- host index maintenance ----------------------------------------------
    def _attribute(self, mask: np.ndarray, queried: Set[RoutingKey]
                   ) -> List[Tuple[RoutingKey, TxnId]]:
        """Map a [T] slot mask (over the LIVE index) back to (key, TxnId)
        incidences, excluding covered keys.  O(|result|): the array pass did
        the O(T) scan; the host only touches hits."""
        out: List[Tuple[RoutingKey, TxnId]] = []
        for slot in np.nonzero(mask)[0]:
            tid = self.txn_at.get(int(slot))
            if tid is None:
                continue
            m = self.txns[tid]
            keys = (m.keys - m.covered) if m.covered else m.keys
            for rk in keys & queried:
                out.append((rk, tid))
        return out

    def _alloc_slot(self) -> int:
        if not self.free_slots:
            self._grow(txns=True)
        slot = heapq.heappop(self.free_slots)
        if slot > self._max_slot:
            self._max_slot = slot   # occupancy watermark (service view extent)
        return slot

    def _alloc_key_slot(self) -> int:
        if not self.free_key_slots:
            self._grow(txns=False)
        slot = heapq.heappop(self.free_key_slots)
        if slot > self._max_key_slot:
            self._max_key_slot = slot
        return slot

    def _grow(self, txns: bool) -> None:
        """Double capacity and rebuild the index arrays from host mirrors."""
        if txns:
            self.free_slots = list(range(self._t, self._t * 2))
            heapq.heapify(self.free_slots)
            self._t *= 2
        else:
            self.free_key_slots = list(range(self._k, self._k * 2))
            heapq.heapify(self.free_key_slots)
            self._k *= 2
        self._rebuild()

    def _rebuild(self) -> None:
        """Full rebuild of the canonical arrays (capacity growth only — rare,
        amortised)."""
        t, k = self._t, self._k
        key_inc = np.zeros((t, k), dtype=np.int8)
        live_inc = np.zeros((t, k), dtype=np.int8)
        ts = np.zeros((t, TS_LANES), dtype=np.int32)
        txn_id = np.zeros((t, TS_LANES), dtype=np.int32)
        kind = np.zeros((t,), dtype=np.int8)
        status = np.zeros((t,), dtype=np.int8)
        active = np.zeros((t,), dtype=np.bool_)
        durable = np.zeros((t,), dtype=np.bool_)
        for tid, m in self.txns.items():
            cols = [self.key_slot[rk] for rk in m.keys]
            key_inc[m.slot, cols] = 1
            live_cols = [self.key_slot[rk] for rk in m.keys - m.covered]
            live_inc[m.slot, live_cols] = 1
            ts[m.slot] = m.execute_at.pack_lanes()
            txn_id[m.slot] = tid.pack_lanes()
            kind[m.slot] = m.kind_code
            status[m.slot] = m.status
            active[m.slot] = True
            durable[m.slot] = m.durable
        self._h = {"key_inc": key_inc, "live_inc": live_inc,
                   "ts": ts, "txn_id": txn_id, "kind": kind, "status": status,
                   "active": active, "durable": durable}
        if t <= self._f32_max:
            # persistent transposed f32 mirrors for the BLAS host tier; above
            # the bound the host tier casts per call (memory budget: the
            # canonical index stays 2 × T×K int8 bytes)
            # C-contiguous: the native engine streams these rows (a .T view
            # would make astype F-contiguous and force a full copy per call)
            self._h["key_inc_f32"] = np.ascontiguousarray(
                key_inc.T.astype(np.float32))
            self._h["live_f32"] = np.ascontiguousarray(
                live_inc.T.astype(np.float32))
        self._device_clean = False
        self._dirty_rows = None   # shapes changed: the service re-uploads
        self._dirty_txns.clear()
        self._clear_bits.clear()
        self._deactivate.clear()
        self._live_ops.clear()

    def _flush(self) -> None:
        """Apply buffered mutations to the canonical host arrays (in-place row
        writes — O(rows changed)); the device copy goes stale and re-syncs
        lazily if/when the device tier is next chosen."""
        self._maybe_resweep_durable()
        if self._h is None:
            self._rebuild()
            return
        if not (self._dirty_txns or self._clear_bits or self._deactivate
                or self._live_ops):
            return
        if self._dirty_rows is not None:
            # row provenance for the service's incremental buffer refresh
            # (collected BEFORE the buffers below are consumed)
            self._dirty_rows.update(row for row, _ in self._clear_bits)
            self._dirty_rows.update(self._deactivate)
            self._dirty_rows.update(self.txns[tid].slot
                                    for tid in self._dirty_txns)
            self._dirty_rows.update(op[0] for op in self._live_ops)
        h = self._h
        f32 = "key_inc_f32" in h
        # order matters: clears and deactivations target OLD occupants of a
        # slot; inserts (which may recycle that same slot) must land last
        for row, col in self._clear_bits:
            h["key_inc"][row, col] = 0
            h["live_inc"][row, col] = 0
            if f32:
                h["key_inc_f32"][col, row] = 0.0
                h["live_f32"][col, row] = 0.0
        self._clear_bits.clear()
        if self._deactivate:
            d = np.asarray(self._deactivate, dtype=np.int32)
            h["active"][d] = False
            h["key_inc"][d] = 0
            h["live_inc"][d] = 0
            if f32:
                h["key_inc_f32"][:, d] = 0.0
                h["live_f32"][:, d] = 0.0
            h["status"][d] = 0
            h["durable"][d] = False
            self._deactivate.clear()
        for tid in sorted(self._dirty_txns):    # deterministic flush order
            m = self.txns[tid]
            row = m.slot
            h["key_inc"][row] = 0
            h["live_inc"][row] = 0
            cols = [self.key_slot[rk] for rk in m.keys]
            h["key_inc"][row, cols] = 1
            live_cols = [self.key_slot[rk] for rk in m.keys - m.covered]
            h["live_inc"][row, live_cols] = 1
            if f32:
                h["key_inc_f32"][:, row] = 0.0
                h["live_f32"][:, row] = 0.0
                h["key_inc_f32"][cols, row] = 1.0
                h["live_f32"][live_cols, row] = 1.0
            h["ts"][row] = m.execute_at.pack_lanes()
            h["txn_id"][row] = tid.pack_lanes()
            h["kind"][row] = m.kind_code
            h["status"][row] = m.status
            h["active"][row] = True
            h["durable"][row] = m.durable
        self._dirty_txns.clear()
        # chronological cover/uncover flips: rows written above already carry
        # the final covered state, so replaying (whose last op per incidence
        # IS the final state) is consistent; flips on un-dirty rows apply here
        for row, col, val in self._live_ops:
            if h["key_inc"][row, col]:      # incidence may have pruned since
                h["live_inc"][row, col] = val
                if f32:
                    h["live_f32"][col, row] = float(val)
        self._live_ops.clear()
        self._device_clean = False

    # -- introspection (tests / bench) ---------------------------------------
    def host_index(self) -> dict:
        self._flush()
        return self._h

    def indexed_count(self) -> int:
        return len(self.txns)


_CALIBRATED: Dict[str, float] = {}


def _calibrate_threshold(device) -> float:
    """Measure one device consult round trip (launch, result copy back) on
    ``device`` and the host tier's element rate; the device tier is worth it
    above elems ≈ host_rate × round_trip.  Once per device per process (one
    measurement serves every store's resolver)."""
    from ..device_service.batch import build_batch
    from ..device_service.index import front_from_host
    from ..device_service.kernel import consult_batch
    key = str(device)
    if key in _CALIBRATED:
        return _CALIBRATED[key]
    t, k, b = 256, 64, 8
    zeros = np.zeros
    s = front_from_host({"key_inc": zeros((t, k), np.int8),
                         "live_inc": zeros((t, k), np.int8),
                         "ts": zeros((t, TS_LANES), np.int32),
                         "txn_id": zeros((t, TS_LANES), np.int32),
                         "kind": zeros((t,), np.int8),
                         "status": zeros((t,), np.int8),
                         "active": zeros((t,), np.bool_)}, t, k, device)

    def round_trip():
        # what _consult_device does per batch: one key per row, the batch
        # uploaded, one launch, both answers copied back in one copy
        consult_batch(build_batch([(i,) for i in range(b)],
                                  zeros((b, TS_LANES), np.int32),
                                  zeros((b,), np.int8)), s)

    round_trip()                               # first use (kernel build)
    t0 = time.perf_counter()
    round_trip()
    rtt = time.perf_counter() - t0
    # host tier: ~f32 BLAS matmul; measure a representative pass
    hq = np.random.default_rng(0)
    a = (hq.random((256, 512)) < 0.1).astype(np.float32)
    m = (hq.random((512, 4096)) < 0.1).astype(np.float32)
    t0 = time.perf_counter()
    for _ in range(3):
        _ = a @ m
    host_rate = 3 * a.shape[0] * a.shape[1] * m.shape[1] \
        / (time.perf_counter() - t0)
    _CALIBRATED[key] = max(1e6, host_rate * rtt)
    return _CALIBRATED[key]


def warm_device_tier(config, kind: str) -> None:
    """Pay the device tier's one-time start-up now: the torch import, the
    device's context, the kernel library and the consult path's first use.
    The cost model's calibration does all of that (one small index uploaded,
    K12 launched twice) and caches its threshold for every
    resolver.  A server on real time calls this before it takes requests:
    paid inside its first consult, these seconds stall its event loop past
    its own message timeouts.  ``kind`` is the node's resolver; nothing is
    paid where no consult reaches the device: another resolver, the host or
    walk tier, or a forced device tier whose consult service answers on the
    host."""
    host_service = config.tpu_service != "off" \
        and config.tpu_service_backend == "host"
    if kind in ("tpu", "verify") and (
            config.tpu_tier == "auto"
            or (config.tpu_tier == "device" and not host_service)):
        from ..device import resolve_device
        _calibrate_threshold(resolve_device(config.device))
