"""BatchEngine — per-store vectorized passes over the TxnBatch mirror.

Every pass obeys the exact-skip contract (package doc): it either answers a
pure read bit-identically, or skips scalar work it can PROVE is a no-op,
falling back to the scalar path whenever the mirror cannot prove it.  The
proofs are local and documented per method; tests/test_protocol_batch.py
property-checks each one against the scalar code, and the hostile-burn
on-vs-off byte-identity test seals the whole engine end to end.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..local.status import SaveStatus, Status
from ..primitives.timestamp import TxnId, TxnKind
from .columns import (ENGAGE_FLOOR, F_AWAITS_ONLY, F_HAS_EA, F_PRE_COMMITTED,
                      F_TRUNCATED, TxnBatch, lanes_lt, pack_order_lanes)

_APPLIED_ORD = SaveStatus.APPLIED.ordinal
_PRE_APPLIED_ORD = SaveStatus.PRE_APPLIED.ordinal
_INVALIDATED = SaveStatus.INVALIDATED
_STABLE_ORD = SaveStatus.STABLE.ordinal


def columnar_enabled(config) -> bool:
    """Resolve the ``columnar`` knob: auto|on -> True, off -> False."""
    mode = getattr(config, "columnar", "auto") if config is not None else "auto"
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"columnar must be auto|on|off, got {mode!r}")
    return mode != "off"


def make_engine(store) -> Optional["BatchEngine"]:
    """Build a store's engine per its node's config knob (None = off: every
    legacy code path stays untouched)."""
    config = getattr(store.node, "config", None)
    return BatchEngine(store) if columnar_enabled(config) else None


class BatchEngine:
    """One per CommandStore (constructed with it, dies with it — restart
    incarnations start a fresh mirror, like the resolver)."""

    __slots__ = ("store", "batch", "stats", "_key_slots")

    def __init__(self, store):
        self.store = store
        self.batch = TxnBatch()
        # key -> slot column for the ConsultBatch ingress (first-witness
        # order, like the device resolver's slot allocator)
        self._key_slots: Dict[object, int] = {}
        # wall-plane effectiveness counters (deterministic given a trajectory;
        # surfaced in burn stats as columnar_* keys)
        self.stats: Dict[str, int] = {
            "release_scans": 0,        # batched listener fan-outs taken
            "release_skipped": 0,      # scalar waiter visits proven no-op
            "release_visited": 0,      # scalar waiter visits still taken
            "poll_scans": 0,           # vectorized progress-log gathers
            "poll_fast": 0,            # monitored ids settled from the mirror
            "frontier_scans": 0,       # vectorized still-blocks gathers
            "frontier_fast": 0,        # deps answered from the mirror
            "ingress_windows": 0,      # delivery windows fed to the resolver
            "ingress_rows": 0,         # declared deps queries across them
            "exec_release_scans": 0,   # frontier release-tick partitions
            "exec_release_fast": 0,    # parked ids answered from the mirror
        }

    # -- mirror maintenance (fed from the transition choke points) -----------
    def note_transition(self, cmd) -> None:
        self.batch.update_from(cmd)

    def note_fault_in(self, cmd) -> None:
        """A cache-miss reload made an evicted command resident again."""
        self.batch.update_from(cmd)

    def note_waiting(self, cmd) -> None:
        w = cmd.waiting_on
        self.batch.note_waiting(cmd.txn_id, len(w.waiting) if w is not None
                                else 0)

    def key_slot(self, rk) -> int:
        slot = self._key_slots.get(rk)
        if slot is None:
            slot = self._key_slots[rk] = len(self._key_slots)
        return slot

    def note_keys(self, txn_id: TxnId, key_slots: Sequence[int]) -> None:
        self.batch.set_keys(txn_id, key_slots)

    def drop(self, txn_id: TxnId) -> None:
        """The command left residency (evict / GC erase)."""
        self.batch.drop(txn_id)

    # -- waiting-graph release fan-out (notify_listeners) ---------------------
    def release_skip_mask(self, dep, listener_ids: List[TxnId]):
        """The batched ``remove_waiting`` fan-out prefilter: given a dep that
        just changed and the waiter ids listening on it, return a boolean
        skip mask (True = the scalar ``update_dependency_and_maybe_execute``
        call is PROVABLY a no-op and may be skipped), or None when no skip is
        possible (the caller runs the scalar loop for everyone).

        Proof of the skip (mirrors commands._still_blocks +
        _maybe_defer_execute_at_least exactly):

        - the dep is live here (not READ-kind, not cold, not terminal) — in
          every such state ``_still_blocks`` returns True for a waiter
          unless the dep is PRE_COMMITTED with effective executeAt >= the
          waiter's executeAt;
        - a skipped waiter is NOT awaits-only-deps (so ``_maybe_defer``
          cannot mutate it) and its mirror row is STABLE/PRE_APPLIED with a
          known executeAt (set at that transition; nothing mutates it after
          PRE_COMMITTED without a transition);
        - therefore the scalar call would read state and return without any
          mutation, observation, RNG draw, or fault-in.

        The caller must re-validate the dep snapshot between scalar visits
        (``release_snapshot``): a cascade can advance the dep mid-fan-out,
        at which point the remaining skips are no longer proven.
        """
        kind = dep.txn_id.kind
        if kind is TxnKind.READ:
            return None    # read deps never block: everyone may unblock
        ss = dep.save_status
        if ss is _INVALIDATED or ss.is_truncated \
                or ss.ordinal >= _APPLIED_ORD:
            return None    # terminal: everyone may unblock
        if dep.txn_id in self.store.cold:
            return None    # answered from the cold set: everyone may unblock
        batch = self.batch
        rows, known = batch.rows_for(listener_ids)
        flags = batch.flags[rows]
        status = batch.status[rows]
        # provable skip requires: known row, not awaits-only, executeAt
        # recorded at a STABLE/PRE_APPLIED transition (fresh by construction)
        eligible = known & ((flags & F_AWAITS_ONLY) == 0) \
            & ((flags & F_HAS_EA) != 0) \
            & ((status == _STABLE_ORD) | (status == _PRE_APPLIED_ORD))
        if not dep.has_been(Status.PRE_COMMITTED):
            # dep undecided: _still_blocks is True for every non-awaits
            # waiter and _maybe_defer no-ops (it also gates on PRE_COMMITTED)
            skip = eligible
        else:
            dep_ea = dep.effective_execute_at()
            if dep_ea is None:
                skip = eligible
            else:
                # _still_blocks unblocks when dep_ea >= waiter_ea, so the
                # PROVEN-blocked set is waiter_ea STRICTLY greater
                from .columns import lanes_le
                skip = eligible & ~lanes_le(batch.ea[rows],
                                            pack_order_lanes(dep_ea))
        self.stats["release_scans"] += 1
        n_skip = int(skip.sum())
        self.stats["release_skipped"] += n_skip
        self.stats["release_visited"] += len(listener_ids) - n_skip
        return skip if n_skip else None

    @staticmethod
    def release_snapshot(dep) -> tuple:
        """The dep fields the skip proof depends on; compared between scalar
        visits — any change invalidates the remaining skips."""
        return (dep.save_status, dep.execute_at, dep.execute_at_least)

    # -- frontier-driven execution (the exec_deferred release tick) -----------
    def exec_deferred_partition(self, ids: List[TxnId]
                                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Partition a frontier release tick's parked ids in ONE gather over
        the mirror's status column: (known, stable) masks.  ``known & ~
        stable`` rows are RESIDENT commands whose SaveStatus provably moved
        past STABLE — the release task may discard them without the scalar
        ``get_if_exists`` + status check (that visit reads two fields and
        returns; skipping it cannot change the trajectory).  ``~known`` rows
        (never mirrored, or evicted — residency tracking follows eviction in
        both directions) MUST take the scalar path: for them ``get_if_
        exists`` can fault in, which is an observable store event the skip
        contract is not allowed to elide.  Returns None below the
        engagement floor (scalar loop wins there)."""
        if len(ids) < ENGAGE_FLOOR:
            return None
        rows, known = self.batch.rows_for(ids)
        stable = known & (self.batch.status[rows] == _STABLE_ORD)
        self.stats["exec_release_scans"] += 1
        self.stats["exec_release_fast"] += int((known & ~stable).sum())
        return known, stable

    # -- frontier-init dependency classification (initialise_waiting_on) ------
    def still_blocks_mask(self, dep_ids: List[TxnId], execute_at,
                          awaits_only: bool):
        """Vectorized ``_still_blocks`` for the frontier-init scan: returns
        (blocks, decided) bool arrays — ``decided[i]`` True where the mirror
        PROVES the scalar answer is ``blocks[i]``; undecided entries must
        take the scalar path (unknown row, cold candidates, READ kinds,
        deferred sync points).

        Exactness: _still_blocks(dep) answers
        - False for READ kinds (decided host-side by the caller),
        - False for cold ids (left undecided here: cold membership is a set
          probe the caller already pays),
        - False for terminal rows (mirror status is exact at every
          transition),
        - for PRE_COMMITTED rows (non-awaits-only waiter): False iff
          effective executeAt >= ours.  The mirror carries the TRANSITION
          executeAt; ``execute_at_least`` deferrals move the effective value
          WITHOUT a transition, so rows flagged AWAITS_ONLY (the only kind
          that defers) are left undecided,
        - True otherwise (unwitnessed rows are NOT decided: absence from
          the mirror cannot distinguish never-witnessed from untracked).
        """
        batch = self.batch
        n = len(dep_ids)
        rows, known = batch.rows_for(dep_ids)
        flags = batch.flags[rows]
        status_arr = batch.status[rows]
        truncated = (flags & F_TRUNCATED) != 0
        terminal = truncated | (status_arr == _INVALIDATED.ordinal) \
            | (status_arr >= _APPLIED_ORD)
        blocks = np.ones(n, dtype=bool)
        decided = known & terminal
        blocks[decided] = False
        # READ deps never block (the MVCC read-dep rule is the FIRST scalar
        # check, ahead of every state read): mirrored READ rows decide False;
        # unmirrored ones stay undecided — their scalar call is one kind
        # check, already cheap
        is_read = known & (batch.kind[rows] == int(TxnKind.READ))
        blocks[is_read] = False
        decided = decided | is_read
        if not awaits_only and execute_at is not None:
            pre = known & ~terminal & ~is_read \
                & ((flags & F_PRE_COMMITTED) != 0) \
                & ((flags & F_HAS_EA) != 0) & ((flags & F_AWAITS_ONLY) == 0)
            if pre.any():
                ge = ~lanes_lt(batch.ea[rows], pack_order_lanes(execute_at))
                unblocked = pre & ge
                blocks[unblocked] = False
                decided = decided | pre
        self.stats["frontier_scans"] += 1
        self.stats["frontier_fast"] += int(decided.sum())
        return blocks, decided

    # -- progress-log settlement scan (_poll_in_store) ------------------------
    def settled_partition(self, ids: List[TxnId]) \
            -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One vectorized gather over a monitored-id list: returns
        (done, outcome_known, resident) bool arrays where

        - ``resident[i]``: the mirror holds a fresh row (the command is in
          ``store.commands`` — ``store.lookup`` would be a pure dict hit, so
          skipping it skips no fault-in);
        - ``done[i]``: save_status ordinal >= APPLIED (the poll's ``_done``
          branch);
        - ``outcome_known[i]``: ordinal >= PRE_APPLIED (the poll's
          skip-recovery branch).

        Non-resident ids MUST take the scalar path — their lookup may fault
        evicted state in, and that load is observable store state.
        """
        status_arr, resident = self.batch.status_of(ids)
        done = resident & (status_arr >= _APPLIED_ORD)
        outcome_known = resident & (status_arr >= _PRE_APPLIED_ORD)
        self.stats["poll_scans"] += 1
        self.stats["poll_fast"] += int(outcome_known.sum())
        return done, outcome_known, resident

    def resolved_partition(self, ids: List[TxnId]) \
            -> Tuple[np.ndarray, np.ndarray]:
        """(resolved, resident) for the blocking-monitor map: resolved ==
        progress_log._locally_resolved (APPLIED+ / INVALIDATED / truncated),
        proven only for resident rows."""
        batch = self.batch
        rows, resident = batch.rows_for(ids)
        status_arr = batch.status[rows]
        flags = batch.flags[rows]
        resolved = resident & ((status_arr >= _APPLIED_ORD)
                               | (status_arr == _INVALIDATED.ordinal)
                               | ((flags & F_TRUNCATED) != 0))
        return resolved, resident

    # -- the ConsultBatch ingress bridge --------------------------------------
    def consult_ingress(self, specs, key_slot_of) -> object:
        """Pack a delivery window's declared deps queries (resolver
        QuerySpecs) into ONE ragged ConsultBatch in the device service's
        ingress layout, with the querying TxnIds in the (previously
        reserved) ``txn_rows`` attribution lanes.  Used by the batched
        ingress tests and the ramp bench's layout assertions; the live
        device path consumes the same layout through the service's window
        packing."""
        ids, before_lanes, kinds = [], [], []
        for spec in specs:
            ids.append(spec.by)
            bound = spec.before if spec.before is not None else spec.by
            before_lanes.append(bound.pack_lanes())
            kinds.append(int(spec.by.kind))
            row = self.batch.slot_of.get(spec.by)
            if row is None or row not in self.batch.key_rows:
                self.batch.set_keys(spec.by, [key_slot_of(k)
                                              for k in spec.keys])
        return self.batch.to_consult_batch(ids, before_lanes, kinds)
