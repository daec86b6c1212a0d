"""CommandsForKey — the per-key conflict index and per-key execution manager.

Capability parity with ``accord.local.cfk.CommandsForKey`` (CommandsForKey.java:82-1495):
for every key a CommandStore owns, an ordered index of all transactions that witnessed
the key, used for (a) dependency calculation at PreAccept/Accept (``map_reduce_active``)
and (b) driving execution order of key-domain reads/writes it manages.

Representation notes vs the reference: the reference packs TxnInfo into sorted arrays
with deps-by-omission encoding (divergences in ``missing[]``); this module keeps an
explicit sorted list of TxnInfo entries behind the same interface, with the
accelerator index (impl/tpu_resolver.py) as the batched data plane.

TRANSITIVE DEPENDENCY ELISION (CommandsForKey.java:144-157, mapReduceActive
:925-986): the deps query first establishes the latest committed WRITE whose
executeAt precedes the query bound — every committed txn executing before that
write, and witnessed by it, is transitively ordered by it and is elided from
the answer.  This is what keeps computed deps O(concurrent txns) instead of
O(key history): the covering write stands in for everything it orders.  The
recovery-safety argument is the reference's (doc :146-157): both the covering
write and the elided txn are committed at this replica, so any recovery
coordinator contacting it learns the agreed outcome directly and never needs
to decipher a fast-path decision from the elided dependency's presence.
"""
from __future__ import annotations

import enum
from bisect import bisect_left, insort
from typing import Callable, Dict, List, Optional, TYPE_CHECKING

from ..primitives.keys import RoutingKey
from ..primitives.timestamp import Domain, Timestamp, TxnId, TxnKind
from ..utils.invariants import Invariants, check_state

if TYPE_CHECKING:
    from .command import Command


def manages(txn_id: TxnId) -> bool:
    """CFK tracks txns that are key-domain and globally visible
    (CommandsForKey.java:185-189)."""
    return txn_id.domain is Domain.KEY and txn_id.kind.is_globally_visible


def manages_execution(txn_id: TxnId) -> bool:
    """CFK wholly manages execution of key-domain reads/writes
    (CommandsForKey.java:196-199): other txns need only a dependency on the Key."""
    return txn_id.domain is Domain.KEY and TxnKind.WRITE.witnesses(txn_id.kind)


class InternalStatus(enum.IntEnum):
    """Condensed per-key view of a txn's lifecycle (reference InternalStatus)."""
    TRANSITIVELY_KNOWN = 0   # witnessed only via another txn's deps
    PREACCEPTED = 1
    ACCEPTED = 2             # slow-path accepted (executeAt may move)
    COMMITTED = 3            # executeAt fixed
    STABLE = 4               # deps fixed
    APPLIED = 5
    INVALIDATED = 6


_DECIDED = (InternalStatus.COMMITTED, InternalStatus.STABLE, InternalStatus.APPLIED)


class TxnInfo:
    __slots__ = ("txn_id", "status", "execute_at", "ballot", "durable")

    def __init__(self, txn_id: TxnId, status: InternalStatus,
                 execute_at: Optional[Timestamp] = None, ballot=None):
        self.txn_id = txn_id
        self.status = status
        self.execute_at = execute_at if execute_at is not None else txn_id
        self.ballot = ballot
        # outcome applied at EVERY replica (per-txn InformDurable(UNIVERSAL) /
        # the range durability watermark) — the elision soundness gate
        self.durable = False

    def __lt__(self, other: "TxnInfo") -> bool:
        return self.txn_id < other.txn_id

    def __repr__(self) -> str:
        return f"TxnInfo({self.txn_id!r}, {self.status.name}, @{self.execute_at!r})"


class CommandsForKey:
    """Mutable per-key index (the safe/command-store layer guards all access)."""

    __slots__ = ("key", "by_id", "prune_before", "_max_applied_write",
                 "_max_applied_write_tid", "_unmanaged_waiting",
                 "_committed_writes", "cold", "_cold_max_ea", "_cold_max_tid",
                 "_pruned_max", "_merged_cache")

    def __init__(self, key: RoutingKey):
        self.key = key
        self.by_id: List[TxnInfo] = []          # sorted by txn_id
        self.prune_before: Optional[TxnId] = None
        self._max_applied_write: Optional[Timestamp] = None
        # unmanaged (range/syncpoint) txns registered to be notified when the key's
        # managed txns up to a bound have applied: list of (wait_until_ts, txn_id)
        self._unmanaged_waiting: List[tuple] = []
        # committed-or-later WRITEs sorted by executeAt (fixed at commit) —
        # the covering-write index for transitive elision (the reference's
        # committedByExecuteAt restricted to writes, CommandsForKey.java:929-944)
        # NOTE: retains demoted (cold) writes — maxcw must not recede
        self._committed_writes: List[tuple] = []    # (execute_at, txn_id)
        # the COLD tier: terminal (applied/invalidated) universally-durable
        # entries demoted out of the hot walk.  The hot-only walk is exact
        # for any query bound whose covering write executes after every cold
        # entry (`_cold_max_ea`); stale bounds take the merged walk — the
        # semantics of an unsplit by_id are preserved bit-for-bit, this is
        # purely the O(history) -> O(concurrency) walk-cost fix (the
        # reference bounds the same walk with prunedBefore + loadingPruned,
        # CommandsForKey.java:115-143; we can afford to keep the cold map)
        self.cold: Dict[TxnId, TxnInfo] = {}
        self._cold_max_ea: Optional[Timestamp] = None   # max ea of emittable cold
        self._cold_max_tid: Optional[TxnId] = None      # max tid of emittable cold
        self._pruned_max: Optional[Timestamp] = None    # max ts floor of removed
        self._max_applied_write_tid: Optional[TxnId] = None
        # memo of the cold+hot MERGED walk order (sync-point / stale-bound
        # queries): rebuilding sorted(cold + by_id) per query was
        # O(history log history) PER SYNC-POINT QUERY PER KEY.  Holds
        # TxnInfo REFERENCES, so in-place status upgrades stay visible
        # (txn_id order never changes); any MEMBERSHIP change invalidates
        # (_demote / _prune / hot insert)
        self._merged_cache: Optional[List[TxnInfo]] = None

    # -- lookup -------------------------------------------------------------
    def get(self, txn_id: TxnId) -> Optional[TxnInfo]:
        i = bisect_left(self.by_id, TxnInfo(txn_id, InternalStatus.TRANSITIVELY_KNOWN))
        if i < len(self.by_id) and self.by_id[i].txn_id == txn_id:
            return self.by_id[i]
        return self.cold.get(txn_id)

    def max_hlc(self) -> int:
        return max((info.txn_id.hlc for info in self.by_id), default=0)

    def max_timestamp(self) -> Optional[Timestamp]:
        """Max of txnId/executeAt witnessed on this key (for timestamp proposal).
        ``_pruned_max`` floors the answer past demotion/pruning: a proposal must
        exceed every write the key EVER witnessed, resident or not."""
        out: Optional[Timestamp] = self._pruned_max
        for info in self.by_id:
            c = info.execute_at if info.execute_at > info.txn_id else info.txn_id
            if out is None or c > out:
                out = c
        return out

    # -- registration -------------------------------------------------------
    def update(self, txn_id: TxnId, status: InternalStatus,
               execute_at: Optional[Timestamp] = None) -> bool:
        """Witness / upgrade a txn on this key. Monotonic: status never regresses,
        and execute_at only moves on a status upgrade or while ACCEPTED (the one
        phase where a re-proposal may legitimately change it; ballot gating happens
        upstream in Commands before cfk is told).

        Returns False when the txn is NOT indexed: unmanaged, or at-or-below
        ``prune_before`` and absent — a pruned (applied/invalidated) entry that a
        late message must not resurrect (the pruning protocol's reload guard,
        cfk/CommandsForKey.java:115-143: ids below the prune point are
        implied-applied and served by the RedundantBefore floor deps)."""
        if not manages(txn_id):
            return False
        if txn_id in self.cold:
            # demoted terminal entry: nothing can upgrade it, and a late
            # message must not re-index it (same resurrection guard as the
            # prune path below)
            return False
        probe = TxnInfo(txn_id, status, execute_at)
        i = bisect_left(self.by_id, probe)
        found = i < len(self.by_id) and self.by_id[i].txn_id == txn_id
        if not found and self.prune_before is not None \
                and txn_id <= self.prune_before:
            return False
        if found:
            info = self.by_id[i]
            if status is InternalStatus.INVALIDATED \
                    and info.status in _DECIDED:
                # a committed txn can never be invalidated: a late/erroneous
                # invalidation message must not corrupt the index (the
                # covering-write entries are final from COMMITTED on)
                return True
            if status > info.status:
                was = info.status
                info.status = status
                # executeAt is FINAL from COMMITTED on (the reference's
                # TxnInfo/committedByExecuteAt invariant): only the upgrade
                # that enters the committed lattice may (re)set it
                if execute_at is not None and was < InternalStatus.COMMITTED:
                    info.execute_at = execute_at
                self._maybe_index_committed_write(info, was)
                if self._demotable(info):
                    self.by_id.pop(i)
                    self._demote(info)
            elif (status == info.status and execute_at is not None
                  and status is InternalStatus.ACCEPTED):
                info.execute_at = execute_at
        else:
            self.by_id.insert(i, probe)
            self._merged_cache = None     # membership changed
            self._maybe_index_committed_write(probe, None)
        if status is InternalStatus.APPLIED and txn_id.is_write:
            ea = execute_at if execute_at is not None else txn_id
            if self._max_applied_write is None or ea > self._max_applied_write:
                self._max_applied_write = ea
                self._max_applied_write_tid = txn_id
                self._demote_sweep()   # older durable frontier entries now covered
        return True

    def witness_transitively(self, txn_id: TxnId) -> None:
        if self.get(txn_id) is None:
            self.update(txn_id, InternalStatus.TRANSITIVELY_KNOWN)

    def _maybe_index_committed_write(self, info: TxnInfo,
                                     was: Optional[InternalStatus]) -> None:
        """Track a WRITE's entry into the committed lattice (executeAt is final
        from COMMITTED on, so the by-executeAt position never moves)."""
        if info.txn_id.is_write \
                and info.status in _DECIDED \
                and (was is None or was < InternalStatus.COMMITTED):
            insort(self._committed_writes, (info.execute_at, info.txn_id))

    def max_committed_write_before(self, before: Timestamp) -> Optional[Timestamp]:
        """ExecuteAt of the latest committed WRITE executing strictly before
        ``before`` — the covering write for transitive elision
        (CommandsForKey.java:929-944)."""
        cw = self._covering_write_before(before)
        return cw[0] if cw is not None else None

    def _covering_write_before(self, before: Timestamp) -> Optional[tuple]:
        """(execute_at, txn_id) of the covering write — elision needs BOTH
        coordinates: a covered txn must execute before the cover AND have been
        witnessable by it (txn_id below the cover's), else the cover's own
        global deps never chained through it and eliding it breaks the
        local-apply transitivity fences rely on (round-5 stale-cascade #2:
        a REORDERED covering write — executeAt above, txnId below — elided
        entries it never witnessed)."""
        i = bisect_left(self._committed_writes, (before,)) - 1
        return self._committed_writes[i] if i >= 0 else None

    # -- dependency calculation (the HOT query; CommandsForKey.java:925-1000) ----
    def map_reduce_active(self, before: Timestamp, witnesses: Callable[[TxnId], bool],
                          fn: Callable[[TxnId], None],
                          durable_majority: Optional[TxnId] = None,
                          flag_elision: bool = True) -> None:
        """Visit every active managed txn with txnId < before that the caller's
        kind witnesses — MINUS committed txns transitively covered by the
        latest committed write executing before the bound (elision, module
        doc).  This is the PreAccept/Accept deps query.

        SOUNDNESS GATE (stronger than the reference, whose elision carries an
        unresolved 'prove the correctness of this approach' TODO,
        CommandsForKey.java:956): a txn is elided only when ALSO below
        ``durable_majority`` — the majority-durable watermark for this key.
        Elision removes the txn from later deps, which poisons per-replica
        recovery evidence ('T executed after ours WITHOUT witnessing us'
        would reject our fast path, BeginRecovery.java:329-380) at replicas
        where the elided txn is still undecided.  Majority durability restores
        the quorum argument: every recovery quorum then intersects a replica
        holding the txn APPLIED, so its agreed outcome is always discovered
        before any fast-path deciphering.  The hostile burn demonstrated the
        violation (a fast-committed range read invalidated by elision-poisoned
        evidence) before this gate."""
        cw = self._covering_write_before(before)
        maxcw, maxcw_tid = cw if cw is not None else (None, None)
        entries: List[TxnInfo] = self.by_id
        # the hot-only walk is exact iff every EMITTABLE cold entry would be
        # elided at this bound: flag elision applies (not a sync-point
        # query) and the bound's covering write dominates every cold entry
        # on BOTH coordinates (invalidated cold entries are never emitted)
        hot_only = self._cold_max_ea is None or (
            flag_elision and maxcw is not None
            and self._cold_max_ea < maxcw and self._cold_max_tid < maxcw_tid)
        if self.cold and not hot_only:
            # sync-point query or stale bound — take the merged walk,
            # bit-identical to an unsplit index.  Common bounds from normal
            # txns sit above every cold entry's covering write and walk the
            # hot tier only: O(concurrency), not O(history).  The merged
            # order is memoized (columnar-engine round): every exclusive
            # sync point re-sorted the key's WHOLE history per deps query
            # before this, O(history log history) per fence per key.
            entries = self._merged_cache
            if entries is None:
                entries = self._merged_cache = sorted(
                    list(self.cold.values()) + self.by_id)
        for info in entries:
            if info.txn_id >= before:
                break
            st = info.status
            if st is InternalStatus.INVALIDATED \
                    or st is InternalStatus.TRANSITIVELY_KNOWN:
                continue
            if not witnesses(info.txn_id):
                continue
            if maxcw is not None and st in _DECIDED \
                    and ((flag_elision and info.durable
                          and info.txn_id < maxcw_tid)
                         or (durable_majority is not None
                             and info.txn_id < durable_majority)) \
                    and info.execute_at < maxcw \
                    and TxnKind.WRITE.witnesses(info.txn_id.kind):
                continue    # ordered (and witnessed) by the covering write
            fn(info.txn_id)

    def map_reduce_full(self, fn: Callable[[TxnInfo], None]) -> None:
        for info in self.by_id:
            fn(info)

    # -- execution management ----------------------------------------------
    def next_waiting_to_apply(self) -> Optional[TxnInfo]:
        """Earliest committed-but-unapplied managed txn by executeAt."""
        best: Optional[TxnInfo] = None
        for info in self.by_id:
            if info.status in (InternalStatus.COMMITTED, InternalStatus.STABLE) \
                    and manages_execution(info.txn_id):
                if best is None or info.execute_at < best.execute_at:
                    best = info
        return best

    def blocking_txns(self, txn_id: TxnId, execute_at: Timestamp) -> List[TxnId]:
        """Managed txns that must apply before (txn_id, execute_at) may execute:
        all managed txns with executeAt (or txnId if undecided) < execute_at that are
        not yet applied/invalidated, and which txn_id witnesses-or-is-witnessed-by.

        Undecided txns with lower txnId may still commit with executeAt < ours, so
        they block; committed txns ordered after us do not."""
        out: List[TxnId] = []
        for info in self.by_id:
            if info.txn_id == txn_id:
                continue
            if not manages_execution(info.txn_id):
                continue
            if info.status in (InternalStatus.APPLIED, InternalStatus.INVALIDATED):
                continue
            if info.status in _DECIDED:
                if info.execute_at < execute_at and _conflicts(txn_id, info.txn_id):
                    out.append(info.txn_id)
            else:
                # undecided: blocks iff it could still be ordered before us
                if info.txn_id < execute_at and _conflicts(txn_id, info.txn_id):
                    out.append(info.txn_id)
        return out

    # -- unmanaged registration (CommandsForKey.Unmanaged, :447) -------------
    def register_unmanaged(self, txn_id: TxnId, wait_until: Timestamp) -> None:
        self._unmanaged_waiting.append((wait_until, txn_id))

    def ready_unmanaged(self) -> List[TxnId]:
        """Unmanaged txns whose wait bound is satisfied: every managed txn with
        executeAt <= bound is applied or invalidated."""
        ready, keep = [], []
        for bound, tid in self._unmanaged_waiting:
            if self._all_applied_until(bound):
                ready.append(tid)
            else:
                keep.append((bound, tid))
        self._unmanaged_waiting = keep
        return ready

    def _all_applied_until(self, bound: Timestamp) -> bool:
        for info in self.by_id:
            if not manages_execution(info.txn_id):
                continue
            if info.status in (InternalStatus.APPLIED, InternalStatus.INVALIDATED):
                continue
            at = info.execute_at if info.status in _DECIDED else info.txn_id
            if at <= bound:
                return False
        return True

    # -- per-txn durability + hot/cold demotion ------------------------------
    def _note_removed_max(self, info: TxnInfo) -> None:
        c = info.execute_at if info.execute_at > info.txn_id else info.txn_id
        if self._pruned_max is None or c > self._pruned_max:
            self._pruned_max = c

    def _demotable(self, info: TxnInfo) -> bool:
        """May this entry leave the hot walk?  INVALIDATED entries are never
        emitted/blocking at any bound; APPLIED entries must be universally durable,
        WRITE-witnessed, and strictly below the latest applied write — keeping
        the covering write itself hot guarantees fresh query bounds see
        ``maxcw > _cold_max_ea`` and stay on the O(concurrency) hot walk."""
        if info.status is InternalStatus.INVALIDATED:
            return True
        return (info.status is InternalStatus.APPLIED and info.durable
                and TxnKind.WRITE.witnesses(info.txn_id.kind)
                and self._max_applied_write is not None
                and info.execute_at < self._max_applied_write
                and self._max_applied_write_tid is not None
                and info.txn_id < self._max_applied_write_tid)

    def _demote_sweep(self) -> None:
        """The max applied write advanced: entries that were the frontier when
        flagged durable (applies land roughly in executeAt order, so the
        newest write never passes the cover check at its own apply) are now
        covered — demote them."""
        demoted = False
        keep: List[TxnInfo] = []
        for info in self.by_id:
            if self._demotable(info):
                self._demote(info)
                demoted = True
            else:
                keep.append(info)
        if demoted:
            self.by_id = keep

    def _demote(self, info: TxnInfo) -> None:
        self.cold[info.txn_id] = info
        self._merged_cache = None         # membership changed (hot -> cold)
        self._note_removed_max(info)
        if info.status is not InternalStatus.INVALIDATED:
            ea = info.execute_at
            if self._cold_max_ea is None or ea > self._cold_max_ea:
                self._cold_max_ea = ea
            if self._cold_max_tid is None or info.txn_id > self._cold_max_tid:
                self._cold_max_tid = info.txn_id

    def mark_durable(self, txn_id: TxnId) -> None:
        """The txn's outcome is applied at EVERY replica (per-txn
        InformDurable(UNIVERSAL) after the coordinator saw all Apply acks, or
        a durability watermark advance).  Widens the elision gate for this
        entry NOW — instead of waiting for the next range durability round —
        and demotes it to the cold tier once terminal."""
        i = bisect_left(self.by_id, TxnInfo(txn_id, InternalStatus.TRANSITIVELY_KNOWN))
        if i >= len(self.by_id) or self.by_id[i].txn_id != txn_id:
            return
        info = self.by_id[i]
        info.durable = True
        if self._demotable(info):
            self.by_id.pop(i)
            self._demote(info)

    def mark_durable_below(self, bound: TxnId) -> None:
        """Range durability watermark advance: flag + demote everything below."""
        keep: List[TxnInfo] = []
        for info in self.by_id:
            if info.txn_id < bound:
                info.durable = True
                if self._demotable(info):
                    self._demote(info)
                    continue
            keep.append(info)
        if len(keep) != len(self.by_id):
            self.by_id = keep

    # -- pruning (doc CommandsForKey.java:115-143) ---------------------------
    def _prune(self, prunable: Callable[["TxnInfo"], bool]) -> List[TxnId]:
        """Drop APPLIED/INVALIDATED entries matching ``prunable`` (hot and
        cold tiers); prune_before is retained so late-arriving deps below it
        are treated as already-applied rather than unknown.  Returns the
        pruned ids (the resolver data plane evicts the same incidences)."""
        keep: List[TxnInfo] = []
        pruned: List[TxnId] = []
        highest: Optional[TxnId] = self.prune_before
        for info in self.by_id:
            if info.status in (InternalStatus.APPLIED, InternalStatus.INVALIDATED) \
                    and prunable(info):
                pruned.append(info.txn_id)
                self._note_removed_max(info)
                if highest is None or info.txn_id > highest:
                    highest = info.txn_id
            else:
                keep.append(info)
        for txn_id in [t for t, info in self.cold.items() if prunable(info)]:
            del self.cold[txn_id]
            pruned.append(txn_id)
            if highest is None or txn_id > highest:
                highest = txn_id
        if pruned:
            self.by_id = keep
            self._merged_cache = None     # membership changed
            self.prune_before = highest
            gone = set(pruned)
            self._committed_writes = [e for e in self._committed_writes
                                      if e[1] not in gone]
        return pruned

    def maybe_prune(self, prune_before_hlc_delta: int) -> List[TxnId]:
        """HLC-delta policy prune: drop applied entries well behind the max HLC."""
        if not self.by_id:
            return []
        cutoff_hlc = self.max_hlc() - prune_before_hlc_delta
        return self._prune(lambda info: info.txn_id.hlc < cutoff_hlc)

    def prune_applied_before(self, bound: TxnId) -> List[TxnId]:
        """Bound-driven prune (GC by RedundantBefore): drop applied entries with
        txn_id < bound; they are implied-applied for late arrivals."""
        return self._prune(lambda info: info.txn_id < bound)

    def is_pruned(self, txn_id: TxnId) -> bool:
        # prune_before is the highest pruned id, inclusive
        return self.prune_before is not None and txn_id <= self.prune_before \
            and self.get(txn_id) is None

    def size(self) -> int:
        return len(self.by_id)

    def __repr__(self) -> str:
        return f"CFK({self.key!r}, {len(self.by_id)} txns)"


def _conflicts(a: TxnId, b: TxnId) -> bool:
    return a.witnesses(b) or b.witnesses(a)
