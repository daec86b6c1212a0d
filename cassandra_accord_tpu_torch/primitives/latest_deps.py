"""LatestDeps — phase-aware, per-range dependency evidence for recovery.

Capability parity with ``accord.primitives.LatestDeps`` (LatestDeps.java:1-433):
a recovering coordinator must NOT flat-union deps reported by replicas in
different phases.  A replica that holds STABLE deps for a range holds the
decided set — unioning another replica's freshly-calculated deps on top can
add txns that execute after us (waits that can never be satisfied), and
mixing two Accept-phase proposals from different ballots resurrects a
superseded proposal.  Instead, every RecoverOk carries a per-range map of
(phase, ballot, coordinated deps, local deps); merging selects, per range,
the highest phase (ballot-breaking ties within the Accept phase) and only
unions local deps while the phase still permits it.

Per-range entries (BeginRecovery.java:95-121 construction):
- coordinated: the coordinator-supplied deps the replica holds (accepted or
  committed partialDeps) — authoritative for its phase;
- local: the replica's freshly calculated deps (only while the command has
  no committed/decided deps).

Extraction:
- ``merge_proposal``  — deps for a recovery re-proposal (Accept round):
  PROPOSED ranges use the max-ballot coordinated deps; UNKNOWN ranges union
  the local calculations (LatestDeps.java:341-351).
- ``merge_commit``    — deps for a commit at ``execute_at``: KNOWN/COMMITTED
  ranges use coordinated deps; on the fast path (executeAt == txnId) other
  ranges may substitute the union of coordinated+local deps (equivalent to
  what the original coordinator would have committed); everything else is
  reported insufficient, for the caller to fetch via GetDeps
  (LatestDeps.java:353-383, Recover.java:384-400).
"""
from __future__ import annotations

import enum
from typing import Callable, List, NamedTuple, Optional, Tuple

from ..utils.interval_map import ReducingIntervalMap
from .deps import Deps
from .keys import Range, Ranges
from .timestamp import Ballot, Timestamp, TxnId


class KnownDeps(enum.IntEnum):
    """How far a range's deps knowledge has progressed (Status.KnownDeps)."""
    UNKNOWN = 0     # pre-accept only: local calculation is the best we have
    PROPOSED = 1    # Accept phase: coordinated deps at a ballot
    COMMITTED = 2   # executeAt agreed with these deps
    KNOWN = 3       # Stable+: deps final


class LatestEntry(NamedTuple):
    known: KnownDeps
    ballot: Ballot
    coordinated: Optional[Deps]
    locals_: Tuple[Deps, ...]       # unmerged local calculations (deferred)

    @staticmethod
    def reduce(a: "LatestEntry", b: "LatestEntry") -> "LatestEntry":
        """Pick the higher phase (ballot tie-break within the Accept phase —
        Phase.tieBreakWithBallot); union locals only while phase permits."""
        c = int(a.known) - int(b.known)
        if c == 0 and a.known is KnownDeps.PROPOSED:
            c = a.ballot.compare_to(b.ballot)
        if c < 0:
            a, b = b, a
        if a.known <= KnownDeps.PROPOSED:
            return a._replace(locals_=a.locals_ + b.locals_)
        return a


class LatestDeps:
    """Per-range LatestEntry map (None outside any reported range)."""

    __slots__ = ("map",)

    def __init__(self, imap: Optional[ReducingIntervalMap] = None):
        self.map = imap if imap is not None else ReducingIntervalMap()

    @staticmethod
    def create(ranges: Ranges, known: KnownDeps, ballot: Ballot,
               coordinated: Optional[Deps], local: Optional[Deps]) -> "LatestDeps":
        if not len(ranges):
            return LatestDeps()
        entry = LatestEntry(known, ballot, coordinated,
                            (local,) if local is not None else ())
        pairs = [(r.start, r.end) for r in ranges]
        return LatestDeps(ReducingIntervalMap.of_ranges(pairs, entry))

    def merge(self, other: "LatestDeps") -> "LatestDeps":
        return LatestDeps(self.map.merge(other.map, LatestEntry.reduce))

    @staticmethod
    def merge_all(many) -> "LatestDeps":
        out = LatestDeps()
        for d in many:
            if d is not None:
                out = out.merge(d)
        return out

    # -- extraction -----------------------------------------------------------
    def _fold(self, per_entry: Callable[[Ranges, LatestEntry, List[Deps]], None]
              ) -> List[Deps]:
        parts: List[Deps] = []

        def visit(value, lo, hi, _acc):
            if value is not None and lo is not None and hi is not None:
                per_entry(Ranges.of(Range(lo, hi)), value, parts)
            return _acc

        self.map.foldl_intervals(visit, None)
        return parts

    def merge_proposal(self) -> Deps:
        """Deps for a recovery re-proposal (forProposal, LatestDeps.java:341)."""
        def per_entry(rngs: Ranges, e: LatestEntry, parts: List[Deps]):
            if e.known is KnownDeps.PROPOSED:
                if e.coordinated is not None:
                    parts.append(e.coordinated.slice(rngs))
            elif e.known is KnownDeps.UNKNOWN:
                parts.extend(d.slice(rngs) for d in e.locals_)
            else:
                # commit-grade deps cannot feed a proposal; recovery resumes
                # at stabilise for these ranges instead
                if e.coordinated is not None:
                    parts.append(e.coordinated.slice(rngs))
        return Deps.merge(self._fold(per_entry))

    def merge_commit(self, txn_id: TxnId, execute_at: Timestamp
                     ) -> Tuple[Deps, Ranges]:
        """(deps, sufficient_for) for committing at ``execute_at``
        (forCommit, LatestDeps.java:353-383)."""
        use_local = execute_at == txn_id.as_timestamp()
        sufficient: List[Range] = []

        def per_entry(rngs: Ranges, e: LatestEntry, parts: List[Deps]):
            if e.known in (KnownDeps.KNOWN, KnownDeps.COMMITTED):
                sufficient.extend(rngs)
                if e.coordinated is not None:
                    parts.append(e.coordinated.slice(rngs))
            elif e.known is KnownDeps.PROPOSED:
                # an interrupted commit: on the fast path the accepted deps
                # plus each reply's local calculation equal what the original
                # coordinator would have committed
                if use_local:
                    sufficient.extend(rngs)
                    if e.coordinated is not None:
                        parts.append(e.coordinated.slice(rngs))
                    parts.extend(d.slice(rngs) for d in e.locals_)
            else:
                if use_local:
                    sufficient.extend(rngs)
                    parts.extend(d.slice(rngs) for d in e.locals_)

        parts = self._fold(per_entry)
        return Deps.merge(parts), Ranges.of(*sufficient)

    def __repr__(self) -> str:
        parts: List[str] = []
        self.map.foldl_intervals(
            lambda v, lo, hi, _a: parts.append(f"[{lo},{hi})={v.known.name}")
            if v is not None else None, None)
        return f"LatestDeps({', '.join(parts)})"
