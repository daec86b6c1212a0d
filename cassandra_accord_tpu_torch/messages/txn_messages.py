"""The transaction-pipeline wire messages and their replica-side handlers.

Capability parity with ``accord.messages`` PreAccept/Accept/Commit/Apply/ReadData
(PreAccept.java:37-354, Accept.java:50-296, Commit.java:61-409, Apply.java:47-246,
ReadData.java:53-538): each Request processes itself against the receiving Node by
map-reducing over the intersecting CommandStores, and replies exactly once.

``Commit`` supports the reference's Stable+Read fusion (Commit.stableAndRead,
Commit.java:176): a Commit carrying ``read=True`` executes the txn's read once the
command becomes ReadyToExecute and replies ReadOk instead of a plain ack.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional

from ..local import commands as C
from ..local.cfk import InternalStatus
from ..local.command_store import SafeCommandStore
from ..local.status import SaveStatus, Status
from ..primitives.deps import Deps, DepsBuilder
from ..primitives.keys import Keys, Range, Ranges
from ..primitives.route import Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from ..primitives.txn import PartialTxn, Writes
from ..utils import async_ as au
from .base import MessageType, Reply, Request, TxnRequest

if TYPE_CHECKING:
    from ..local.node import Node


# ---------------------------------------------------------------------------
# deps calculation (PreAccept.calculatePartialDeps, PreAccept.java:245-267)
# ---------------------------------------------------------------------------

def worst_outcome(a, b):
    """Reduce CommitOutcomes to the most severe across stores."""
    order = [C.CommitOutcome.INSUFFICIENT, C.CommitOutcome.REJECTED_BALLOT,
             C.CommitOutcome.REDUNDANT, C.CommitOutcome.SUCCESS]
    return a if order.index(a) < order.index(b) else b


def _txn_query_specs(node, txn_id: TxnId, keys_or_ranges, before: Timestamp,
                     want_max: bool):
    """Declare the deps queries a PreAccept/Accept handler will issue, per
    intersecting store (for delivery-window prefetch).  Key-domain only: range
    txns use the host-side range table, not the resolver's device index."""
    from ..impl.resolver import QuerySpec
    if isinstance(keys_or_ranges, Ranges):
        return None
    rks = []
    seen = set()
    for key in keys_or_ranges:
        rk = key.to_routing() if hasattr(key, "to_routing") else key
        if rk not in seen:
            seen.add(rk)
            rks.append(rk)
    out = []
    for store in node.command_stores.all_stores():
        local = store.current_ranges()
        local_rks = [rk for rk in rks if local.contains(rk)]
        if not local_rks:
            continue
        out.append((store, QuerySpec("kc", txn_id, local_rks, before)))
        if want_max:
            # commands.preaccept passes the UNFILTERED key list to max_conflict
            out.append((store, QuerySpec("mc", None, rks, None)))
    return out


def calculate_partial_deps(safe_store: SafeCommandStore, txn_id: TxnId,
                           keys_or_ranges, before: Timestamp) -> Deps:
    """All active conflicting txns with txnId < before, witnessed by txn_id's kind."""
    builder = DepsBuilder()
    keys = None if isinstance(keys_or_ranges, Ranges) else keys_or_ranges
    ranges = keys_or_ranges if isinstance(keys_or_ranges, Ranges) else None

    def visit(key_or_range, dep_id: TxnId):
        if dep_id != txn_id:
            builder.add(key_or_range, dep_id)

    safe_store.map_reduce_active(keys, ranges, before, txn_id, visit)
    # floor deps: the fence txns standing in for everything elided below them
    # (RedundantBefore.collectDeps, PreAccept.java:264)
    safe_store.redundant_before().collect_deps(keys, ranges, visit)
    return builder.build()


# ---------------------------------------------------------------------------
# replies
# ---------------------------------------------------------------------------

class SimpleOk(Reply):
    __slots__ = ()

    @property
    def type(self):
        return MessageType.SIMPLE_RSP

    def __repr__(self):
        return "Ok"


SIMPLE_OK = SimpleOk()


class PreAcceptOk(Reply):
    __slots__ = ("txn_id", "witnessed_at", "deps")

    def __init__(self, txn_id: TxnId, witnessed_at: Timestamp, deps: Deps):
        self.txn_id = txn_id
        self.witnessed_at = witnessed_at
        self.deps = deps

    @property
    def type(self):
        return MessageType.PRE_ACCEPT_RSP

    @property
    def witnessed_fast_path(self) -> bool:
        return self.witnessed_at == self.txn_id.as_timestamp()

    def __repr__(self):
        return f"PreAcceptOk({self.txn_id!r}@{self.witnessed_at!r})"


class PreAcceptNack(Reply):
    __slots__ = ()

    @property
    def type(self):
        return MessageType.PRE_ACCEPT_RSP

    def __repr__(self):
        return "PreAcceptNack"


class AcceptOk(Reply):
    __slots__ = ("txn_id", "deps")

    def __init__(self, txn_id: TxnId, deps: Deps):
        self.txn_id = txn_id
        self.deps = deps

    @property
    def type(self):
        return MessageType.ACCEPT_RSP

    def __repr__(self):
        return f"AcceptOk({self.txn_id!r})"


class AcceptNack(Reply):
    __slots__ = ("txn_id", "supersceded_by")

    def __init__(self, txn_id: TxnId, supersceded_by: Ballot):
        self.txn_id = txn_id
        self.supersceded_by = supersceded_by

    @property
    def type(self):
        return MessageType.ACCEPT_RSP

    def __repr__(self):
        return f"AcceptNack({self.supersceded_by!r})"


class CommitOk(Reply):
    __slots__ = ()

    @property
    def type(self):
        return MessageType.SIMPLE_RSP

    def __repr__(self):
        return "CommitOk"


COMMIT_OK = CommitOk()


class StableAck(Reply):
    """Immediate non-final ack of the Stable state for a Commit that also carries a
    read: the stable quorum must not wait on read execution (the read legitimately
    blocks on dependencies). The final ReadOk follows on the same correlation id."""
    __slots__ = ()

    @property
    def type(self):
        return MessageType.SIMPLE_RSP

    @property
    def is_final(self):
        return False

    def __repr__(self):
        return "StableAck"


STABLE_ACK = StableAck()


class CommitNack(Reply):
    __slots__ = ("outcome",)

    def __init__(self, outcome):
        self.outcome = outcome

    @property
    def type(self):
        return MessageType.SIMPLE_RSP

    def __repr__(self):
        return f"CommitNack({self.outcome})"


class ReadOk(Reply):
    __slots__ = ("unavailable", "data")

    def __init__(self, data, unavailable: Optional[Ranges] = None):
        self.data = data
        self.unavailable = unavailable

    @property
    def type(self):
        return MessageType.READ_RSP

    def __repr__(self):
        return f"ReadOk(unavailable={self.unavailable})"


class ReadNack(Reply):
    """Invalid / obsolete / redundant read (ReadData.ReadNack)."""
    __slots__ = ("reason",)

    def __init__(self, reason: str):
        self.reason = reason

    @property
    def type(self):
        return MessageType.READ_RSP

    def __repr__(self):
        return f"ReadNack({self.reason})"


class ApplyOk(Reply):
    __slots__ = ()

    @property
    def type(self):
        return MessageType.APPLY_RSP

    def __repr__(self):
        return "ApplyOk"


APPLY_OK = ApplyOk()


# ---------------------------------------------------------------------------
# PreAccept
# ---------------------------------------------------------------------------

class PreAccept(TxnRequest):
    __slots__ = ("partial_txn", "max_epoch", "route")

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int,
                 partial_txn: PartialTxn, max_epoch: int, route: Optional[Route] = None):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.partial_txn = partial_txn
        self.max_epoch = max_epoch
        # the FULL route: replicas store it so recovery/progress machinery can
        # reconstitute the txn footprint (BeginRecovery.java route field /
        # CheckStatus FoundRoute semantics)
        self.route = route if route is not None else scope

    @property
    def type(self):
        return MessageType.PRE_ACCEPT_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id, partial_txn, scope = self.txn_id, self.partial_txn, self.scope

        route = self.route

        def map_fn(safe_store: SafeCommandStore):
            outcome = C.preaccept(safe_store, txn_id, partial_txn, route)
            if outcome in (C.AcceptOutcome.REJECTED_BALLOT, C.AcceptOutcome.TRUNCATED):
                return None
            command = safe_store.get_if_exists(txn_id)
            if command.save_status is SaveStatus.INVALIDATED \
                    or command.execute_at is None:
                # invalidated (or otherwise undecidable) — an Ok here could
                # feed a fast-path decision for a txn that can never commit
                return None
            deps = calculate_partial_deps(safe_store, txn_id, partial_txn.keys,
                                          txn_id.as_timestamp())
            return (command.execute_at, deps)

        def reduce_fn(a, b):
            if a is None or b is None:
                return None
            return (a[0].merge_max(b[0]), a[1].with_merged(b[1]))

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node, reply_context, failure)
            elif result is None:
                node.reply(from_node, reply_context, PreAcceptNack())
            else:
                witnessed_at, deps = result
                node.reply(from_node, reply_context, PreAcceptOk(txn_id, witnessed_at, deps))

        node.map_reduce_consume_local(scope, node.topology.min_epoch, self.max_epoch,
                                      map_fn, reduce_fn,
                                      preload=self.preload_ids()).begin(consume)

    def prefetch_specs(self, node):
        # mirrors the handler's two consults: max_conflict over ALL the txn's
        # keys (commands.preaccept) and the deps walk over the store-local keys
        # (map_reduce_active's by_rk filter), before = txnId
        return _txn_query_specs(node, self.txn_id, self.partial_txn.keys,
                                self.txn_id.as_timestamp(), want_max=True)

    def __repr__(self):
        return f"PreAccept({self.txn_id!r}, {self.scope!r})"


# ---------------------------------------------------------------------------
# Accept (slow path)
# ---------------------------------------------------------------------------

class Accept(TxnRequest):
    __slots__ = ("ballot", "execute_at", "partial_deps", "keys", "route")

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int, ballot: Ballot,
                 execute_at: Timestamp, keys, partial_deps: Deps,
                 route: Optional[Route] = None):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.ballot = ballot
        self.execute_at = execute_at
        self.keys = keys
        self.partial_deps = partial_deps
        self.route = route if route is not None else scope

    @property
    def type(self):
        return MessageType.ACCEPT_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id, ballot, execute_at = self.txn_id, self.ballot, self.execute_at
        scope, keys, partial_deps = self.scope, self.keys, self.partial_deps
        route = self.route

        def map_fn(safe_store: SafeCommandStore):
            outcome = C.accept(safe_store, txn_id, ballot, route, execute_at, partial_deps)
            if outcome is C.AcceptOutcome.REJECTED_BALLOT:
                command = safe_store.get_if_exists(txn_id)
                return ("nack", command.promised)
            if outcome is C.AcceptOutcome.TRUNCATED:
                return ("nack", Ballot.MAX)
            if outcome is C.AcceptOutcome.REDUNDANT:
                # already (pre)committed — possibly at a DIFFERENT executeAt by a
                # recovery coordinator — or invalidated: acking would let the
                # proposer commit a second, conflicting decision (split brain).
                # Reply Redundant→nack so the proposer fails Preempted and the
                # true outcome is learned via CheckStatus
                # (Accept.java:102, Propose.java:104-107)
                return ("nack", Ballot.MAX)
            # collect deps newly witnessed up to executeAt (Accept.java:84-118)
            deps = calculate_partial_deps(safe_store, txn_id, keys, execute_at)
            return ("ok", deps)

        def reduce_fn(a, b):
            if a is None or b is None:
                return None
            if a[0] == "nack":
                return a
            if b[0] == "nack":
                return b
            return ("ok", a[1].with_merged(b[1]))

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node, reply_context, failure)
            elif result is None or result[0] == "nack":
                superseded = result[1] if result is not None else Ballot.MAX
                node.reply(from_node, reply_context, AcceptNack(txn_id, superseded))
            else:
                node.reply(from_node, reply_context, AcceptOk(txn_id, result[1]))

        node.map_reduce_consume_local(scope, node.topology.min_epoch,
                                      execute_at.epoch, map_fn, reduce_fn,
                                      preload=self.preload_ids()).begin(consume)

    def prefetch_specs(self, node):
        # the Accept deps walk runs AFTER the self-registration, whose effect
        # on its own answer is nil (the walk excludes txn_id) — the resolver's
        # self-exemption makes the prefetched answer exact
        return _txn_query_specs(node, self.txn_id, self.keys, self.execute_at,
                                want_max=False)

    def __repr__(self):
        return f"Accept({self.txn_id!r}@{self.execute_at!r})"


# ---------------------------------------------------------------------------
# Commit (slow-path commit / stable, optionally fused with the read)
# ---------------------------------------------------------------------------

class Commit(TxnRequest):
    __slots__ = ("kind_status", "ballot", "partial_txn", "execute_at", "partial_deps",
                 "read", "route")

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int,
                 kind_status: SaveStatus, execute_at: Timestamp,
                 partial_txn: Optional[PartialTxn], partial_deps: Deps,
                 read: bool = False, ballot: Ballot = Ballot.ZERO,
                 route: Optional[Route] = None):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.kind_status = kind_status    # SaveStatus.COMMITTED or SaveStatus.STABLE
        self.ballot = ballot
        self.partial_txn = partial_txn
        self.execute_at = execute_at
        self.partial_deps = partial_deps
        self.read = read
        self.route = route if route is not None else scope

    def preload_ids(self):
        if self.partial_deps is None:
            return (self.txn_id,)
        return (self.txn_id, *self.partial_deps.txn_ids())

    @property
    def type(self):
        return MessageType.STABLE_FAST_PATH_REQ if self.kind_status is SaveStatus.STABLE \
            else MessageType.COMMIT_SLOW_PATH_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id = self.txn_id

        def map_fn(safe_store: SafeCommandStore):
            return C.commit(safe_store, txn_id, self.kind_status, self.ballot, self.route,
                            self.partial_txn, self.execute_at, self.partial_deps)

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node, reply_context, failure)
                return
            if result not in (C.CommitOutcome.SUCCESS, C.CommitOutcome.REDUNDANT):
                node.reply(from_node, reply_context, CommitNack(result))
                return
            if self.read:
                node.reply(from_node, reply_context, STABLE_ACK)
                execute_read(node, from_node, reply_context, txn_id, self.scope,
                             self.execute_at, fallback_txn=self.partial_txn)
            else:
                node.reply(from_node, reply_context, COMMIT_OK)

        node.map_reduce_consume_local(self.scope, node.topology.min_epoch,
                                      self.execute_at.epoch,
                                      map_fn, worst_outcome,
                                      preload=self.preload_ids()).begin(consume)

    def __repr__(self):
        tag = "+read" if self.read else ""
        return f"Commit[{self.kind_status.name}]({self.txn_id!r}{tag})"


# ---------------------------------------------------------------------------
# ReadData / ReadTxnData (standalone read of a committed txn)
# ---------------------------------------------------------------------------

class ReadTxnData(TxnRequest):
    __slots__ = ("execute_at_epoch",)

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int,
                 execute_at_epoch: int):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.execute_at_epoch = execute_at_epoch

    @property
    def type(self):
        return MessageType.READ_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        execute_read(node, from_node, reply_context, self.txn_id, self.scope,
                     None)

    def __repr__(self):
        return f"ReadTxnData({self.txn_id!r})"


def execute_read(node: "Node", from_node: int, reply_context, txn_id: TxnId,
                 scope: Route, execute_at_hint: Optional[Timestamp],
                 fallback_txn=None) -> None:
    """Wait per-store for ReadyToExecute, run the read, merge Data, reply ReadOk
    (ReadData.java:57-260 state machine, collapsed to the wait->execute->reply path)."""
    exec_epoch = execute_at_hint.epoch if execute_at_hint is not None else txn_id.epoch
    stores = node.command_stores.intersecting_stores(scope, txn_id.epoch, exec_epoch)
    if not stores:
        node.reply(from_node, reply_context, ReadNack("no intersecting store"))
        return
    # a replica that no longer owns ANY of the scope at the execution epoch
    # cannot serve this read (topology moved on) — ReadData unavailable
    covered = Ranges.EMPTY
    for store in stores:
        covered = covered.union(store.ranges_at(exec_epoch))
    parts = scope.participants()
    if not covered.intersects(parts):
        node.reply(from_node, reply_context, ReadNack("unavailable"))
        return

    chains = [store.submit(
        lambda s: _read_when_ready(s, txn_id, fallback_txn),
        preload=(txn_id,)).flat_map(lambda c: c)
              for store in stores]

    def consume(datas, failure):
        if failure is not None:
            node.message_sink.reply_with_unknown_failure(from_node, reply_context, failure)
            return
        if any(d == "nack" for d in datas):
            node.reply(from_node, reply_context, ReadNack("invalidated"))
            return
        if any(d == "obsolete" for d in datas):
            node.reply(from_node, reply_context, ReadNack("obsolete"))
            return
        if any(d == "unavailable" for d in datas):
            node.reply(from_node, reply_context, ReadNack("unavailable"))
            return
        merged = None
        unavailable = Ranges.EMPTY
        for d in datas:
            if d is None:
                continue
            if isinstance(d, tuple) and d and d[0] == "partial":
                _tag, data, un = d
                unavailable = unavailable.union(un)
                d = data
                if d is None:
                    continue
            merged = d if merged is None else merged.merge(d)
        node.reply(from_node, reply_context, ReadOk(
            merged, unavailable=unavailable if len(unavailable) else None))

    au.all_of(chains).begin(consume)


class _ExclusiveSnapshotView:
    """DataStore view whose ``get_at`` excludes the entry at exactly
    ``execute_at`` — used when serving a read from a copy that already
    APPLIED the txn, where the store contains the txn's OWN write at
    ts == execute_at (executeAts are unique, so the exclusive bound strips
    exactly that entry and nothing else)."""
    __slots__ = ("_ds",)

    def __init__(self, ds):
        self._ds = ds

    def __getattr__(self, name):
        return getattr(self._ds, name)

    def get_at(self, key, execute_at):
        return self._ds.get_at(key, execute_at, exclusive=True)


def _unresolved_elision_cover(s: SafeCommandStore, command):
    """(hard, soft, whole): the slices still at risk for ``command``'s read —
    the footprints of its elided-without-local-apply write deps that have
    STILL not landed here.  Resolved entries are pruned (monotone — a dep
    never un-applies, and a completed fetch never un-delivers).

    ``hard`` slices refuse REGARDLESS of pending-bootstrap/stale marks:
    their dep is locally WITNESSED and still IN FLIGHT (below APPLIED, not
    truncated) — its Apply is coming, and the elision bound that dropped it
    was the lie (seed-8: a fence that never witnessed a minority-witnessed
    in-flight write advanced locally_applied_before past it with NO pending
    mark covering the gap; op 201's range read then served k750 while
    op 150 was still mid-recovery — v150.0 missing).  The refusal
    self-heals when the dep's Apply lands.

    ``soft`` slices (dep absent / truncated-era / unknown here) refuse only
    where a fetch is OUTSTANDING — the caller intersects with the pending
    marks; their data story is the bootstrap fetch, and refusing them
    unconditionally rebuilt the seed-6 wedge (ancient elided deps never
    "resolve" in command state: their writes arrived by fetch).

    ``whole`` is True when some unresolved dep's footprint cannot be
    derived (no partial_deps participants): fully conservative fallback."""
    from ..local.commands import _dep_applied_locally
    from ..local.status import SaveStatus as _SS
    from ..primitives.keys import _Successor
    elided = command.elided_unapplied
    if not elided:
        return Ranges.EMPTY, Ranges.EMPTY, False
    store = s.store
    deps = command.partial_deps
    hard: list = []
    soft: list = []
    whole = False
    unresolved = set()
    for dep_id in elided:
        parts = deps.participants(dep_id) if deps is not None else None
        if _dep_applied_locally(store, dep_id) \
                or _fetch_covered(s, dep_id, parts):
            continue   # landed/fetched since: pruned below (assign-only)
        unresolved.add(dep_id)
        if parts is None:
            whole = True
            continue
        dep = store.commands.get(dep_id)
        in_flight = dep is not None \
            and not dep.save_status.is_truncated \
            and dep.save_status is not _SS.INVALIDATED \
            and dep.save_status.ordinal < _SS.APPLIED.ordinal
        out = hard if in_flight else soft
        keys, rngs = parts
        out.extend(Range(rk, _Successor(rk)) for rk in keys)
        out.extend(rngs)
    if len(unresolved) != len(elided):
        # prune resolved entries with a FRESH set — the journal's identity-
        # diff skip keys on object identity (harness/journal.py _FIELDS)
        command.elided_unapplied = unresolved or None
    return (Ranges.of(*hard) if hard else Ranges.EMPTY,
            Ranges.of(*soft) if soft else Ranges.EMPTY,
            whole)


def _fetch_covered(s: SafeCommandStore, dep_id, parts) -> bool:
    """Was an elided dep's write DELIVERED BY A COMPLETED BOOTSTRAP FETCH?
    True when the dep provably executes below the ``bootstrapped_at`` fence
    on every part of its footprint this store owns, and no fetch is
    outstanding there (no pending-bootstrap/stale mark): the fetch snapshot
    was complete up to the fence, so the write is in the data even though
    the dep's Apply never ran here.  An unknown executeAt, a part above the
    fence, or an outstanding fetch stays unresolved — the seed-8 lie was a
    fence advancing past an in-flight write it never witnessed, whose
    executeAt landed ABOVE the fence."""
    store = s.store
    cmd = store.commands.get(dep_id)
    if cmd is None:
        cmd = store.cold_summaries.get(dep_id)
    exec_at = getattr(cmd, "execute_at", None) if cmd is not None else None
    if exec_at is None:
        return False
    owned = store.all_ranges()
    pending = store.pending_bootstrap or Ranges.EMPTY
    stale = getattr(s.data_store(), "stale_ranges", None)
    if stale is not None and len(stale):
        pending = pending.union(stale)
    rb = store.redundant_before
    if parts is None:
        return False
    keys, rngs = parts
    checked = False

    def point_ok(rk) -> bool:
        if pending.contains(rk):
            return False
        e = rb.entry(rk)
        b = e.bootstrapped_at if e is not None else None
        return b is not None and exec_at < b.as_timestamp()

    for key in keys:
        rk = key.to_routing() if hasattr(key, "to_routing") else key
        if not owned.contains(rk):
            continue
        checked = True
        if not point_ok(rk):
            return False
    for rng in rngs:
        probe = Ranges.of(rng)
        sliced = owned.intersection(probe)
        for piece in sliced:
            checked = True
            if pending.intersects(Ranges.of(piece)):
                return False
            for e in rb.map.values_over(piece.start, piece.end):
                b = e.bootstrapped_at if e is not None else None
                if b is None or not exec_at < b.as_timestamp():
                    return False
    return checked


def _serve_read(s: SafeCommandStore, command, result, fallback_txn,
                applied: bool = False) -> bool:
    """Serve the executeAt snapshot from this store: read the CLEAN slice and
    report pending-bootstrap / stale (heal in flight) ranges as unavailable so
    the coordinator can assemble full coverage across replicas (partial reads;
    ReadData unavailable semantics + ReadCoordinator).  Refusing whole reads
    on ANY overlap deadlocked chaos+churn burns cluster-wide.

    ``fallback_txn``: truncated copies have their partial_txn stripped — the
    fused Stable+Read request carries the definition, so the read still runs.
    """
    ptxn = command.partial_txn if command.partial_txn is not None else fallback_txn
    if ptxn is None:
        result.set_success("obsolete")   # no definition to read with
        return True
    # read against the ranges owned at the EXECUTION epoch (they may have
    # been dropped in a later one; the data is still here)
    ranges = s.store.ranges_at(command.execute_at.epoch) \
        if command.execute_at is not None else s.store.current_ranges()
    pending = s.store.pending_bootstrap
    stale = getattr(s.data_store(), "stale_ranges", None)
    if stale is not None and len(stale):
        pending = pending.union(stale) if pending else stale
    if command.waiting_on is not None \
            and (command.save_status in (SaveStatus.READY_TO_EXECUTE,
                                         SaveStatus.APPLYING,
                                         SaveStatus.APPLIED)
                 or command.applied_locally):
        # GRANDFATHERED SERVE (the seed-6 bootstrap-refencing wedge): where
        # this command's WaitingOn drained through LOCAL applies, its stable
        # deps — which cover every conflicting write below executeAt — all
        # landed in this store's MVCC snapshot, so the snapshot at executeAt
        # is COMPLETE there regardless of pending-bootstrap/stale marks a
        # LATER re-fence added.  The unavailable set therefore becomes the
        # slices touched by UNRESOLVED elisions only: hard (in-flight local
        # dep — refuses regardless of pending; the seed-8 unwitnessed-write
        # fence advance) union soft-within-pending (fetch-story deps gate on
        # an outstanding fetch).  Pending WITHOUT elisions is forgiven —
        # refusing the whole footprint is what raced coverage assembly
        # against the re-fencing cadence until every replica of a slice was
        # simultaneously fenced: the seed-6 circular wait.
        hard, soft, whole = _unresolved_elision_cover(s, command)
        if whole:
            pending = pending.union(hard) if pending else hard
        else:
            pending = hard.union(pending.intersection(soft)) if pending \
                else hard
    unavailable = Ranges.EMPTY
    if pending:
        k = ptxn.keys
        if isinstance(k, Ranges):
            unavailable = k.intersection(ranges).intersection(pending)
        else:
            hit = [rk for rk in (
                key.to_routing() if hasattr(key, "to_routing") else key
                for key in k)
                if ranges.contains(rk) and pending.contains(rk)]
            if hit:
                unavailable = ranges.intersection(pending)
        if len(unavailable):
            ranges = ranges.without(pending)
    read_keys = ptxn.keys.intersection(ranges) \
        if isinstance(ptxn.keys, Ranges) \
        else [k for k in ptxn.keys
              if ranges.contains(k.to_routing() if hasattr(k, "to_routing") else k)]

    def done(data, f, unavailable=unavailable):
        if f is not None:
            result.set_failure(f)
        elif isinstance(data, str):
            # sentinel ("obsolete"): the store cannot serve this read
            result.set_success(data)
        elif len(unavailable):
            result.set_success(("partial", data, unavailable))
        else:
            result.set_success(data)

    ds = _ExclusiveSnapshotView(s.data_store()) if applied else None
    if not applied and command.execute_at is not None \
            and not isinstance(read_keys, Ranges):
        # normal-path committed read: advance the per-key execution registers
        # for the keys the Read DECLARES (read_keys here is the full txn
        # footprint; write-only keys are registered by _apply_writes).
        # Validated; historical applied-copy serves skip this — their
        # snapshot is below the store's execution frontier by design.
        declared = ptxn.read.keys() if ptxn.read is not None else None
        tfk = s.store.timestamps_for_key
        for key in read_keys:
            if declared is None or isinstance(declared, Ranges) \
                    or declared.contains(key):
                tfk.update_last_execution(s, key, command.execute_at, False)
    ptxn.read_chain(s, command.execute_at, read_keys, data_store=ds).begin(done)
    return True


def _read_when_ready(safe_store: SafeCommandStore, txn_id: TxnId,
                     fallback_txn=None) -> au.AsyncChain:
    """Returns a chain yielding the Data read at executeAt (or 'nack')."""
    result = au.settable()
    store = safe_store.store

    def try_read(s: SafeCommandStore, command) -> bool:
        if command.save_status is SaveStatus.INVALIDATED:
            result.set_success("nack")
            return True
        def _gap_fenced(s: SafeCommandStore, cmd) -> bool:
            """A TRUNCATED_APPLY copy that never ran the dependency-ordered
            apply may be missing predecessor writes.  Serving it is sound
            only when the possibly-gappy footprint is stale/bootstrap-fenced
            (then _serve_read reports those slices unavailable).  The fencing
            paths have escape hatches — lone-replica heal, route-less
            truncation — where nothing was fenced: refuse there."""
            if cmd.route is None:
                return False
            parts = cmd.route.participants().slice(s.current_ranges())
            if not len(parts):
                return True   # nothing of the footprint lives here
            fenced = s.store.pending_bootstrap or Ranges.EMPTY
            stale = getattr(s.data_store(), "stale_ranges", None)
            if stale is not None and len(stale):
                fenced = fenced.union(stale)
            if isinstance(parts, Ranges):
                return not len(parts.without(fenced))
            return all(fenced.contains(p) for p in parts)

        if (command.save_status is SaveStatus.APPLIED
            or (command.save_status is SaveStatus.TRUNCATED_APPLY
                and (command.applied_locally or _gap_fenced(s, command)))) \
                and command.execute_at is not None:
            # the command raced past ReadyToExecute here (an Apply — possibly
            # a recovery's Maximal — or a with-outcome truncation won).  The
            # store is a timestamped MVCC snapshot, so unlike the reference
            # (ReadData.java:57-260 nacks obsolete — Cassandra's store has no
            # per-executeAt snapshot) the read CAN still be served: APPLIED
            # means every dependency's write landed locally, any known data
            # gap (truncated-without-local-apply) is stale-fenced and reported
            # as unavailable slices by _serve_read, and the EXCLUSIVE snapshot
            # bound strips the txn's own write at ts == executeAt.  Without
            # this, sustained-chaos recoveries livelock: every replica's copy
            # races to APPLIED before the recovery's read round arrives and
            # the read phase exhausts on obsolete nacks (seed-4 churn stall).
            return _serve_read(s, command, result, fallback_txn, applied=True)
        if command.save_status.is_truncated:
            # ERASED (no executeAt left to snapshot at): genuinely obsolete —
            # the coordinator reads elsewhere; stale-marking covers any gap
            result.set_success("obsolete")
            return True
        if command.save_status is SaveStatus.READY_TO_EXECUTE:
            return _serve_read(s, command, result, fallback_txn)
        if command.save_status in (SaveStatus.PRE_APPLIED, SaveStatus.APPLYING):
            # deps not yet locally applied — the executeAt snapshot is
            # incomplete here.  NACK immediately (the reference's obsolete,
            # ReadData.java:57-260): the coordinator's retry loop must stay
            # in control.  PRE_APPLIED/APPLYING are TRANSIENT — the local
            # drain reaches APPLIED, where the read serves from the MVCC
            # snapshot — so the coordinator treats this as retry-later, not
            # failure (see _ExecuteTxn's delayed read re-round).  Replica-
            # side waiting (bounded or not) was tried and LIVELOCKED hostile
            # burns: the wait pushes read replies past the coordinator's
            # own timeout/preemption windows, so no recovery attempt ever
            # completes (seed 1).
            result.set_success("obsolete")
            return True
        return False

    command = safe_store.get_or_create(txn_id)
    if not try_read(safe_store, command):
        def listener(s: SafeCommandStore, cmd):
            if result.is_done() or try_read(s, cmd):
                s.remove_transient_listener(txn_id, listener)
        safe_store.add_transient_listener(txn_id, listener)
    return result.to_chain()


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

class Apply(TxnRequest):
    __slots__ = ("kind", "execute_at", "partial_deps", "partial_txn", "writes", "result",
                 "route")

    MINIMAL = "minimal"
    MAXIMAL = "maximal"

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int, kind: str,
                 execute_at: Timestamp, partial_deps: Deps,
                 partial_txn: Optional[PartialTxn], writes: Optional[Writes], result,
                 route: Optional[Route] = None):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.kind = kind
        self.execute_at = execute_at
        self.partial_deps = partial_deps
        self.partial_txn = partial_txn
        self.writes = writes
        self.result = result
        self.route = route if route is not None else scope

    def preload_ids(self):
        if self.partial_deps is None:
            return (self.txn_id,)
        return (self.txn_id, *self.partial_deps.txn_ids())

    @property
    def type(self):
        return MessageType.APPLY_MAXIMAL_REQ if self.kind == Apply.MAXIMAL \
            else MessageType.APPLY_MINIMAL_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id = self.txn_id

        def map_fn(safe_store: SafeCommandStore):
            return C.apply_(safe_store, txn_id, self.route, self.execute_at,
                            self.partial_deps, self.partial_txn, self.writes, self.result)

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node, reply_context, failure)
            elif result is C.CommitOutcome.INSUFFICIENT:
                node.reply(from_node, reply_context, ReadNack("insufficient"))
            else:
                # Apply acks once the outcome is durably RECORDED (Apply.java
                # ApplyReply.Applied); callers needing execution completion use
                # WaitUntilApplied / ApplyThenWaitUntilApplied instead
                node.reply(from_node, reply_context, APPLY_OK)

        node.map_reduce_consume_local(self.scope, node.topology.min_epoch,
                                      self.execute_at.epoch,
                                      map_fn, worst_outcome,
                                      preload=self.preload_ids()).begin(consume)

    def __repr__(self):
        return f"Apply[{self.kind}]({self.txn_id!r})"


class ApplyThenWaitUntilApplied(Apply):
    """Apply (Maximal) and reply only once the txn has actually APPLIED in every
    intersecting local store — the blocking-sync-point execution message
    (ApplyThenWaitUntilApplied.java; ExecuteSyncPoint.ExecuteBlocking sends it
    so its quorum means "executed", not merely "recorded")."""

    __slots__ = ()

    @property
    def type(self):
        return MessageType.APPLY_THEN_WAIT_UNTIL_APPLIED_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id, scope, execute_at = self.txn_id, self.scope, self.execute_at

        def map_fn(safe_store: SafeCommandStore):
            return C.apply_(safe_store, txn_id, self.route, execute_at,
                            self.partial_deps, self.partial_txn, self.writes,
                            self.result)

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_node, reply_context, failure)
            elif result is C.CommitOutcome.INSUFFICIENT:
                node.reply(from_node, reply_context, ReadNack("insufficient"))
            else:
                def done(outcome, f2):
                    if f2 is not None:
                        node.message_sink.reply_with_unknown_failure(
                            from_node, reply_context, f2)
                    elif outcome == "nack":
                        node.reply(from_node, reply_context, ReadNack("invalidated"))
                    else:
                        node.reply(from_node, reply_context, APPLY_OK)
                await_applied_local(node, txn_id, scope, txn_id.epoch,
                                    execute_at.epoch).begin(done)

        node.map_reduce_consume_local(self.scope, node.topology.min_epoch,
                                      self.execute_at.epoch,
                                      map_fn, worst_outcome,
                                      preload=self.preload_ids()).begin(consume)

    def __repr__(self):
        return f"ApplyThenWaitUntilApplied({self.txn_id!r})"


# ---------------------------------------------------------------------------
# WaitUntilApplied (WaitUntilApplied.java): blocking wait used by sync-point
# execution, recovery, and bootstrap streaming — replies once the txn has
# Applied in every intersecting local store (or nacks if invalidated).
# ---------------------------------------------------------------------------

class WaitUntilApplied(TxnRequest):
    __slots__ = ("execute_at_hint",)

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int,
                 execute_at_hint: Optional[Timestamp] = None):
        super().__init__(txn_id, scope, wait_for_epoch)
        self.execute_at_hint = execute_at_hint

    @property
    def type(self):
        return MessageType.WAIT_UNTIL_APPLIED_REQ

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        txn_id = self.txn_id
        max_epoch = self.execute_at_hint.epoch if self.execute_at_hint is not None \
            else txn_id.epoch

        def consume(outcome, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_node, reply_context, failure)
            elif outcome == "nack":
                node.reply(from_node, reply_context, ReadNack("invalidated"))
            else:
                node.reply(from_node, reply_context, APPLY_OK)

        await_applied_local(node, txn_id, self.scope, txn_id.epoch,
                            max_epoch).begin(consume)

    def __repr__(self):
        return f"WaitUntilApplied({self.txn_id!r})"


def await_applied_local(node: "Node", txn_id: TxnId, unseekables,
                        min_epoch: int, max_epoch: int) -> au.AsyncChain:
    """Chain resolving "ok"/"nack" once ``txn_id`` is Applied (or truncated /
    invalidated) in every intersecting LOCAL store.  Shared by WaitUntilApplied
    and local barriers."""
    stores = node.command_stores.intersecting_stores(unseekables, min_epoch,
                                                     max_epoch)
    if not stores:
        return au.done("ok")
    chains = [store.submit(lambda s: await_applied(s, txn_id),
                           preload=(txn_id,))
              .flat_map(lambda c: c) for store in stores]
    return au.all_of(chains).map(
        lambda results: "nack" if any(r == "nack" for r in results) else "ok")


def await_applied(safe_store: SafeCommandStore, txn_id: TxnId) -> au.AsyncChain:
    """Chain resolving once ``txn_id`` is Applied (or truncated) in this store."""
    result = au.settable()

    def check(s: SafeCommandStore, command) -> bool:
        if command.save_status is SaveStatus.INVALIDATED:
            result.set_success("nack")
            return True
        if command.save_status.ordinal >= SaveStatus.APPLIED.ordinal \
                or command.save_status.is_truncated:
            result.set_success("ok")
            return True
        return False

    command = safe_store.get_or_create(txn_id)
    if not check(safe_store, command):
        def listener(s: SafeCommandStore, cmd):
            if check(s, cmd):
                s.remove_transient_listener(txn_id, listener)
        safe_store.add_transient_listener(txn_id, listener)
    return result.to_chain()
