"""The DepsResolver boundary — the pluggable per-store conflict-index data plane.

The reference hides its dependency calculation behind
``SafeCommandStore.mapReduceActive`` (SafeCommandStore.java:292) + the per-key
``CommandsForKey`` indexes (cfk/CommandsForKey.java:925-1000) and its timestamp
proposal behind ``MaxConflicts`` (MaxConflicts.java:32) + per-key maxima.  This
module makes that boundary explicit so the SAME protocol code runs against:

- ``CpuDepsResolver``  — the host reference data plane: walks the store's
  CommandsForKey lists (exactly the reference's scalar scan shape);
- ``TpuDepsResolver``  — the device data plane (impl/tpu_resolver.py): the
  store's conflict index lives on-device as a GraphState and every query is a
  batched MXU join (ops.deps_kernels.overlap_join / max_conflict_keys).  Its
  device tier routes through the PERSISTENT batched consult service
  (device_service/: incrementally-refreshed double-buffered index, ragged
  batching windows, ``submit(txn_keys) -> AsyncResult`` futures) unless
  ``tpu_service=off`` selects the legacy one-shot dispatch;
- ``VerifyDepsResolver`` — runs both and asserts bit-identical results on
  every query ("deps-graph parity"); used by tests and the burn harness.

Select per-node via ``Node(resolver=...)`` or globally via the environment
variable ``ACCORD_RESOLVER`` in {cpu, tpu, verify} (default cpu).

Scope: the resolver owns the KEY-domain conflict index (the hot path).
Range-domain transactions (sync points; InMemoryCommandStore.rangeCommands
scan, :814-900) remain a host-side side table in SafeCommandStore — they are
rare control transactions, not data-plane load.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, TYPE_CHECKING

from ..primitives.keys import Range, RoutingKey
from ..primitives.timestamp import Timestamp, TxnId
from ..utils.invariants import check_state

if TYPE_CHECKING:
    from ..local.command_store import CommandStore
    from ..local.cfk import InternalStatus


def check_resolver_kind(kind: str) -> str:
    check_state(kind in ("cpu", "tpu", "verify"),
                "resolver kind must be cpu|tpu|verify, got %s", kind)
    return kind


def make_resolver(kind: str, store: "CommandStore",
                  config=None) -> "DepsResolver":
    if kind == "cpu":
        return CpuDepsResolver(store)
    if kind == "tpu":
        from .tpu_resolver import TpuDepsResolver
        return TpuDepsResolver(store, config=config)
    if kind == "verify":
        from .tpu_resolver import TpuDepsResolver
        return VerifyDepsResolver(CpuDepsResolver(store),
                                  TpuDepsResolver(store, config=config))
    raise ValueError(f"unknown resolver kind {kind!r}")


class QuerySpec:
    """A declared upcoming query, for batched prefetch (resolver.prefetch).

    ``op`` is 'kc' (key_conflicts) or 'mc' (max_conflict_keys).  ``keys`` are
    the keys the caller WILL pass (pre key-slot filtering — the resolver
    applies its own known-key filter, exactly as the live query does, so the
    cached answer's signature matches the call-time signature)."""
    __slots__ = ("op", "by", "keys", "before")

    def __init__(self, op: str, by: Optional[TxnId], keys, before: Optional[Timestamp]):
        self.op = op
        self.by = by
        self.keys = tuple(keys)
        self.before = before


class DepsResolver:
    """Interface.  All queries are pure reads of the index; registration and
    pruning are the only mutations, and both are driven by the owning
    SafeCommandStore (single-logical-thread discipline applies)."""

    def prefetch(self, specs: List["QuerySpec"]) -> None:
        """Hint: the declared queries are about to be issued (a coalesced
        delivery window).  A device resolver answers them all in ONE launch
        and serves the live queries from the cached answers — falling back to
        an individual launch whenever an index mutation since the prefetch
        could change the answer (exact sequential semantics).  Host resolvers
        ignore it."""

    def end_batch(self) -> None:
        """The delivery window ended: drop any prefetched answers."""

    # -- execution-frontier plane (Commands WaitingOn mirror) -----------------
    def is_indexed(self, txn_id: TxnId) -> bool:
        """Does the device index hold this txn (frontier-exec eligibility)?
        Host-only resolvers index nothing."""
        return False

    def register_waiting(self, waiter: TxnId, deps) -> None:
        """The execute-phase wait graph: ``waiter`` blocks on ``deps``
        (Commands.initialiseWaitingOn, Commands.java:688).  Device resolvers
        mirror the edges so the execution frontier can be computed as one
        kernel pass (ops.deps_kernels.kahn_frontier); host resolvers rely on
        the event-driven WaitingOn and ignore this."""

    def remove_waiting(self, waiter: TxnId, dep: TxnId) -> None:
        """An edge drained (dep applied/invalidated/truncated or provably
        ordered after the waiter — Commands.java:704-775)."""

    def note_terminal(self, txn_id: TxnId, invalidated: bool = False) -> None:
        """The host command reached a TERMINAL SaveStatus (applied /
        invalidated / truncated / erased) — regardless of whether any cfk
        accepted a witness update for the transition.  ``register`` alone
        cannot carry this: it is gated behind the cfk key-indexing loop,
        which refuses demoted-cold and pruned entries, truncation never
        re-registers at all, and topology churn can drop key ownership
        between STABLE and APPLIED.  Device resolvers must still advance
        their mirror's status (a stale STABLE row reports the txn
        execution-ready forever — the one-sided device mirror leak) and drop
        the txn's wait edges; host resolvers keep no mirror and ignore this."""

    def mark_durable(self, txn_id: TxnId) -> None:
        """Per-txn UNIVERSAL durability (Commands.set_durability crossing
        UNIVERSAL — the coordinator saw every Apply ack): device-plane
        resolvers widen their elision mirrors; host resolvers rely on the cfk
        flag (cfk.mark_durable) and ignore this.  Majority durability is NOT
        sufficient for elision — see commands.set_durability."""

    def _durable_majority(self, rk: RoutingKey) -> Optional[TxnId]:
        """The key's majority-durable watermark — the elision soundness gate
        (cfk.map_reduce_active doc).  Shared by BOTH data planes: the gate
        semantics must stay bit-identical for verify parity."""
        db = getattr(self.store, "durable_before", None)
        if db is None:
            return None
        e = db.entry(rk)
        return e.majority_before if e is not None else None

    def register(self, txn_id: TxnId, status: "InternalStatus",
                 execute_at: Optional[Timestamp],
                 keys: Tuple[RoutingKey, ...]) -> None:
        """Witness/upgrade a key-domain managed txn on ``keys``
        (CommandsForKey.update semantics: status monotonic)."""
        raise NotImplementedError

    def on_pruned(self, key: RoutingKey, txn_ids: List[TxnId]) -> None:
        """The per-key index dropped ``txn_ids`` below a prune bound — evict
        the (txn, key) incidences so late queries match (cfk pruning)."""
        raise NotImplementedError

    def key_conflicts(self, by: TxnId, keys: List[RoutingKey], before: Timestamp
                      ) -> List[Tuple[RoutingKey, TxnId]]:
        """Active (non-invalidated) indexed txns with txnId < before on any of
        ``keys`` that ``by``'s kind witnesses; (key, dep) per incidence.
        == mapReduceActive over the cfk indexes (cfk/CommandsForKey.java:925)."""
        raise NotImplementedError

    def range_conflicts(self, by: TxnId, rng: Range, before: Timestamp
                        ) -> List[Tuple[RoutingKey, TxnId]]:
        """Same, for every indexed key inside ``rng``."""
        raise NotImplementedError

    def max_conflict_keys(self, keys: List[RoutingKey]) -> Optional[Timestamp]:
        """Lexicographic max of max(executeAt, txnId) over indexed txns touching
        ``keys`` (the per-key half of the MaxConflicts consult)."""
        raise NotImplementedError

    def max_conflict_range(self, rng: Range) -> Optional[Timestamp]:
        raise NotImplementedError


class CpuDepsResolver(DepsResolver):
    """Reference host resolver: delegates to the store's CommandsForKey lists.
    This IS the reference algorithm (scalar per-key scans); it owns no state of
    its own, so cfk registration doubles as resolver registration."""

    def __init__(self, store: "CommandStore"):
        self.store = store

    # cfk.update is already performed by SafeCommandStore.register_witness —
    # the cfk lists are this resolver's index.
    def register(self, txn_id, status, execute_at, keys) -> None:
        pass

    def on_pruned(self, key, txn_ids) -> None:
        pass

    def key_conflicts(self, by, keys, before):
        out: List[Tuple[RoutingKey, TxnId]] = []
        # sync points are local-apply FENCES: their deps must wait on every
        # txn not yet provably applied at EVERY replica, so the per-txn
        # MAJORITY-durable elision flag does not apply to them (only the
        # universal-grade watermark does) — eliding a merely-majority-applied
        # txn from an exclusive sync point's deps lets mark_shard_durable
        # claim universal application the barrier never proved, advancing
        # truncation fences past unapplied txns (the round-5 stale-cascade)
        flag = not by.kind.is_sync_point
        for rk in keys:
            cfk = self.store.cfks.get(rk)
            if cfk is not None:
                cfk.map_reduce_active(before, by.witnesses,
                                      lambda t, _rk=rk: out.append((_rk, t)),
                                      durable_majority=self._durable_majority(rk),
                                      flag_elision=flag)
        return out

    def range_conflicts(self, by, rng, before):
        out: List[Tuple[RoutingKey, TxnId]] = []
        flag = not by.kind.is_sync_point   # see key_conflicts
        for rk in sorted(self.store.cfks):
            if rng.contains(rk):
                cfk = self.store.cfks[rk]
                cfk.map_reduce_active(before, by.witnesses,
                                      lambda t, _rk=rk: out.append((_rk, t)),
                                      durable_majority=self._durable_majority(rk),
                                      flag_elision=flag)
        return out

    def max_conflict_keys(self, keys):
        out: Optional[Timestamp] = None
        for rk in keys:
            cfk = self.store.cfks.get(rk)
            if cfk is not None:
                ts = cfk.max_timestamp()
                if ts is not None and (out is None or ts > out):
                    out = ts
        return out

    def max_conflict_range(self, rng):
        out: Optional[Timestamp] = None
        for rk in sorted(self.store.cfks):
            if rng.contains(rk):
                ts = self.store.cfks[rk].max_timestamp()
                if ts is not None and (out is None or ts > out):
                    out = ts
        return out


class VerifyDepsResolver(DepsResolver):
    """Runs the CPU and TPU resolvers side by side and asserts every query
    agrees — the continuous deps-graph parity check (BASELINE.md metric).
    Comparison is set-level (Deps construction is order-independent)."""

    def __init__(self, cpu: CpuDepsResolver, tpu: DepsResolver):
        self.cpu = cpu
        self.tpu = tpu
        self.queries = 0

    def prefetch(self, specs) -> None:
        # only the device side batches; the cpu side stays the live oracle the
        # cached answers are checked against on every query
        self.tpu.prefetch(specs)

    def end_batch(self) -> None:
        self.tpu.end_batch()

    def register_waiting(self, waiter, deps) -> None:
        self.tpu.register_waiting(waiter, deps)

    def remove_waiting(self, waiter, dep) -> None:
        self.tpu.remove_waiting(waiter, dep)

    def note_terminal(self, txn_id, invalidated: bool = False) -> None:
        self.tpu.note_terminal(txn_id, invalidated=invalidated)

    def is_indexed(self, txn_id) -> bool:
        return self.tpu.is_indexed(txn_id)

    def register(self, txn_id, status, execute_at, keys) -> None:
        self.cpu.register(txn_id, status, execute_at, keys)
        self.tpu.register(txn_id, status, execute_at, keys)

    def on_pruned(self, key, txn_ids) -> None:
        self.cpu.on_pruned(key, txn_ids)
        self.tpu.on_pruned(key, txn_ids)

    def mark_durable(self, txn_id) -> None:
        self.cpu.mark_durable(txn_id)
        self.tpu.mark_durable(txn_id)

    def _check(self, what, a, b):
        check_state(a == b, "deps parity violation in %s: cpu=%s tpu=%s",
                    what, a, b)
        self.queries += 1
        return a

    def key_conflicts(self, by, keys, before):
        return self._check(
            "key_conflicts",
            sorted(self.cpu.key_conflicts(by, keys, before)),
            sorted(self.tpu.key_conflicts(by, keys, before)))

    def range_conflicts(self, by, rng, before):
        return self._check(
            "range_conflicts",
            sorted(self.cpu.range_conflicts(by, rng, before)),
            sorted(self.tpu.range_conflicts(by, rng, before)))

    def max_conflict_keys(self, keys):
        return self._check("max_conflict_keys",
                           self.cpu.max_conflict_keys(keys),
                           self.tpu.max_conflict_keys(keys))

    def max_conflict_range(self, rng):
        return self._check("max_conflict_range",
                           self.cpu.max_conflict_range(rng),
                           self.tpu.max_conflict_range(rng))
