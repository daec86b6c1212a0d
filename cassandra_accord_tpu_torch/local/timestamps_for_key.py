"""Per-key execution-timestamp registers (TimestampsForKey).

Capability parity with the reference's ``impl/TimestampsForKey.java`` /
``TimestampsForKeys.java``: each key of a command store carries registers —

  * ``last_write``          — executeAt of the most recent WRITE applied here
  * ``last_executed``       — executeAt of the most recent execution (read or
                              write)
  * ``last_executed_hlc``   — a strictly-monotonic HLC the embedding store can
                              stamp local application with (the reference keeps
                              ``rawLastExecutedHlc`` with a MIN_VALUE sentinel;
                              we keep the resolved value and bump ties by one —
                              the same observable sequence)
  * ``last_ephemeral_read`` — snapshot point of the most recent EPHEMERAL read
                              served from this store

Role and design divergence (deliberate, documented):

The reference enforces strict per-key execution monotonicity (a write may
never execute below lastWrite/lastExecuted) because Cassandra's store applies
at the register HLC and is not timestamp-versioned.  Our data plane is a
timestamped MVCC store (``ListStore.get_at``): writes land with their
executeAt, reads snapshot at their own executeAt, so LOCAL apply-order
inversion between two committed writes is absorbed by the store and is legal
(it happens routinely across epoch changes and truncated-outcome adoption).
We therefore:

1. record write inversions as a per-store DIAGNOSTIC counter
   (``store.tfk_inversions``) rather than failing — the client-visible
   strict-serializability verifier owns the end-to-end ordering check;
2. hard-enforce the one register invariant our design DOES guarantee: a
   write may never apply below ``last_ephemeral_read``.  An ephemeral read
   serves only after every dep in its quorum-collected deps applied locally,
   and quorum intersection + HLC propagation put every write with a lower
   executeAt in those deps — so a later write landing below a served
   ephemeral snapshot means the snapshot missed a committed lower write: a
   genuine dependency-completeness bug, routed to
   ``Agent.on_inconsistent_timestamp`` (ephemeral reads are never witnessed,
   so NO other mechanism can catch this; the registers are the only record —
   the reference motivates TimestampsForKey the same way).

Out-of-order application paths (truncated-outcome adoption, bootstrap fence
shipping, pre-bootstrap applies) merge registers monotonically and are
exempt from the ephemeral check over stale/bootstrapping footprints, exactly
the cases the reference gates behind ``safeToReadAt``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional

from ..primitives.timestamp import Timestamp

if TYPE_CHECKING:
    from ..primitives.keys import Key


class TimestampsForKey:
    """The per-key registers (TimestampsForKey.java:27-118)."""

    __slots__ = ("key", "last_executed", "last_executed_hlc", "last_write",
                 "last_ephemeral_read")

    def __init__(self, key):
        self.key = key
        self.last_executed: Optional[Timestamp] = None
        self.last_executed_hlc: int = 0
        self.last_write: Optional[Timestamp] = None
        self.last_ephemeral_read: Optional[Timestamp] = None

    def record_execution(self, execute_at: Timestamp, is_write: bool) -> bool:
        """Monotonic register advance for a read/write execution; returns
        True when the execution was an inversion (landed below an already-
        advanced register) — diagnostic only, see module doc."""
        inverted = False
        if is_write:
            if self.last_write is None or execute_at > self.last_write:
                self.last_write = execute_at
            else:
                inverted = execute_at != self.last_write
        if self.last_executed is None or execute_at > self.last_executed:
            hlc = execute_at.hlc
            self.last_executed_hlc = hlc if hlc > self.last_executed_hlc \
                else self.last_executed_hlc + 1
            self.last_executed = execute_at
        return inverted

    def record_ephemeral_read(self, snapshot_at: Timestamp) -> None:
        if self.last_ephemeral_read is None \
                or snapshot_at > self.last_ephemeral_read:
            self.last_ephemeral_read = snapshot_at
        self.record_execution(snapshot_at, False)

    def violates_ephemeral_fence(self, execute_at: Timestamp,
                                 is_write: bool) -> bool:
        """The enforced invariant: a WRITE landing below a served ephemeral
        snapshot missed that snapshot (deps incompleteness)."""
        return is_write and self.last_ephemeral_read is not None \
            and execute_at < self.last_ephemeral_read

    # -- GC (TimestampsForKey.withoutRedundant) ------------------------------
    def without_redundant(self, redundant_before: Timestamp) -> bool:
        """Clear registers strictly below the redundancy bound; returns True
        when the whole record became empty (the registry drops it)."""
        if self.last_executed is not None and self.last_executed < redundant_before:
            self.last_executed = None
        if self.last_executed_hlc and self.last_executed_hlc < redundant_before.hlc:
            self.last_executed_hlc = 0
        if self.last_write is not None and self.last_write < redundant_before:
            self.last_write = None
        if self.last_ephemeral_read is not None \
                and self.last_ephemeral_read < redundant_before:
            self.last_ephemeral_read = None
        return (self.last_executed is None and self.last_write is None
                and self.last_ephemeral_read is None
                and not self.last_executed_hlc)

    def __repr__(self) -> str:
        return (f"TimestampsForKey({self.key!r}, last_executed="
                f"{self.last_executed!r}, last_write={self.last_write!r})")


class TimestampsForKeys:
    """Per-store registry of TimestampsForKey records (the reference keeps a
    NavigableMap on InMemoryCommandStore, InMemoryCommandStore.java:99)."""

    __slots__ = ("_by_key",)

    def __init__(self):
        self._by_key: Dict[object, TimestampsForKey] = {}

    def get_or_create(self, key) -> TimestampsForKey:
        tfk = self._by_key.get(key)
        if tfk is None:
            tfk = self._by_key[key] = TimestampsForKey(key)
        return tfk

    def get_if_present(self, key) -> Optional[TimestampsForKey]:
        return self._by_key.get(key)

    def update_last_execution(self, safe_store, key, execute_at: Timestamp,
                              is_write: bool, txn_id=None) -> None:
        """Normal-path update.  Advances registers monotonically, counts
        write inversions, and enforces the ephemeral fence — except over
        bootstrap/stale footprints and for pre-bootstrap txns (``txn_id``
        below the key's bootstrapped_at), where out-of-order landing is
        expected (the reference's safeToReadAt gate)."""
        tfk = self.get_or_create(key)
        rk = key.to_routing() if hasattr(key, "to_routing") else key
        store = safe_store.store
        unsafe = (store.pending_bootstrap
                  and store.pending_bootstrap.contains(rk))
        if not unsafe:
            stale = getattr(safe_store.data_store(), "stale_ranges", None)
            unsafe = stale is not None and len(stale) and stale.contains(rk)
        if not unsafe and txn_id is not None:
            e = store.redundant_before.entry(rk)
            unsafe = e is not None and e.bootstrapped_at is not None \
                and txn_id < e.bootstrapped_at
        if not unsafe and tfk.violates_ephemeral_fence(execute_at, is_write):
            safe_store.agent().on_inconsistent_timestamp(
                txn_id, tfk.last_ephemeral_read, execute_at)
        if tfk.record_execution(execute_at, is_write):
            store.tfk_inversions += 1

    def record_ephemeral_read(self, key, snapshot_at: Timestamp) -> None:
        self.get_or_create(key).record_ephemeral_read(snapshot_at)

    def merge_applied_write(self, key, execute_at: Timestamp) -> None:
        self.get_or_create(key).record_execution(execute_at, True)

    def remove_redundant_by(self, bound_fn) -> None:
        """GC: trim each record below ``bound_fn(key) -> Optional[Timestamp]``
        (per-key shard-redundant bounds); drop records that become empty."""
        drop = []
        for k, tfk in self._by_key.items():
            bound = bound_fn(k)
            if bound is not None and tfk.without_redundant(bound):
                drop.append(k)
        for k in drop:
            del self._by_key[k]

    def remove_redundant(self, redundant_before: Timestamp) -> None:
        self.remove_redundant_by(lambda _k: redundant_before)

    def __len__(self) -> int:
        return len(self._by_key)
