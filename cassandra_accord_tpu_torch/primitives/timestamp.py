"""Hybrid logical clock timestamps, transaction ids, and ballots.

Capability parity with ``accord.primitives.Timestamp/TxnId/Ballot``
(Timestamp.java:27-118, TxnId.java:84-150, Ballot.java).  The reference packs
48-bit epoch + 64-bit HLC + 16-bit flags + node id into two longs; here the fields are
kept unpacked (Python ints are arbitrary precision) but the *ordering and merge
semantics are identical*: total order on (epoch, hlc, flags, node), ``merge_max``
retains MERGE_FLAGS from both operands, and TxnId identity-flags encode
``Txn.Kind`` (3 bits) and ``Routable.Domain`` (1 bit).

For the TPU data plane a TxnId is exchanged with device code as a packed int64 pair via
``pack64``/``unpack64`` — the same two-word layout the reference uses, so device-side
sorts/compares agree with host-side ordering.
"""
from __future__ import annotations

import enum
from typing import Optional, Tuple

from ..utils.invariants import check_argument

MAX_EPOCH = (1 << 48) - 1
MAX_HLC = (1 << 63) - 1
MAX_FLAGS = (1 << 16) - 1
REJECTED_FLAG = 0x8000
MERGE_FLAGS = 0x8000
MAX_NODE = (1 << 32) - 1


class Domain(enum.IntEnum):
    """Routable.Domain — whether a txn's footprint is keys or ranges."""
    KEY = 0
    RANGE = 1


class TxnKind(enum.IntEnum):
    """Txn.Kind (Txn.java:53-113) with the same witness matrix (Txn.java:221-262)."""
    READ = 0
    WRITE = 1
    EPHEMERAL_READ = 2
    SYNC_POINT = 3
    EXCLUSIVE_SYNC_POINT = 4
    LOCAL_ONLY = 5

    # -- classification -----------------------------------------------------
    @property
    def is_write(self) -> bool:
        return self is TxnKind.WRITE

    @property
    def is_read(self) -> bool:
        return self is TxnKind.READ

    @property
    def is_local(self) -> bool:
        return self is TxnKind.LOCAL_ONLY

    @property
    def is_durable(self) -> bool:
        return self is not TxnKind.EPHEMERAL_READ

    @property
    def is_globally_visible(self) -> bool:
        return self in (TxnKind.READ, TxnKind.WRITE,
                        TxnKind.SYNC_POINT, TxnKind.EXCLUSIVE_SYNC_POINT)

    @property
    def is_sync_point(self) -> bool:
        return self in (TxnKind.SYNC_POINT, TxnKind.EXCLUSIVE_SYNC_POINT)

    @property
    def awaits_only_deps(self) -> bool:
        """ExclusiveSyncPoint / EphemeralRead execute only after their deps and have
        no logical executeAt (Txn.java:209-213)."""
        return self in (TxnKind.EXCLUSIVE_SYNC_POINT, TxnKind.EPHEMERAL_READ)

    # -- witness matrix (Txn.java:221-262) ----------------------------------
    def witnesses(self, other: "TxnKind") -> bool:
        """Does a txn of this kind take a dependency on conflicting txns of ``other``?"""
        if self in (TxnKind.READ, TxnKind.EPHEMERAL_READ):
            return other is TxnKind.WRITE                                   # Ws
        if self in (TxnKind.WRITE, TxnKind.SYNC_POINT):
            return other in (TxnKind.READ, TxnKind.WRITE)                   # RsOrWs
        if self is TxnKind.EXCLUSIVE_SYNC_POINT:
            return other.is_globally_visible                                # AnyGloballyVisible
        return False

    def witnessed_by(self, other: "TxnKind") -> bool:
        """Inverse direction (Txn.java witnessedBy): which kinds witness this kind?"""
        if self is TxnKind.EPHEMERAL_READ:
            return False                                                    # Nothing
        if self is TxnKind.READ:
            return other in (TxnKind.WRITE, TxnKind.SYNC_POINT,
                             TxnKind.EXCLUSIVE_SYNC_POINT)                  # WsOrSyncPoints
        if self is TxnKind.WRITE:
            return other.is_globally_visible                                # AnyGloballyVisible
        if self in (TxnKind.SYNC_POINT, TxnKind.EXCLUSIVE_SYNC_POINT):
            return other is TxnKind.EXCLUSIVE_SYNC_POINT                    # ExclusiveSyncPoints
        return False

    @property
    def short_name(self) -> str:
        return {TxnKind.READ: "R", TxnKind.WRITE: "W", TxnKind.EPHEMERAL_READ: "E",
                TxnKind.SYNC_POINT: "S", TxnKind.EXCLUSIVE_SYNC_POINT: "X",
                TxnKind.LOCAL_ONLY: "L"}[self]


class Timestamp:
    """Totally-ordered HLC timestamp: (epoch, hlc, flags, node)."""

    __slots__ = ("epoch", "hlc", "flags", "node", "_k", "_h")

    def __init__(self, epoch: int, hlc: int, node: int, flags: int = 0):
        check_argument(0 <= epoch <= MAX_EPOCH, "epoch out of range: %s", epoch)
        check_argument(hlc >= 0, "hlc must be >= 0: %s", hlc)
        check_argument(0 <= flags <= MAX_FLAGS, "flags out of range: %s", flags)
        self.epoch = epoch
        self.hlc = hlc
        self.flags = flags
        self.node = node
        # immutable; the comparison key is on every protocol hot path, and
        # the hash rides every deps-set / listener-set / dict operation —
        # both are precomputed once (timestamps hash millions of times per
        # burn; re-hashing the tuple per call was a measured wall slice)
        self._k = (epoch, hlc, flags, node)
        self._h = hash(self._k)

    # -- constants ----------------------------------------------------------
    NONE: "Timestamp"
    MAX: "Timestamp"

    @staticmethod
    def min_for_epoch(epoch: int) -> "Timestamp":
        return Timestamp(epoch, 0, 0, 0)

    @staticmethod
    def max_for_epoch(epoch: int) -> "Timestamp":
        return Timestamp(epoch, MAX_HLC, MAX_NODE, MAX_FLAGS)

    # -- ordering -----------------------------------------------------------
    def _key(self) -> Tuple[int, int, int, int]:
        return self._k

    def __lt__(self, other: "Timestamp") -> bool:
        return self._k < other._k

    def __le__(self, other: "Timestamp") -> bool:
        return self._k <= other._k

    def __gt__(self, other: "Timestamp") -> bool:
        return self._k > other._k

    def __ge__(self, other: "Timestamp") -> bool:
        return self._k >= other._k

    def __eq__(self, other) -> bool:
        return isinstance(other, Timestamp) and self._k == other._k

    def __hash__(self) -> int:
        return self._h

    def compare_to(self, other: "Timestamp") -> int:
        a, b = self._k, other._k
        return -1 if a < b else (1 if a > b else 0)

    def __wire_rebuild__(self) -> None:
        """Recompute derived caches after slot-wise decode (maelstrom codec
        skips them on the wire)."""
        self._k = (self.epoch, self.hlc, self.flags, self.node)
        self._h = hash(self._k)

    # -- flags --------------------------------------------------------------
    @property
    def is_rejected(self) -> bool:
        return bool(self.flags & REJECTED_FLAG)

    def with_rejected(self) -> "Timestamp":
        return self.__class__._rebuild(self, self.flags | REJECTED_FLAG)

    @classmethod
    def _rebuild(cls, src: "Timestamp", flags: int) -> "Timestamp":
        return Timestamp(src.epoch, src.hlc, src.node, flags)

    # -- merge (Timestamp.mergeMax semantics) --------------------------------
    def merge_max(self, other: "Timestamp") -> "Timestamp":
        """max(self, other) but retaining MERGE_FLAGS from both operands."""
        bigger = self if self >= other else other
        merged_flags = bigger.flags | ((self.flags | other.flags) & MERGE_FLAGS)
        if merged_flags == bigger.flags:
            return bigger
        return bigger.__class__._rebuild(bigger, merged_flags)

    # -- device interchange --------------------------------------------------
    def pack64(self) -> Tuple[int, int]:
        """(msb, lsb) two-word packing matching the reference layout
        (Timestamp.java:40-45): msb = epoch<<16 | hlc>>48 ; lsb = hlc<<16 | flags.
        node rides separately in device tables (int32 column)."""
        return ((self.epoch << 16) | (self.hlc >> 48),
                ((self.hlc & ((1 << 48) - 1)) << 16) | self.flags)

    @staticmethod
    def unpack64(msb: int, lsb: int, node: int) -> "Timestamp":
        epoch = msb >> 16
        hlc = ((msb & 0xFFFF) << 48) | (lsb >> 16)
        return Timestamp(epoch, hlc, node, lsb & 0xFFFF)

    # device lane layout: five non-negative int32 lanes whose lexicographic order
    # equals the host total order (epoch, hlc, flags, node).  int32 keeps the
    # device plane free of x64 mode; bounds are checked here at the boundary.
    LANE_BOUNDS = ((1 << 31) - 1, (1 << 31) - 1, (1 << 31) - 1,
                   (1 << 16) - 1, (1 << 31) - 1)

    def pack_lanes(self) -> Tuple[int, int, int, int, int]:
        """(epoch, hlc>>31, hlc&0x7FFFFFFF, flags, node) — the device-table
        row for this timestamp (see ops.graph_state)."""
        check_argument(self.epoch < (1 << 31), "epoch exceeds device bound: %s", self.epoch)
        check_argument(self.hlc < (1 << 62), "hlc exceeds device bound: %s", self.hlc)
        check_argument(0 <= self.node < (1 << 31), "node exceeds device bound: %s", self.node)
        return (self.epoch, self.hlc >> 31, self.hlc & 0x7FFFFFFF,
                self.flags, self.node)

    @staticmethod
    def unpack_lanes(lanes) -> "Timestamp":
        epoch, hlc_hi, hlc_lo, flags, node = (int(x) for x in lanes)
        return Timestamp(epoch, (hlc_hi << 31) | hlc_lo, node, flags)

    def __repr__(self) -> str:
        r = "(R)" if self.is_rejected else ""
        return f"[{self.epoch},{self.hlc},{self.node}]{r}"


Timestamp.NONE = Timestamp(0, 0, 0, 0)
Timestamp.MAX = Timestamp(MAX_EPOCH, MAX_HLC, MAX_NODE, MAX_FLAGS)

# identity-flag layout for TxnId (TxnId.java:132-150): kind in 3 bits, domain in 1 bit
_KIND_SHIFT = 2
_DOMAIN_SHIFT = 1


class TxnId(Timestamp):
    """A Timestamp whose identity flags carry (Txn.Kind, Routable.Domain)."""

    __slots__ = ("_kind_c",)

    def __init__(self, epoch: int, hlc: int, node: int,
                 kind: TxnKind = TxnKind.WRITE, domain: Domain = Domain.KEY,
                 extra_flags: int = 0):
        flags = (extra_flags & ~0x1E) | (int(kind) << _KIND_SHIFT) | (int(domain) << _DOMAIN_SHIFT)
        super().__init__(epoch, hlc, node, flags)
        self._kind_c = TxnKind((flags >> _KIND_SHIFT) & 0x7)

    @property
    def kind(self) -> TxnKind:
        return self._kind_c

    def __wire_rebuild__(self) -> None:
        super().__wire_rebuild__()
        self._kind_c = TxnKind((self.flags >> _KIND_SHIFT) & 0x7)

    @property
    def domain(self) -> Domain:
        return Domain((self.flags >> _DOMAIN_SHIFT) & 0x1)

    @property
    def is_write(self) -> bool:
        return self.kind.is_write

    @property
    def is_read(self) -> bool:
        return self.kind.is_read

    @property
    def is_visible(self) -> bool:
        return self.kind.is_globally_visible

    @property
    def is_sync_point(self) -> bool:
        return self.kind.is_sync_point

    @property
    def awaits_only_deps(self) -> bool:
        return self.kind.awaits_only_deps

    def witnesses(self, other: "TxnId | TxnKind") -> bool:
        other_kind = other.kind if isinstance(other, TxnId) else other
        return self.kind.witnesses(other_kind)

    def witnessed_by(self, other: "TxnId | TxnKind") -> bool:
        other_kind = other.kind if isinstance(other, TxnId) else other
        return self.kind.witnessed_by(other_kind)

    @classmethod
    def _rebuild(cls, src: "TxnId", flags: int) -> "TxnId":
        t = TxnId.__new__(TxnId)
        Timestamp.__init__(t, src.epoch, src.hlc, src.node, flags)
        t._kind_c = TxnKind((flags >> _KIND_SHIFT) & 0x7)
        return t

    @staticmethod
    def from_timestamp(ts: Timestamp, kind: TxnKind, domain: Domain = Domain.KEY) -> "TxnId":
        return TxnId(ts.epoch, ts.hlc, ts.node, kind, domain)

    def as_timestamp(self) -> Timestamp:
        return Timestamp(self.epoch, self.hlc, self.node, self.flags)

    def __repr__(self) -> str:
        return (f"[{self.epoch},{self.hlc},{self.node}]"
                f"{self.kind.short_name}{'r' if self.domain is Domain.RANGE else 'k'}")


class Ballot(Timestamp):
    """Paxos-style promise token (Ballot.java)."""

    __slots__ = ()

    ZERO: "Ballot"
    MAX: "Ballot"

    @classmethod
    def _rebuild(cls, src: "Ballot", flags: int) -> "Ballot":
        b = Ballot.__new__(Ballot)
        Timestamp.__init__(b, src.epoch, src.hlc, src.node, flags)
        return b

    @staticmethod
    def from_timestamp(ts: Timestamp) -> "Ballot":
        b = Ballot.__new__(Ballot)
        Timestamp.__init__(b, ts.epoch, ts.hlc, ts.node, ts.flags)
        return b


Ballot.ZERO = Ballot(0, 0, 0, 0)
Ballot.MAX = Ballot.from_timestamp(Timestamp.MAX)
