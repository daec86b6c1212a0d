"""The command status lattice.

Capability parity with ``accord.local.SaveStatus/Status`` (SaveStatus.java:51-92,
Status.java:47-964): a command progresses monotonically through phases
None -> PreAccept -> Accept -> Commit -> Execute -> Persist -> Cleanup; ``SaveStatus``
refines Status with the local-execution sub-states (WaitingToExecute ->
ReadyToExecute -> WaitingToApply -> Applying -> Applied) and the truncation/erasure
terminal states.  The ``Known`` lattice tracks which facts about a txn a replica has
(route / definition / executeAt / deps / outcome) and is what CheckStatus merges
across replicas during recovery.
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Optional


class Phase(enum.IntEnum):
    NONE = 0
    PRE_ACCEPT = 1
    ACCEPT = 2
    COMMIT = 3
    EXECUTE = 4
    PERSIST = 5
    CLEANUP = 6


class Status(enum.Enum):
    """Coarse protocol status (Status.java)."""
    NOT_DEFINED = (0, Phase.NONE)
    PRE_ACCEPTED = (1, Phase.PRE_ACCEPT)
    ACCEPTED_INVALIDATE = (2, Phase.ACCEPT)
    ACCEPTED = (3, Phase.ACCEPT)
    PRE_COMMITTED = (4, Phase.COMMIT)
    COMMITTED = (5, Phase.COMMIT)
    STABLE = (6, Phase.EXECUTE)
    PRE_APPLIED = (7, Phase.PERSIST)
    APPLIED = (8, Phase.PERSIST)
    TRUNCATED = (9, Phase.CLEANUP)
    INVALIDATED = (10, Phase.CLEANUP)

    def __init__(self, ordinal: int, phase: Phase):
        self.ordinal = ordinal
        self.phase = phase

    def has_been(self, other: "Status") -> bool:
        return self.ordinal >= other.ordinal

    def __lt__(self, other: "Status") -> bool:
        return self.ordinal < other.ordinal

    def __le__(self, other: "Status") -> bool:
        return self.ordinal <= other.ordinal

    def __gt__(self, other: "Status") -> bool:
        return self.ordinal > other.ordinal

    def __ge__(self, other: "Status") -> bool:
        return self.ordinal >= other.ordinal


class SaveStatus(enum.Enum):
    """Fine-grained save state (SaveStatus.java:51-92), including LocalExecution."""
    NOT_DEFINED = (0, Status.NOT_DEFINED)
    PRE_ACCEPTED = (1, Status.PRE_ACCEPTED)
    ACCEPTED_INVALIDATE = (2, Status.ACCEPTED_INVALIDATE)
    ACCEPTED = (3, Status.ACCEPTED)
    PRE_COMMITTED = (4, Status.PRE_COMMITTED)
    COMMITTED = (5, Status.COMMITTED)
    STABLE = (6, Status.STABLE)                   # == WaitingToExecute
    READY_TO_EXECUTE = (7, Status.STABLE)
    PRE_APPLIED = (8, Status.PRE_APPLIED)         # == WaitingToApply
    APPLYING = (9, Status.PRE_APPLIED)
    APPLIED = (10, Status.APPLIED)
    TRUNCATED_APPLY = (11, Status.TRUNCATED)
    ERASED = (12, Status.TRUNCATED)
    INVALIDATED = (13, Status.INVALIDATED)

    def __init__(self, ordinal: int, status: Status):
        self.ordinal = ordinal
        self.status = status

    @property
    def phase(self) -> Phase:
        return self.status.phase

    def has_been(self, status: Status) -> bool:
        return self.status.has_been(status)

    @property
    def is_terminal(self) -> bool:
        return self in (SaveStatus.APPLIED, SaveStatus.TRUNCATED_APPLY,
                        SaveStatus.ERASED, SaveStatus.INVALIDATED)

    @property
    def is_truncated(self) -> bool:
        return self in (SaveStatus.TRUNCATED_APPLY, SaveStatus.ERASED)

    @property
    def is_decided(self) -> bool:
        """executeAt agreed (committed) or invalidated."""
        return self.has_been(Status.PRE_COMMITTED)

    def __lt__(self, other: "SaveStatus") -> bool:
        return self.ordinal < other.ordinal

    def __le__(self, other: "SaveStatus") -> bool:
        return self.ordinal <= other.ordinal

    def __gt__(self, other: "SaveStatus") -> bool:
        return self.ordinal > other.ordinal

    def __ge__(self, other: "SaveStatus") -> bool:
        return self.ordinal >= other.ordinal


class Durability(enum.IntEnum):
    """Durability of a txn's outcome across its shards (Status.java:862)."""
    NOT_DURABLE = 0
    LOCAL = 1
    SHARD_UNIVERSAL = 2     # durable on every healthy replica of this shard
    MAJORITY = 3            # durable at a majority of every shard
    UNIVERSAL = 4           # durable at every healthy replica of every shard

    @property
    def is_durable(self) -> bool:
        return self >= Durability.MAJORITY

    @property
    def is_durable_or_invalidated(self) -> bool:
        return self.is_durable


# -- the Known lattice (Status.java:455-860) ---------------------------------

class KnownRoute(enum.IntEnum):
    MAYBE = 0
    COVERING = 1
    FULL = 2


class Definition(enum.IntEnum):
    UNKNOWN = 0
    KNOWN = 1
    ERASED = 2


class KnownExecuteAt(enum.IntEnum):
    UNKNOWN = 0
    PROPOSED = 1
    KNOWN = 2
    NO_EXECUTE_AT = 3      # invalidated


class KnownDeps(enum.IntEnum):
    UNKNOWN = 0
    PROPOSED = 1
    COMMITTED = 2          # deps agreed at commit
    KNOWN = 3              # stable deps
    NO_DEPS = 4            # invalidated / not needed


class Outcome(enum.IntEnum):
    UNKNOWN = 0
    APPLY = 1              # writes/result known
    INVALIDATED = 2
    ERASED = 3


class Known(NamedTuple):
    """What a replica knows about a txn; merged across replicas by CheckStatus."""
    route: KnownRoute = KnownRoute.MAYBE
    definition: Definition = Definition.UNKNOWN
    execute_at: KnownExecuteAt = KnownExecuteAt.UNKNOWN
    deps: KnownDeps = KnownDeps.UNKNOWN
    outcome: Outcome = Outcome.UNKNOWN

    def merge(self, other: "Known") -> "Known":
        return Known(
            max(self.route, other.route),
            max(self.definition, other.definition),
            max(self.execute_at, other.execute_at),
            max(self.deps, other.deps),
            max(self.outcome, other.outcome),
        )

    @property
    def is_definition_known(self) -> bool:
        return self.definition is Definition.KNOWN

    @property
    def is_decision_known(self) -> bool:
        return self.execute_at in (KnownExecuteAt.KNOWN, KnownExecuteAt.NO_EXECUTE_AT)

    @property
    def is_outcome_known(self) -> bool:
        return self.outcome is not Outcome.UNKNOWN


def known_for(save_status: SaveStatus, has_route: bool, has_txn: bool) -> Known:
    """Project a replica's SaveStatus onto the Known lattice."""
    route = KnownRoute.FULL if has_route else KnownRoute.MAYBE
    definition = Definition.KNOWN if has_txn else Definition.UNKNOWN
    if save_status is SaveStatus.INVALIDATED:
        return Known(route, definition, KnownExecuteAt.NO_EXECUTE_AT, KnownDeps.NO_DEPS,
                     Outcome.INVALIDATED)
    if save_status is SaveStatus.ERASED:
        return Known(route, Definition.ERASED, KnownExecuteAt.UNKNOWN, KnownDeps.UNKNOWN,
                     Outcome.ERASED)
    execute_at = KnownExecuteAt.UNKNOWN
    if save_status.has_been(Status.PRE_COMMITTED):
        execute_at = KnownExecuteAt.KNOWN
    elif save_status.has_been(Status.ACCEPTED):
        execute_at = KnownExecuteAt.PROPOSED
    deps = KnownDeps.UNKNOWN
    if save_status.has_been(Status.STABLE):
        deps = KnownDeps.KNOWN
    elif save_status.has_been(Status.COMMITTED):
        deps = KnownDeps.COMMITTED
    elif save_status in (SaveStatus.ACCEPTED, SaveStatus.PRE_ACCEPTED):
        deps = KnownDeps.PROPOSED
    outcome = Outcome.APPLY if save_status.has_been(Status.PRE_APPLIED) else Outcome.UNKNOWN
    return Known(route, definition, execute_at, deps, outcome)
