"""Message base plumbing: Message/Request/Reply, the MessageType registry,
scope-sliced TxnRequest, and executor-pinned callbacks.

Capability parity with ``accord.messages`` base types (MessageType.java:36-82,
TxnRequest.java:1-310, Callback.java, Reply.java): every request knows how to process
itself replica-side against a Node; replies correlate to callers via an opaque
ReplyContext; TxnRequests carry a topology-sliced scope plus ``wait_for_epoch`` so a
replica defers processing until it has adopted the epoch.
"""
from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Optional

from ..primitives.keys import Ranges
from ..primitives.route import Route
from ..primitives.timestamp import TxnId
from ..utils.invariants import check_state

if TYPE_CHECKING:
    from ..local.node import Node
    from ..topology.topology import Topologies


class MessageType(enum.Enum):
    """Registry of remote message types + local PROPAGATE types
    (MessageType.java:36-82). ``has_side_effects`` marks messages whose processing
    may mutate durable replica state."""

    SIMPLE_RSP = ("SIMPLE_RSP", False)
    FAILURE_RSP = ("FAILURE_RSP", False)
    PRE_ACCEPT_REQ = ("PRE_ACCEPT_REQ", True)
    PRE_ACCEPT_RSP = ("PRE_ACCEPT_RSP", False)
    ACCEPT_REQ = ("ACCEPT_REQ", True)
    ACCEPT_RSP = ("ACCEPT_RSP", False)
    ACCEPT_INVALIDATE_REQ = ("ACCEPT_INVALIDATE_REQ", True)
    GET_DEPS_REQ = ("GET_DEPS_REQ", False)
    GET_DEPS_RSP = ("GET_DEPS_RSP", False)
    GET_EPHEMERAL_READ_DEPS_REQ = ("GET_EPHEMERAL_READ_DEPS_REQ", False)
    GET_EPHEMERAL_READ_DEPS_RSP = ("GET_EPHEMERAL_READ_DEPS_RSP", False)
    GET_MAX_CONFLICT_REQ = ("GET_MAX_CONFLICT_REQ", False)
    GET_MAX_CONFLICT_RSP = ("GET_MAX_CONFLICT_RSP", False)
    COMMIT_SLOW_PATH_REQ = ("COMMIT_SLOW_PATH_REQ", True)
    COMMIT_MAXIMAL_REQ = ("COMMIT_MAXIMAL_REQ", True)
    STABLE_FAST_PATH_REQ = ("STABLE_FAST_PATH_REQ", True)
    STABLE_SLOW_PATH_REQ = ("STABLE_SLOW_PATH_REQ", True)
    STABLE_MAXIMAL_REQ = ("STABLE_MAXIMAL_REQ", True)
    COMMIT_INVALIDATE_REQ = ("COMMIT_INVALIDATE_REQ", True)
    APPLY_MINIMAL_REQ = ("APPLY_MINIMAL_REQ", True)
    APPLY_MAXIMAL_REQ = ("APPLY_MAXIMAL_REQ", True)
    APPLY_RSP = ("APPLY_RSP", False)
    READ_REQ = ("READ_REQ", False)
    READ_EPHEMERAL_REQ = ("READ_EPHEMERAL_REQ", False)
    READ_RSP = ("READ_RSP", False)
    BEGIN_RECOVER_REQ = ("BEGIN_RECOVER_REQ", True)
    BEGIN_RECOVER_RSP = ("BEGIN_RECOVER_RSP", False)
    BEGIN_INVALIDATE_REQ = ("BEGIN_INVALIDATE_REQ", True)
    BEGIN_INVALIDATE_RSP = ("BEGIN_INVALIDATE_RSP", False)
    WAIT_ON_COMMIT_REQ = ("WAIT_ON_COMMIT_REQ", False)
    WAIT_ON_COMMIT_RSP = ("WAIT_ON_COMMIT_RSP", False)
    WAIT_UNTIL_APPLIED_REQ = ("WAIT_UNTIL_APPLIED_REQ", False)
    APPLY_THEN_WAIT_UNTIL_APPLIED_REQ = ("APPLY_THEN_WAIT_UNTIL_APPLIED_REQ", True)
    RECOVER_AWAIT_REQ = ("RECOVER_AWAIT_REQ", False)
    CHECK_STATUS_REQ = ("CHECK_STATUS_REQ", False)
    CHECK_STATUS_RSP = ("CHECK_STATUS_RSP", False)
    FETCH_DATA_REQ = ("FETCH_DATA_REQ", False)
    FETCH_DATA_RSP = ("FETCH_DATA_RSP", False)
    SET_SHARD_DURABLE_REQ = ("SET_SHARD_DURABLE_REQ", True)
    SET_GLOBALLY_DURABLE_REQ = ("SET_GLOBALLY_DURABLE_REQ", True)
    QUERY_DURABLE_BEFORE_REQ = ("QUERY_DURABLE_BEFORE_REQ", False)
    QUERY_DURABLE_BEFORE_RSP = ("QUERY_DURABLE_BEFORE_RSP", False)
    INFORM_OF_TXN_REQ = ("INFORM_OF_TXN_REQ", True)
    FIND_ROUTE_REQ = ("FIND_ROUTE_REQ", False)
    FIND_ROUTE_RSP = ("FIND_ROUTE_RSP", False)
    INFORM_DURABLE_REQ = ("INFORM_DURABLE_REQ", True)
    INFORM_HOME_DURABLE_REQ = ("INFORM_HOME_DURABLE_REQ", True)
    # local-only message types (Propagate family)
    PROPAGATE_PRE_ACCEPT_MSG = ("PROPAGATE_PRE_ACCEPT_MSG", True)
    PROPAGATE_STABLE_MSG = ("PROPAGATE_STABLE_MSG", True)
    PROPAGATE_APPLY_MSG = ("PROPAGATE_APPLY_MSG", True)
    PROPAGATE_OTHER_MSG = ("PROPAGATE_OTHER_MSG", True)

    def __init__(self, _name: str, has_side_effects: bool):
        self.has_side_effects = has_side_effects


class Message:
    __slots__ = ()

    @property
    def type(self) -> MessageType:
        raise NotImplementedError


class Request(Message):
    """A message processed replica-side via ``process(node, from_node, reply_ctx)``."""

    __slots__ = ()

    def process(self, node: "Node", from_node: int, reply_context) -> None:
        raise NotImplementedError

    def wait_for_epoch(self) -> int:
        """Replica must have adopted this epoch before processing (TxnRequest)."""
        return 0

    def prefetch_specs(self, node: "Node"):
        """Deps queries this request WILL issue when processed, as
        (command_store, impl.resolver.QuerySpec) pairs — lets a coalesced
        delivery window answer a whole batch's queries in one device launch
        (TpuDepsResolver.prefetch).  Best-effort: over- or under-declaring is
        harmless (unused answers are dropped; undeclared queries launch
        individually)."""
        return None


class _LocalNoReply:
    """Reply context for self-delivered LOCAL requests (Propagate family):
    sinks drop any reply addressed to it."""
    __slots__ = ()

    def __repr__(self):
        return "LOCAL_NO_REPLY"


LOCAL_NO_REPLY = _LocalNoReply()


class Reply(Message):
    __slots__ = ()

    @property
    def is_final(self) -> bool:
        """Non-final replies keep the callback registered (e.g. ReadOk streaming)."""
        return True


class FailureReply(Reply):
    __slots__ = ("failure",)

    def __init__(self, failure: BaseException):
        self.failure = failure

    @property
    def type(self) -> MessageType:
        return MessageType.FAILURE_RSP

    def __repr__(self) -> str:
        return f"FailureReply({self.failure!r})"


class Callback:
    """Coordinator-side reply handler; the harness pins each callback to the
    originating executor (Callback.java / SafeCallback semantics)."""

    __slots__ = ()

    def on_success(self, from_node: int, reply: Reply) -> None:
        raise NotImplementedError

    def on_failure(self, from_node: int, failure: BaseException) -> None:
        raise NotImplementedError

    def on_callback_failure(self, from_node: int, failure: BaseException) -> None:
        raise failure


class TxnRequest(Request):
    """A request scoped to one replica's intersection with a route
    (TxnRequest.java:1-310): ``scope`` is the route sliced to the ranges the
    recipient owns over the relevant epochs; ``wait_for_epoch`` gates processing."""

    __slots__ = ("txn_id", "scope", "_wait_for_epoch", "min_epoch")

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int, min_epoch: int = 0):
        self.txn_id = txn_id
        self.scope = scope
        self._wait_for_epoch = wait_for_epoch
        self.min_epoch = min_epoch or wait_for_epoch

    def wait_for_epoch(self) -> int:
        return self._wait_for_epoch

    def preload_ids(self):
        """PreLoadContext declaration (PreLoadContext.java): the txn ids this
        request's in-store processing touches.  Evicted ones are loaded
        asynchronously BEFORE the operation task runs; subclasses whose
        handlers walk dependencies (Commit, Apply) extend this."""
        return (self.txn_id,)

    @staticmethod
    def compute_scope(to_node: int, topologies: "Topologies", route: Route) -> Optional[Route]:
        """Slice ``route`` to the ranges ``to_node`` replicates across the given
        epochs (latest-epoch-first union, TxnRequest.computeScope)."""
        ranges = Ranges.EMPTY
        for topology in topologies:
            ranges = ranges.union(topology.ranges_for_node(to_node))
        sliced = route.slice(ranges)
        return None if sliced.is_empty() else sliced

    @staticmethod
    def compute_wait_for_epoch(to_node: int, topologies: "Topologies") -> int:
        """Highest epoch in which ``to_node`` participates (TxnRequest
        .computeWaitForEpoch) — no point waiting for epochs it has no ranges in."""
        wait = topologies.oldest_epoch
        for topology in topologies:
            if topology.ranges_for_node(to_node):
                wait = max(wait, topology.epoch)
        return wait
