"""Coordination failure hierarchy (accord.coordinate.CoordinationFailed family)."""
from __future__ import annotations

from typing import Optional

from ..primitives.timestamp import TxnId


class CoordinationFailed(Exception):
    def __init__(self, txn_id: Optional[TxnId] = None, msg: str = ""):
        super().__init__(f"{type(self).__name__}({txn_id}) {msg}".strip())
        self.txn_id = txn_id


class Timeout(CoordinationFailed):
    pass


class Preempted(CoordinationFailed):
    """A higher ballot took over coordination."""


class Invalidated(CoordinationFailed):
    """The txn was invalidated; it did not and will not execute."""


class Truncated(CoordinationFailed):
    """The txn's outcome was truncated before we could retrieve it."""


class Exhausted(CoordinationFailed):
    """Too many replicas failed to achieve a quorum."""


class Overloaded(CoordinationFailed):
    """Shed by admission control: the node refused new work while over its
    load watermark.  A fast, explicit nack — the caller learns in one
    round-trip what a timeout would have taken seconds to say."""


class Insufficient(CoordinationFailed):
    """A replica lacked the state needed to process a request."""


class TopologyMismatch(CoordinationFailed):
    pass


class StaleTopology(CoordinationFailed):
    pass
