"""No-op Read/Query/Result used by empty system txns (sync points, barriers).

Parity: the reference constructs empty txns via ``Agent.emptySystemTxn``
(Agent.java:88-97) with reads that touch nothing.
"""
from __future__ import annotations

from ..api.interfaces import Data, Query, Read, Result
from ..utils import async_ as au


class NoopData(Data):
    def merge(self, other):
        return other if other is not None else self


class NoopRead(Read):
    def __init__(self, keys):
        self._keys = keys

    def keys(self):
        return self._keys

    def read(self, key, safe_store, execute_at, data_store):
        return au.done(None)

    def slice(self, ranges):
        from ..primitives.keys import Keys, Ranges
        if isinstance(self._keys, Ranges):
            return NoopRead(self._keys.intersection(ranges))
        return NoopRead(self._keys.slice(ranges))

    def merge(self, other):
        if isinstance(other, NoopRead):
            return NoopRead(self._keys.union(other._keys))
        return other


class NoopResult(Result):
    def __repr__(self):
        return "NoopResult"


class NoopQuery(Query):
    def compute(self, txn_id, execute_at, keys, data, read, update):
        return NOOP_RESULT


NOOP_RESULT = NoopResult()
NOOP_QUERY = NoopQuery()
