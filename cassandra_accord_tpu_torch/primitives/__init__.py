from .timestamp import Ballot, Domain, Timestamp, TxnId, TxnKind
from .keys import IntKey, Key, Keys, Range, Ranges, RoutingKey, RoutingKeys, SentinelKey
from .route import Route, Unseekables
from .deps import Deps, DepsBuilder, KeyDeps, KeyDepsBuilder, RangeDeps, RangeDepsBuilder
from .txn import PartialTxn, Seekables, Txn, Writes
from .sync_point import SyncPoint

__all__ = [
    "Ballot", "Domain", "Timestamp", "TxnId", "TxnKind",
    "IntKey", "Key", "Keys", "Range", "Ranges", "RoutingKey", "RoutingKeys", "SentinelKey",
    "Route", "Unseekables",
    "Deps", "DepsBuilder", "KeyDeps", "KeyDepsBuilder", "RangeDeps", "RangeDepsBuilder",
    "PartialTxn", "Seekables", "Txn", "Writes", "SyncPoint",
]
