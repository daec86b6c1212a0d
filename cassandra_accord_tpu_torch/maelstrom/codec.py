"""JSON wire codec for every accord message and primitive.

Capability parity with ``accord-maelstrom``'s ``Json.java`` (Json.java:1-300+, the
reference's only complete serialization codec): every Request/Reply and every
primitive they carry (timestamps, txn ids, keys/ranges/routes, deps, txn bodies,
writes, durability maps) round-trips through JSON for the Maelstrom stdio protocol.

Design: instead of a hand-written adapter per type (GSON-style), a single tagged
recursive codec over ``__slots__`` state, with a registry of serializable classes.
Containers and numpy arrays are tagged; enums encode by value; caches are skipped
and rebuilt lazily after decode.
"""
from __future__ import annotations

import enum
import json
from typing import Any, Dict, Tuple, Type

import numpy as np

_CLASSES: Dict[str, Tuple[Type, Tuple[str, ...]]] = {}
# derived caches: never on the wire; rebuilt at decode (None for the lazy
# ones, __wire_rebuild__ for the eager ones like Timestamp._k)
_SKIP_SLOTS = {"_inverted", "_k", "_kind_c", "_memo", "_h", "_tk", "_rk"}


def _all_slots(cls: Type) -> Tuple[str, ...]:
    out = []
    for klass in reversed(cls.__mro__):
        for s in getattr(klass, "__slots__", ()):
            if s not in out and s not in _SKIP_SLOTS:
                out.append(s)
    return tuple(out)


def register(cls: Type) -> Type:
    _CLASSES[cls.__name__] = (cls, _all_slots(cls))
    return cls


def _register_all() -> None:
    from ..api import interfaces as api
    from ..impl import list_store as ls
    from ..impl import noop_execution as noop
    from ..local import durability as dur
    from ..local.status import Durability, SaveStatus, Status
    from ..local import commands as C
    from ..messages import base as mb
    from ..messages import deps_messages as gdm
    from ..messages import durability_messages as dm
    from ..messages import ephemeral_messages as em
    from ..messages import fetch_messages as fm
    from ..messages import recovery_messages as rm
    from ..messages import status_messages as sm
    from ..messages import txn_messages as tm
    from ..primitives import deps as d
    from ..primitives import keys as k
    from ..primitives import latest_deps as ld
    from ..primitives import route as r
    from ..primitives import sync_point as spp
    from ..primitives import timestamp as t
    from ..primitives import txn as tx
    from ..utils.interval_map import ReducingIntervalMap

    for mod, names in (
        (t, ["Timestamp", "TxnId", "Ballot"]),
        (k, ["IntKey", "SentinelKey", "_Successor", "Range", "Keys",
             "RoutingKeys", "Ranges"]),
        (r, ["Route"]),
        (d, ["KeyDeps", "RangeDeps", "Deps"]),
        (ld, ["LatestDeps", "LatestEntry"]),
        (gdm, ["GetDeps", "GetDepsOk", "GetMaxConflict", "GetMaxConflictOk"]),
        (tx, ["Txn", "PartialTxn", "Writes"]),
        (spp, ["SyncPoint"]),
        (ls, ["ListRead", "ListRangeRead", "ListUpdate", "ListWrite",
              "ListQuery", "ListData", "ListResult"]),
        (noop, ["NoopRead", "NoopQuery", "NoopData", "NoopResult"]),
        (dur, ["RedundantBefore", "DurableBefore"]),
        (mb, ["FailureReply"]),
        (tm, ["SimpleOk", "PreAcceptOk", "PreAcceptNack", "AcceptOk", "AcceptNack",
              "CommitOk", "StableAck", "CommitNack", "ReadOk", "ReadNack",
              "ApplyOk", "PreAccept", "Accept", "Commit", "ReadTxnData", "Apply",
              "WaitUntilApplied"]),
        (rm, None),
        (sm, ["CheckStatusOk", "CheckStatus", "InformOfTxn", "InformDurable",
              "InformHomeDurable", "Propagate", "FindRoute", "FindRouteOk"]),
        (dm, ["SetShardDurable", "SetGloballyDurable", "DurableBeforeReply",
              "QueryDurableBefore"]),
        (em, ["GetEphemeralReadDepsOk", "GetEphemeralReadDeps",
              "ReadEphemeralTxnData"]),
        (fm, ["FetchStoreDataOk", "FetchStoreData"]),
    ):
        if names is None:
            # register every public class in the module
            names = [n for n in dir(mod)
                     if isinstance(getattr(mod, n), type) and not n.startswith("_")
                     and getattr(getattr(mod, n), "__module__", None) == mod.__name__]
        for name in names:
            cls = getattr(mod, name, None)
            if cls is not None:
                register(cls)

    from ..local.cfk import InternalStatus
    from ..primitives.latest_deps import KnownDeps
    for e in (t.TxnKind, t.Domain, SaveStatus, Status, Durability,
              C.AcceptOutcome, C.CommitOutcome, InternalStatus, KnownDeps):
        _CLASSES[e.__name__] = (e, ())

    # ReducingIntervalMap + DurableEntry/RedundantEntry (NamedTuples)
    register(ReducingIntervalMap)
    _CLASSES["DurableEntry"] = (dur.DurableEntry, ())
    _CLASSES["RedundantEntry"] = (dur.RedundantEntry, ())


def encode_value(obj: Any):
    if isinstance(obj, enum.Enum):
        # BEFORE the primitive branch: IntEnums (TxnKind, InternalStatus) are
        # ints and would otherwise lose their type on the wire.  By NAME:
        # enum values may be arbitrary tuples (SaveStatus ordinal+status)
        return {"$": type(obj).__name__, "v": obj.name, "e": 1}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.ndarray):
        return {"$": "nd", "dt": str(obj.dtype), "v": obj.tolist()}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):    # NamedTuple
        return {"$": type(obj).__name__, "nt": 1,
                "v": [encode_value(x) for x in obj]}
    if isinstance(obj, list):
        return {"$": "L", "v": [encode_value(x) for x in obj]}
    if isinstance(obj, tuple):
        return {"$": "T", "v": [encode_value(x) for x in obj]}
    if isinstance(obj, (set, frozenset)):
        return {"$": "S", "v": [encode_value(x) for x in obj]}
    if isinstance(obj, dict):
        return {"$": "D", "v": [[encode_value(k), encode_value(v)]
                                for k, v in obj.items()]}
    if isinstance(obj, BaseException):
        return {"$": "exc", "t": type(obj).__name__, "m": str(obj)}
    name = type(obj).__name__
    if name not in _CLASSES:
        raise TypeError(f"unregistered wire type: {name}")
    _cls, slots = _CLASSES[name]
    out = {"$": name}
    for s in slots:
        out[s] = encode_value(getattr(obj, s))
    # plain-__dict__ classes (and mixed slots+dict)
    for s, v in getattr(obj, "__dict__", {}).items():
        if s not in out and s not in _SKIP_SLOTS:
            out[s] = encode_value(v)
    return out


def decode_value(obj: Any):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [decode_value(x) for x in obj]
    assert isinstance(obj, dict), obj
    tag = obj["$"]
    if tag == "L":
        return [decode_value(x) for x in obj["v"]]
    if tag == "T":
        return tuple(decode_value(x) for x in obj["v"])
    if tag == "S":
        return set(decode_value(x) for x in obj["v"])
    if tag == "D":
        return {decode_value(k): decode_value(v) for k, v in obj["v"]}
    if tag == "nd":
        return np.asarray(obj["v"], dtype=obj["dt"])
    if tag == "exc":
        return RuntimeError(f"{obj['t']}: {obj['m']}")
    cls, slots = _CLASSES[tag]
    if obj.get("e"):
        return cls[obj["v"]]
    if obj.get("nt"):
        return cls(*[decode_value(x) for x in obj["v"]])
    inst = cls.__new__(cls)
    for s, v in obj.items():
        if s in ("$", "e", "nt"):
            continue
        setattr(inst, s, decode_value(v))
    for s in _SKIP_SLOTS:
        if s in getattr(cls, "__slots__", ()) or any(
                s in getattr(k, "__slots__", ()) for k in cls.__mro__):
            try:
                setattr(inst, s, None)
            except AttributeError:
                pass
    rebuild = getattr(inst, "__wire_rebuild__", None)
    if rebuild is not None:
        rebuild()
    return inst


def encode_message(message) -> dict:
    return encode_value(message)


def decode_message(payload: dict):
    return decode_value(payload)


def dumps(message) -> str:
    return json.dumps(encode_message(message), separators=(",", ":"))


def loads(s: str):
    return decode_message(json.loads(s))


_register_all()
