"""Routing projections of a transaction's footprint.

Capability parity with the reference Route family (Route.java, KeyRoute.java,
RangeRoute.java, RoutingKeys.java, Participants.java): an *unseekable* projection of a
txn's keys/ranges used to address messages to shards, carrying a designated **homeKey**
— the key whose shard owns progress/recovery duty for the txn.

Simplification vs the reference: one ``Route`` class parameterized by domain, holding
either RoutingKeys or Ranges plus ``home_key`` and a ``full`` flag (whether this route
covers the txn's entire footprint, vs a partial slice held by one replica).
"""
from __future__ import annotations

from typing import Optional, Union

from ..utils.invariants import check_argument, check_state
from .keys import Range, Ranges, RoutingKey, RoutingKeys
from .timestamp import Domain

Unseekables = Union[RoutingKeys, Ranges]


class Route:
    __slots__ = ("home_key", "unseekables", "full", "covering")

    def __init__(self, home_key: RoutingKey, unseekables: Unseekables, full: bool = True,
                 covering: Optional[Ranges] = None):
        check_argument(home_key is not None, "route requires a homeKey")
        self.home_key = home_key
        self.unseekables = unseekables
        self.full = full
        # for partial routes: the ranges this route was sliced to (reference
        # PartialRoute.covering) — what the route is authoritative for
        self.covering = covering

    # -- constructors -------------------------------------------------------
    @staticmethod
    def for_keys(home_key: RoutingKey, keys: RoutingKeys) -> "Route":
        if not keys.contains(home_key):
            keys = keys.union(RoutingKeys.of([home_key]))
        return Route(home_key, keys, full=True)

    @staticmethod
    def for_ranges(home_key: RoutingKey, ranges: Ranges) -> "Route":
        return Route(home_key, ranges, full=True)

    # -- domain -------------------------------------------------------------
    @property
    def domain(self) -> Domain:
        return Domain.RANGE if isinstance(self.unseekables, Ranges) else Domain.KEY

    @property
    def is_full(self) -> bool:
        return self.full

    # -- participants -------------------------------------------------------
    def participants(self) -> Unseekables:
        return self.unseekables

    def covers(self, ranges: Ranges) -> bool:
        """Is this route authoritative for all of ``ranges``? A full route covers
        everything; a partial route covers exactly the ranges it was sliced to."""
        if self.full:
            return True
        return self.covering is not None and self.covering.contains_all(ranges)

    def intersects(self, ranges: Ranges) -> bool:
        return self.unseekables.intersects(ranges) if len(self.unseekables) else False

    def contains(self, key: RoutingKey) -> bool:
        return self.unseekables.contains(key)

    # -- slicing ------------------------------------------------------------
    def slice(self, ranges: Ranges) -> "Route":
        if isinstance(self.unseekables, Ranges):
            sliced = self.unseekables.intersection(ranges)
        else:
            sliced = self.unseekables.slice(ranges)
        covering = ranges if (self.full or self.covering is None) \
            else self.covering.intersection(ranges)
        return Route(self.home_key, sliced, full=False, covering=covering)

    def union(self, other: "Route") -> "Route":
        check_state(self.home_key == other.home_key, "cannot union routes with different homeKeys")
        a, b = self.unseekables, other.unseekables
        # mixed domains (a key-backed partial meeting the range-backed real
        # route): lift keys to their unit covering ranges — unioning the raw
        # containers would corrupt the route
        if isinstance(a, Ranges) and isinstance(b, RoutingKeys):
            b = b.to_ranges()
        elif isinstance(a, RoutingKeys) and isinstance(b, Ranges):
            a = a.to_ranges()
        u = a.union(b)
        full = self.full or other.full
        covering = None
        if not full and self.covering is not None and other.covering is not None:
            covering = self.covering.union(other.covering)
        return Route(self.home_key, u, full=full, covering=covering)

    def with_home_key(self) -> "Route":
        if isinstance(self.unseekables, RoutingKeys) and not self.unseekables.contains(self.home_key):
            return Route(self.home_key, self.unseekables.union(RoutingKeys.of([self.home_key])), self.full)
        return self

    def home_key_only(self) -> "Route":
        """A partial route claiming only the home key — in the SAME domain as
        this route: a range-domain txn's home-only route must stay
        range-backed, or a later CheckStatusOk.merge unioning it with the
        real route mixes keys into ranges and corrupts the route."""
        if isinstance(self.unseekables, Ranges):
            only = RoutingKeys.of([self.home_key]).to_ranges()
            return Route(self.home_key, only, full=False)
        return Route(self.home_key, RoutingKeys.of([self.home_key]), full=False)

    def is_empty(self) -> bool:
        return self.unseekables.is_empty()

    def __eq__(self, other) -> bool:
        return (isinstance(other, Route) and self.home_key == other.home_key
                and self.unseekables == other.unseekables and self.full == other.full)

    def __hash__(self):
        return hash((self.home_key, self.unseekables, self.full))

    def __repr__(self) -> str:
        tag = "Full" if self.full else "Partial"
        return f"{tag}Route(home={self.home_key}, {self.unseekables!r})"
