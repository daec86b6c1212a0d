"""Domain generators for property tests (accord.utils.AccordGens /
Gens.java:1-1073): txn ids, keys, ranges, deps, per-key indexes — each with
meaningful shrinking toward simpler instances."""
from __future__ import annotations

from typing import List, Tuple

from ..primitives.deps import Deps, DepsBuilder, KeyDeps, RangeDeps
from ..primitives.keys import IntKey, Range, Ranges, RoutingKeys
from ..primitives.timestamp import Ballot, Domain, Timestamp, TxnId, TxnKind
from . import property as prop

KEY_SPACE = 1000


def int_keys(lo: int = 0, hi: int = KEY_SPACE - 1) -> prop.Gen:
    return prop.ints(lo, hi).map(IntKey, "int_keys")


def routing_keys(lo: int = 0, hi: int = KEY_SPACE - 1) -> prop.Gen:
    return prop.ints(lo, hi).map(lambda v: IntKey(v).to_routing(),
                                 "routing_keys")


def txn_kinds(globally_visible_only: bool = True) -> prop.Gen:
    opts = [TxnKind.WRITE, TxnKind.READ]
    if not globally_visible_only:
        opts += [TxnKind.SYNC_POINT, TxnKind.EXCLUSIVE_SYNC_POINT]
    return prop.pick(opts)


def txn_ids(max_epoch: int = 3, max_hlc: int = 10_000,
            max_node: int = 8) -> prop.Gen:
    """Shrinks toward (epoch 1, hlc 0, node 1, WRITE)."""
    base = prop.tuples(prop.ints(1, max_epoch), prop.ints(0, max_hlc),
                       prop.ints(1, max_node), txn_kinds())

    def build(t):
        epoch, hlc, node, kind = t
        return TxnId(epoch, hlc, node, kind, Domain.KEY)

    def sample(rng):
        return build(base(rng))

    def shrink(v: TxnId):
        for cand in base.shrink((v.epoch, v.hlc, v.node, v.kind)):
            yield build(cand)
    return prop.Gen(sample, shrink, "txn_ids")


def timestamps(max_epoch: int = 3, max_hlc: int = 10_000,
               max_node: int = 8) -> prop.Gen:
    base = prop.tuples(prop.ints(1, max_epoch), prop.ints(0, max_hlc),
                       prop.ints(0, max_node))

    def build(t):
        return Timestamp(t[0], t[1], t[2])

    def sample(rng):
        return build(base(rng))

    def shrink(v: Timestamp):
        for cand in base.shrink((v.epoch, v.hlc, v.node)):
            yield build(cand)
    return prop.Gen(sample, shrink, "timestamps")


def ranges(max_ranges: int = 4, space: int = KEY_SPACE) -> prop.Gen:
    """Non-empty, sorted, non-overlapping half-open ranges; shrinks by
    dropping ranges."""
    bounds = prop.lists(prop.ints(0, space - 1), min_size=2,
                        max_size=2 * max_ranges)

    def build(bs: List[int]) -> Ranges:
        bs = sorted(set(bs))
        out = [Range(IntKey(bs[i]), IntKey(bs[i + 1]))
               for i in range(0, len(bs) - 1, 2)]
        return Ranges.of(*out)

    def sample(rng):
        return build(bounds(rng))

    def shrink(v: Ranges):
        rs = list(v)
        for i in range(len(rs)):
            if len(rs) > 1:
                yield Ranges.of(*(rs[:i] + rs[i + 1:]))
    return prop.Gen(sample, shrink, "ranges")


def key_deps_pairs(max_pairs: int = 24) -> prop.Gen:
    """The raw material of a KeyDeps: (routing key, txn id) incidences
    (KeyDepsTest.java builds from exactly this shape)."""
    return prop.lists(prop.tuples(routing_keys(), txn_ids()),
                      max_size=max_pairs)


def key_deps_from(pairs: List[Tuple]) -> KeyDeps:
    b = DepsBuilder()
    for rk, tid in pairs:
        b.add(rk, tid)
    return b.build().key_deps


def range_deps_pairs(max_pairs: int = 16) -> prop.Gen:
    def rng_gen():
        return prop.tuples(prop.ints(0, KEY_SPACE - 2), prop.ints(1, 50))
    base = prop.lists(prop.tuples(rng_gen(), txn_ids(
        )), max_size=max_pairs)

    def sample(rng):
        return base(rng)
    return prop.Gen(sample, base.shrink, "range_deps_pairs")


def range_deps_from(pairs) -> RangeDeps:
    b = DepsBuilder()
    for (start, width), tid in pairs:
        b.add(Range(IntKey(start), IntKey(min(KEY_SPACE, start + width))), tid)
    return b.build().range_deps
