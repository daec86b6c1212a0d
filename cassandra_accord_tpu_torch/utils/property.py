"""Seeded property testing with shrinking.

Capability parity with ``accord.utils.Property`` / ``Gens``
(Property.java:1-917, Gens.java:1-1073): the reference's deps/cfk/topology
suites are property-based — thousands of generated cases per invariant, with
failing cases shrunk to a minimal reproducer and reported with their seed.

Usage::

    @for_all(gens.lists(gens.ints(0, 100), max_size=20), tries=2000)
    def test_sorted_idempotent(xs):
        assert sorted(sorted(xs)) == sorted(xs)

A failing case is shrunk greedily (each argument in turn, re-running the
property on every candidate) and re-raised with the minimal arguments and
the reproducing seed in the message.
"""
from __future__ import annotations

import functools
import itertools
from typing import Any, Callable, Generic, Iterable, List, Optional, Sequence, TypeVar

from .random import RandomSource

T = TypeVar("T")


class Gen(Generic[T]):
    """A seeded generator + shrinker for values of one domain."""

    def __init__(self, sample: Callable[[RandomSource], T],
                 shrink: Optional[Callable[[T], Iterable[T]]] = None,
                 describe: str = "gen"):
        self._sample = sample
        self._shrink = shrink or (lambda v: ())
        self.describe = describe

    def __call__(self, rng: RandomSource) -> T:
        return self._sample(rng)

    def shrink(self, value: T) -> Iterable[T]:
        """Candidate SIMPLER values (each must itself be generatable)."""
        return self._shrink(value)

    def map(self, fn: Callable[[T], Any], describe: str = "mapped") -> "Gen":
        """Derived generator; shrinking happens in the SOURCE domain via
        ``flat`` tracking is not attempted — mapped gens shrink by mapping
        the source's shrinks."""
        src = self

        def sample(rng):
            return fn(src(rng))

        return Gen(sample, describe=describe)


# ---------------------------------------------------------------------------
# combinators (Gens.java)
# ---------------------------------------------------------------------------

def constant(value) -> Gen:
    return Gen(lambda rng: value, describe=f"constant({value!r})")


def ints(lo: int, hi: int) -> Gen:
    """Uniform int in [lo, hi]; shrinks toward lo."""
    def shrink(v):
        seen = set()
        # toward lo by halving the distance
        cur = v
        while cur != lo:
            cur = lo + (cur - lo) // 2
            if cur not in seen:
                seen.add(cur)
                yield cur
    return Gen(lambda rng: lo + rng.next_int(hi - lo + 1), shrink,
               describe=f"ints({lo},{hi})")


def booleans() -> Gen:
    return Gen(lambda rng: rng.next_boolean(),
               lambda v: (False,) if v else (), "booleans()")


def pick(options: Sequence) -> Gen:
    """Uniform choice; shrinks toward earlier options (order = simplicity)."""
    def shrink(v):
        i = options.index(v)
        for j in (0, i // 2):
            if j < i:
                yield options[j]
    return Gen(lambda rng: options[rng.next_int(len(options))], shrink,
               describe=f"pick({len(options)} options)")


def lists(elem: Gen, min_size: int = 0, max_size: int = 16) -> Gen:
    """List of ``elem``; shrinks by dropping chunks, then shrinking elements."""
    def sample(rng):
        n = min_size + rng.next_int(max_size - min_size + 1)
        return [elem(rng) for _ in range(n)]

    def shrink(v):
        n = len(v)
        # drop halves / single elements
        step = max(1, n // 2)
        while step >= 1:
            for i in range(0, n, step):
                cand = v[:i] + v[i + step:]
                if len(cand) >= min_size:
                    yield cand
            if step == 1:
                break
            step //= 2
        # shrink individual elements
        for i, x in enumerate(v):
            for sx in itertools.islice(elem.shrink(x), 4):
                yield v[:i] + [sx] + v[i + 1:]
    return Gen(sample, shrink, f"lists({elem.describe})")


def tuples(*gens: Gen) -> Gen:
    def sample(rng):
        return tuple(g(rng) for g in gens)

    def shrink(v):
        for i, g in enumerate(gens):
            for sx in itertools.islice(g.shrink(v[i]), 6):
                yield v[:i] + (sx,) + v[i + 1:]
    return Gen(sample, shrink, f"tuples({', '.join(g.describe for g in gens)})")


# ---------------------------------------------------------------------------
# the runner (Property.qt / forAll)
# ---------------------------------------------------------------------------

class PropertyFailure(AssertionError):
    def __init__(self, seed: int, case_no: int, args, original: BaseException,
                 shrunk_args=None, shrinks: int = 0):
        self.seed = seed
        self.case_no = case_no
        self.args = args
        self.shrunk_args = shrunk_args
        self.original = original
        msg = (f"property failed (seed={seed}, case={case_no}): {original!r}\n"
               f"  args:   {args!r}")
        if shrunk_args is not None and shrinks:
            msg += f"\n  shrunk ({shrinks} steps): {shrunk_args!r}"
        super().__init__(msg)


def for_all(*gens: Gen, tries: int = 1000, seed: int = 0xACC0,
            max_shrinks: int = 400):
    """Decorator: run the property over ``tries`` seeded cases; shrink and
    re-raise on failure.  The decorated function becomes a zero-arg callable
    (pytest-compatible)."""

    def decorate(fn: Callable) -> Callable:
        # NOTE: no functools.wraps — copying the wrapped signature would make
        # test runners treat the generated arguments as fixtures
        def run():
            rng = RandomSource(seed)
            for case_no in range(tries):
                case_rng = rng.fork()
                args = tuple(g(case_rng) for g in gens)
                try:
                    fn(*args)
                except BaseException as e:  # noqa: BLE001
                    shrunk, steps = _shrink(fn, gens, args, max_shrinks)
                    raise PropertyFailure(seed, case_no, args, e, shrunk,
                                          steps) from e
        run.property_tries = tries
        run.__name__ = getattr(fn, "__name__", "property")
        run.__doc__ = fn.__doc__
        return run
    return decorate


def _shrink(fn, gens, args, max_shrinks: int):
    """Greedy per-argument shrinking: accept any candidate that still fails."""
    cur = tuple(args)
    steps = 0
    budget = max_shrinks
    improved = True
    while improved and budget > 0:
        improved = False
        for i, g in enumerate(gens):
            for cand in g.shrink(cur[i]):
                if budget <= 0:
                    break
                budget -= 1
                trial = cur[:i] + (cand,) + cur[i + 1:]
                try:
                    fn(*trial)
                except BaseException:  # noqa: BLE001 — still failing: simpler!
                    cur = trial
                    steps += 1
                    improved = True
                    break
    return cur, steps
