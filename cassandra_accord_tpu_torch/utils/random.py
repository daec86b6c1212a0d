"""Injectable deterministic randomness.

Capability parity with ``accord.utils.RandomSource`` (RandomSource.java:1-410): a
seedable, forkable RNG handed to every component that needs randomness so a single seed
fully determines a simulation run.  Backed by Python's Mersenne Twister (stable across
platforms/versions for the methods used here).
"""
from __future__ import annotations

import random as _pyrandom
from typing import Optional, Sequence, TypeVar

T = TypeVar("T")


class RandomSource:
    __slots__ = ("_rng", "_seed")

    def __init__(self, seed: int):
        self._seed = seed
        self._rng = _pyrandom.Random(seed)

    @property
    def seed(self) -> int:
        return self._seed

    def fork(self) -> "RandomSource":
        """A new independent source deterministically derived from this one."""
        return RandomSource(self._rng.getrandbits(63))

    # -- scalars ------------------------------------------------------------
    def next_int(self, bound_or_min: int, bound: Optional[int] = None) -> int:
        """next_int(n) -> [0, n); next_int(lo, hi) -> [lo, hi)."""
        if bound is None:
            lo, hi = 0, bound_or_min
        else:
            lo, hi = bound_or_min, bound
        if hi <= lo:
            raise ValueError(f"empty range [{lo}, {hi})")
        return self._rng.randrange(lo, hi)

    def next_long(self, bound: Optional[int] = None) -> int:
        if bound is None:
            return self._rng.getrandbits(63)
        return self._rng.randrange(bound)

    def next_float(self) -> float:
        return self._rng.random()

    def next_boolean(self) -> bool:
        return self._rng.getrandbits(1) == 1

    def decide(self, probability: float) -> bool:
        """True with the given probability."""
        return self._rng.random() < probability

    def next_gaussian(self) -> float:
        return self._rng.gauss(0.0, 1.0)

    # -- biased ints (reference: RandomSource.nextBiasedInt) ----------------
    def next_biased_int(self, lo: int, median: int, hi: int) -> int:
        """Uniform-ish in [lo, hi) but with 50% of mass below ``median``."""
        if not (lo <= median < hi):
            raise ValueError(f"need lo <= median < hi, got {lo},{median},{hi}")
        if self._rng.getrandbits(1) and median > lo:
            return self._rng.randrange(lo, median)
        return self._rng.randrange(median, hi)

    # -- collections --------------------------------------------------------
    def pick(self, items: Sequence[T]) -> T:
        return items[self._rng.randrange(len(items))]

    def pick_weighted(self, items: Sequence[T], weights: Sequence[float]) -> T:
        return self._rng.choices(items, weights=weights, k=1)[0]

    def shuffle(self, items: list) -> list:
        self._rng.shuffle(items)
        return items

    def sample(self, items: Sequence[T], k: int) -> list:
        return self._rng.sample(list(items), k)

    # -- distributions ------------------------------------------------------
    def next_zipf(self, n: int, theta: float = 0.99) -> int:
        """Zipfian in [0, n) via inverse-CDF on the truncated zeta distribution.
        Used by workload generators (reference: Gens zipf distributions)."""
        # simple rejection-free approximation: harmonic inverse
        u = self._rng.random()
        # precompute-free: accumulate until we pass u * H_n
        # (n is small in workloads: tens of keys)
        h = 0.0
        terms = [1.0 / ((i + 1) ** theta) for i in range(n)]
        total = sum(terms)
        target = u * total
        for i, t in enumerate(terms):
            h += t
            if h >= target:
                return i
        return n - 1
