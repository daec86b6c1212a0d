from .invariants import Invariants, Paranoia
from .random import RandomSource
from .async_ import AsyncResult, AsyncChain, settable, done, failure
from .interval_map import ReducingIntervalMap

__all__ = [
    "Invariants",
    "Paranoia",
    "RandomSource",
    "AsyncResult",
    "AsyncChain",
    "settable",
    "done",
    "failure",
    "ReducingIntervalMap",
]
