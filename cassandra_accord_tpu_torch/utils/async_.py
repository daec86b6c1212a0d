"""Single-threaded async primitives.

Capability parity with ``accord.utils.async`` (AsyncChains.java:48-876,
AsyncResults.java): composable callback futures used throughout the protocol.  Unlike
the Java reference there are no real threads to coordinate here — every callback runs
inline or on an injected executor (in the simulation harness, the deterministic event
loop; in production, a shard's task queue) — so this is deliberately a small, allocation
-light implementation rather than a concurrency library.

Semantics preserved from the reference:
- an ``AsyncChain`` is single-consumption: ``begin(callback)`` may be invoked once;
- ``map``/``flat_map``/``recover`` build derived chains lazily;
- an ``AsyncResult`` is a settable, multi-listener terminal result; ``Settable``
  mirrors ``AsyncResults.SettableResult``.
"""
from __future__ import annotations

import traceback
from typing import Any, Callable, Generic, List, Optional, Tuple, TypeVar

from .invariants import InvariantViolation

T = TypeVar("T")
U = TypeVar("U")

Callback = Callable[[Optional[T], Optional[BaseException]], None]


class AsyncChain(Generic[T]):
    """Lazy, single-consumption async value. Subclasses implement ``_start``."""

    def __init__(self):
        self._begun = False

    # -- core ---------------------------------------------------------------
    def begin(self, callback: Callback) -> None:
        if self._begun:
            raise RuntimeError("AsyncChain already begun")
        self._begun = True
        self._start(callback)

    def _start(self, callback: Callback) -> None:
        raise NotImplementedError

    # -- combinators --------------------------------------------------------
    def map(self, fn: Callable[[T], U]) -> "AsyncChain[U]":
        return _Mapped(self, fn)

    def flat_map(self, fn: Callable[[T], "AsyncChain[U]"]) -> "AsyncChain[U]":
        return _FlatMapped(self, fn)

    def recover(self, fn: Callable[[BaseException], Optional[T]]) -> "AsyncChain[T]":
        return _Recovered(self, fn)

    def add_callback(self, fn: Callable[[], None]) -> "AsyncChain[T]":
        """Run ``fn`` on success, pass failures through."""
        def wrap(v):
            fn()
            return v
        return _Mapped(self, wrap)

    def begin_result(self) -> "AsyncResult[T]":
        """Begin this chain, exposing completion as a multi-listener AsyncResult."""
        result: Settable[T] = Settable()
        self.begin(lambda v, f: result.set_failure(f) if f is not None else result.set_success(v))
        return result


class _Mapped(AsyncChain[U]):
    def __init__(self, parent: AsyncChain[T], fn: Callable[[T], U]):
        super().__init__()
        self._parent, self._fn = parent, fn

    def _start(self, callback: Callback) -> None:
        def on_done(value, failure):
            if failure is not None:
                callback(None, failure)
                return
            try:
                mapped = self._fn(value)
            except BaseException as e:  # noqa: BLE001 — propagate to the chain consumer
                callback(None, e)
                return
            callback(mapped, None)
        self._parent.begin(on_done)


class _FlatMapped(AsyncChain[U]):
    def __init__(self, parent: AsyncChain[T], fn: Callable[[T], AsyncChain[U]]):
        super().__init__()
        self._parent, self._fn = parent, fn

    def _start(self, callback: Callback) -> None:
        def on_done(value, failure):
            if failure is not None:
                callback(None, failure)
                return
            try:
                nxt = self._fn(value)
            except BaseException as e:  # noqa: BLE001
                callback(None, e)
                return
            nxt.begin(callback)
        self._parent.begin(on_done)


class _Recovered(AsyncChain[T]):
    def __init__(self, parent: AsyncChain[T], fn: Callable[[BaseException], Optional[T]]):
        super().__init__()
        self._parent, self._fn = parent, fn

    def _start(self, callback: Callback) -> None:
        def on_done(value, failure):
            if failure is None:
                callback(value, None)
                return
            try:
                recovered = self._fn(failure)
            except BaseException as e:  # noqa: BLE001
                callback(None, e)
                return
            callback(recovered, None)
        self._parent.begin(on_done)


class _Immediate(AsyncChain[T]):
    def __init__(self, value=None, failure: Optional[BaseException] = None):
        super().__init__()
        self._value, self._failure = value, failure

    def _start(self, callback: Callback) -> None:
        callback(self._value, self._failure)


class _Deferred(AsyncChain[T]):
    """Chain produced from a function invoked at begin() time (possibly via executor)."""

    def __init__(self, fn: Callable[[], T], executor=None):
        super().__init__()
        self._fn, self._executor = fn, executor

    def _start(self, callback: Callback) -> None:
        def run():
            try:
                v = self._fn()
            except InvariantViolation:
                # paranoia-check failures must FAIL the run loudly, not be
                # converted into a failure reply the protocol will retry —
                # a broken invariant inside a message handler otherwise
                # becomes an infinite recovery livelock (the round-5 deps
                # parity violation burned exactly this way)
                raise
            except BaseException as e:  # noqa: BLE001
                callback(None, e)
                return
            callback(v, None)
        if self._executor is None:
            run()
        else:
            self._executor.execute(run)


class AsyncResult(Generic[T]):
    """A completed-or-pending result supporting many listeners (reference:
    AsyncResults). Also usable as an AsyncChain via ``to_chain``/``map``."""

    __slots__ = ("_done", "_value", "_failure", "_listeners")

    def __init__(self):
        self._done = False
        self._value: Optional[T] = None
        self._failure: Optional[BaseException] = None
        self._listeners: List[Callback] = []

    # -- inspection ---------------------------------------------------------
    def is_done(self) -> bool:
        return self._done

    def is_success(self) -> bool:
        return self._done and self._failure is None

    def is_failure(self) -> bool:
        return self._done and self._failure is not None

    @property
    def value(self) -> Optional[T]:
        if not self._done:
            raise RuntimeError("result not done")
        if self._failure is not None:
            raise self._failure
        return self._value

    @property
    def failure(self) -> Optional[BaseException]:
        return self._failure

    # -- listeners ----------------------------------------------------------
    def add_listener(self, callback: Callback) -> None:
        if self._done:
            callback(self._value, self._failure)
        else:
            self._listeners.append(callback)

    def add_success_listener(self, fn: Callable[[T], None]) -> None:
        self.add_listener(lambda v, f: fn(v) if f is None else None)

    # -- chain view ---------------------------------------------------------
    def to_chain(self) -> AsyncChain[T]:
        outer = self

        class _C(AsyncChain):
            def _start(self, callback: Callback) -> None:
                outer.add_listener(callback)

        return _C()

    def map(self, fn: Callable[[T], U]) -> AsyncChain[U]:
        return self.to_chain().map(fn)

    def flat_map(self, fn: Callable[[T], AsyncChain[U]]) -> AsyncChain[U]:
        return self.to_chain().flat_map(fn)

    # -- completion (internal; Settable exposes publicly) -------------------
    def _complete(self, value, failure) -> bool:
        if self._done:
            return False
        self._done = True
        self._value, self._failure = value, failure
        listeners, self._listeners = self._listeners, []
        for cb in listeners:
            cb(value, failure)
        return True


class Settable(AsyncResult[T]):
    """Externally-completable AsyncResult (reference: AsyncResults.SettableResult)."""

    __slots__ = ()

    def set_success(self, value: T = None) -> bool:
        return self._complete(value, None)

    def set_failure(self, failure: BaseException) -> bool:
        return self._complete(None, failure)

    def try_success(self, value: T = None) -> bool:
        return self.set_success(value)


# -- factory helpers --------------------------------------------------------

def settable() -> Settable:
    return Settable()


def done(value: T = None) -> AsyncChain[T]:
    return _Immediate(value=value)


def failure(exc: BaseException) -> AsyncChain:
    return _Immediate(failure=exc)


def of_callable(fn: Callable[[], T], executor=None) -> AsyncChain[T]:
    return _Deferred(fn, executor)


def success_result(value: T = None) -> AsyncResult[T]:
    r: Settable[T] = Settable()
    r.set_success(value)
    return r


def all_of(chains: List[AsyncChain]) -> AsyncChain[list]:
    """Completes with the list of all results, or the first failure (reference:
    AsyncChains.all / reduce)."""

    class _All(AsyncChain):
        def _start(self, callback: Callback) -> None:
            n = len(chains)
            if n == 0:
                callback([], None)
                return
            results = [None] * n
            state = {"remaining": n, "failed": False}

            def make(i):
                def on_done(value, fail):
                    if state["failed"]:
                        return
                    if fail is not None:
                        state["failed"] = True
                        callback(None, fail)
                        return
                    results[i] = value
                    state["remaining"] -= 1
                    if state["remaining"] == 0:
                        callback(results, None)
                return on_done

            for i, c in enumerate(chains):
                c.begin(make(i))

    return _All()
