"""SPI interface definitions (abstract base classes).

Each mirrors a reference interface; file:line citations point at the contract source:
- Agent                   accord/api/Agent.java:34-97
- DataStore               accord/api/DataStore.java:39-113
- MessageSink             accord/api/MessageSink.java
- ConfigurationService    accord/api/ConfigurationService.java:60-183
- ProgressLog             accord/api/ProgressLog.java:59-213
- Scheduler               accord/api/Scheduler.java
- Read/Update/Query/...   accord/api/{Read,Update,Query,Write,Data,Result}.java
- TopologySorter          accord/api/TopologySorter.java
- EventsListener          accord/api/EventsListener.java:26-60
- BarrierType             accord/api/BarrierType.java
- LocalConfig             accord/config/LocalConfig.java
"""
from __future__ import annotations

import abc
import enum
from typing import TYPE_CHECKING, Callable, Iterable, List, Optional

if TYPE_CHECKING:
    from ..primitives.keys import Key, Keys, Ranges, RoutingKey
    from ..primitives.timestamp import Timestamp, TxnId
    from ..utils.async_ import AsyncChain, AsyncResult


class Agent(abc.ABC):
    """Policy + failure callbacks injected into the Node."""

    def on_recover(self, node, success, fail) -> None:
        pass

    def on_inconsistent_timestamp(self, command, prev: "Timestamp", next_: "Timestamp") -> None:
        raise AssertionError(f"inconsistent timestamp on {command}: {prev} vs {next_}")

    def on_failed_bootstrap(self, phase: str, ranges: "Ranges", retry: Callable[[], None],
                            failure: BaseException) -> None:
        retry()

    def on_stale(self, stale_since: "Timestamp", ranges: "Ranges") -> None:
        pass

    def on_uncaught_exception(self, failure: BaseException) -> None:
        raise failure

    def on_handled_exception(self, failure: BaseException) -> None:
        pass

    def pre_accept_timeout(self) -> float:
        """Seconds a coordinator waits for PreAccept before invalidating."""
        return 1.0

    def cfk_hlc_prune_delta(self) -> int:
        """How far behind the max HLC a CommandsForKey entry must be to prune."""
        return 1000

    def cfk_prune_interval(self) -> int:
        return 32

    def is_expired(self, initiated_micros: int, now_micros: int) -> bool:
        return now_micros - initiated_micros > int(self.pre_accept_timeout() * 1_000_000)

    def empty_system_txn(self, kind, keys_or_ranges):
        """An empty Txn of the given kind (used by sync points)."""
        from ..primitives.txn import Txn
        return Txn.empty(kind, keys_or_ranges)

    def metrics_events_listener(self) -> "EventsListener":
        return EventsListener.NOOP


class EventsListener:
    """Metrics hooks (EventsListener.java:26-60)."""

    NOOP: "EventsListener"

    def on_committed(self, command) -> None: ...
    def on_stable(self, command) -> None: ...
    def on_executed(self, command) -> None: ...
    def on_applied(self, command, t0_micros: int) -> None: ...
    def on_fast_path_taken(self, txn_id, deps) -> None: ...
    def on_slow_path_taken(self, txn_id, deps) -> None: ...
    def on_recover(self, txn_id, ballot) -> None: ...
    def on_preempted(self, txn_id) -> None: ...
    def on_timeout(self, txn_id) -> None: ...


EventsListener.NOOP = EventsListener()


class Data(abc.ABC):
    """Result of reading one or more keys; mergeable (Data.java)."""

    @abc.abstractmethod
    def merge(self, other: "Data") -> "Data": ...


class Result:
    """Opaque client-visible txn result (Result.java)."""


class Write(abc.ABC):
    """The computed effect of an Update on one key (Write.java)."""

    @abc.abstractmethod
    def apply(self, store: "DataStore", key, execute_at: "Timestamp") -> "AsyncChain":
        ...

    def merge(self, other: "Write") -> "Write":
        """Union of two per-shard slices of the same txn's write effect.
        Implementations whose slices can differ MUST override; silently keeping
        one slice would lose the other's effects."""
        if other is not self and other is not None:
            raise NotImplementedError(
                f"{type(self).__name__}.merge: per-shard write slices cannot be "
                "combined without an implementation-specific merge")
        return self


class Read(abc.ABC):
    """Read hook (Read.java): executed replica-side at executeAt."""

    @abc.abstractmethod
    def keys(self):
        """Seekables this read touches."""

    @abc.abstractmethod
    def read(self, key, safe_store, execute_at: "Timestamp", data_store: "DataStore") -> "AsyncChain[Data]":
        ...

    @abc.abstractmethod
    def slice(self, ranges: "Ranges") -> "Read": ...

    @abc.abstractmethod
    def merge(self, other: "Read") -> "Read": ...


class Update(abc.ABC):
    """Update hook (Update.java): turns read Data into Writes at execution time."""

    @abc.abstractmethod
    def keys(self): ...

    @abc.abstractmethod
    def apply(self, execute_at: "Timestamp", data: Optional[Data]) -> "Write | dict":
        """Compute per-key writes from the read data."""

    @abc.abstractmethod
    def slice(self, ranges: "Ranges") -> "Update": ...

    @abc.abstractmethod
    def merge(self, other: "Update") -> "Update": ...


class Query(abc.ABC):
    """Computes the client Result from read Data (Query.java)."""

    @abc.abstractmethod
    def compute(self, txn_id: "TxnId", execute_at: "Timestamp", keys,
                data: Optional[Data], read: Optional[Read], update: Optional[Update]) -> Result:
        ...


class FetchRanges(abc.ABC):
    """Callbacks a DataStore.fetch implementation drives (DataStore.java:39-113)."""

    @abc.abstractmethod
    def starting(self, ranges: "Ranges"):
        """Declare a fetch of ``ranges`` is starting; returns a StartingRangeFetch
        handle with started()/cancel() controls."""

    @abc.abstractmethod
    def fetched(self, ranges: "Ranges") -> None: ...

    @abc.abstractmethod
    def fail(self, ranges: "Ranges", failure: BaseException) -> None: ...


class DataStore(abc.ABC):
    """Storage hook; also the bootstrap fetch API."""

    class FetchResult:
        """AsyncResult of a fetch with abort()."""

    def fetch(self, node, safe_store, ranges: "Ranges", sync_point,
              fetch_ranges: FetchRanges, catch_up: bool = False):
        """Fetch data for newly-adopted ranges up to ``sync_point``; default impl for
        in-memory stores completes immediately (harness ListStore overrides)."""
        raise NotImplementedError

    def snapshot(self, ranges: "Ranges", before) -> object:
        raise NotImplementedError


class MessageSink(abc.ABC):
    @abc.abstractmethod
    def send(self, to: int, request) -> None: ...

    @abc.abstractmethod
    def send_with_callback(self, to: int, request, callback) -> None: ...

    @abc.abstractmethod
    def reply(self, to: int, reply_context, reply) -> None: ...

    def reply_with_unknown_failure(self, to: int, reply_context, failure: BaseException) -> None:
        from ..messages.base import FailureReply
        self.reply(to, reply_context, FailureReply(failure))


class ProgressLog(abc.ABC):
    """Per-store liveness driver (ProgressLog.java:59-213). All callbacks are invoked
    from inside the owning CommandStore."""

    def unwitnessed(self, txn_id, home_key, progress_shard) -> None: ...
    def pre_accepted(self, command, progress_shard) -> None: ...
    def accepted(self, command, progress_shard) -> None: ...
    def precommitted(self, command) -> None: ...
    def stable(self, command, progress_shard) -> None: ...
    def ready_to_execute(self, command) -> None: ...
    def executed(self, command, progress_shard) -> None: ...
    def durable(self, command) -> None: ...
    def invalidated(self, command, progress_shard) -> None: ...
    def durable_global(self, txn_id, durability) -> None: ...
    def waiting(self, blocked_by, blocked_until, blocked_on_route, blocked_on_participants) -> None: ...
    def clear(self, txn_id) -> None: ...

    NOOP: "ProgressLog"


class _NoopProgressLog(ProgressLog):
    pass


ProgressLog.NOOP = _NoopProgressLog()


class Scheduler(abc.ABC):
    """Time-based callbacks (Scheduler.java). Times in seconds."""

    class Scheduled:
        def cancel(self) -> None: ...

    @abc.abstractmethod
    def once(self, delay_s: float, run: Callable[[], None]) -> "Scheduler.Scheduled": ...

    @abc.abstractmethod
    def recurring(self, interval_s: float, run: Callable[[], None]) -> "Scheduler.Scheduled": ...

    def now(self, run: Callable[[], None]) -> None:
        self.once(0.0, run)


class TopologySorter(abc.ABC):
    """Replica contact preference order (TopologySorter.java)."""

    @abc.abstractmethod
    def compare(self, a: int, b: int, shards) -> int: ...

    @staticmethod
    def identity():
        return _IdentitySorter()


class _IdentitySorter(TopologySorter):
    def compare(self, a: int, b: int, shards) -> int:
        return -1 if a < b else (1 if a > b else 0)


class BarrierType(enum.Enum):
    """BarrierType.java: local waits for any covering applied txn; global coordinates
    a SyncPoint (async returns before application, sync after)."""
    LOCAL = "local"
    GLOBAL_ASYNC = "global_async"
    GLOBAL_SYNC = "global_sync"

    @property
    def is_global(self) -> bool:
        return self is not BarrierType.LOCAL

    @property
    def wait_on_global_application(self) -> bool:
        return self is BarrierType.GLOBAL_SYNC


class ConfigurationService(abc.ABC):
    """Epoch/topology feed (ConfigurationService.java:60-183)."""

    class Listener(abc.ABC):
        def on_topology_update(self, topology, start_sync: bool) -> "AsyncResult":
            ...

        def on_remote_sync_complete(self, node_id: int, epoch: int) -> None: ...
        def truncate_topology_until(self, epoch: int) -> None: ...
        def on_epoch_closed(self, ranges: "Ranges", epoch: int) -> None: ...
        def on_epoch_redundant(self, ranges: "Ranges", epoch: int) -> None: ...

    @abc.abstractmethod
    def register_listener(self, listener: "ConfigurationService.Listener") -> None: ...

    @abc.abstractmethod
    def current_topology(self): ...

    def current_epoch(self) -> int:
        return self.current_topology().epoch

    @abc.abstractmethod
    def get_topology_for_epoch(self, epoch: int): ...

    @abc.abstractmethod
    def fetch_topology_for_epoch(self, epoch: int) -> None: ...

    def acknowledge_epoch(self, ready, start_sync: bool) -> None:
        pass

    def report_epoch_closed(self, ranges: "Ranges", epoch: int) -> None:
        pass

    def report_epoch_redundant(self, ranges: "Ranges", epoch: int) -> None:
        pass


class LocalConfig:
    """Epoch-fetch timeouts / watchdog intervals (config/LocalConfig.java)."""

    epoch_fetch_initial_timeout_s: float = 0.05
    epoch_fetch_increased_timeout_s: float = 1.0

    DEFAULT: "LocalConfig"


LocalConfig.DEFAULT = LocalConfig()
