"""The SPI boundary: interfaces the embedding system implements.

Capability parity with ``accord.api`` (SURVEY.md §2.2): storage, networking,
scheduling, progress, configuration and txn-execution hooks are all injected —
the protocol core never talks to a real network, disk, clock or thread pool directly.
This is the property that makes the deterministic simulation harness possible.
"""
from .interfaces import (
    Agent,
    BarrierType,
    ConfigurationService,
    Data,
    DataStore,
    EventsListener,
    FetchRanges,
    LocalConfig,
    MessageSink,
    ProgressLog,
    Query,
    Read,
    Result,
    Scheduler,
    TopologySorter,
    Update,
    Write,
)

__all__ = [
    "Agent", "BarrierType", "ConfigurationService", "Data", "DataStore",
    "EventsListener", "FetchRanges", "LocalConfig", "MessageSink", "ProgressLog",
    "Query", "Read", "Result", "Scheduler", "TopologySorter", "Update", "Write",
]
