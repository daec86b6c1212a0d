"""protocol_batch — the columnar protocol engine (ROADMAP item 1).

Struct-of-arrays **TxnBatch** mirrors of command-store hot state (status
codes, executeAt/ballot lanes, key-set offsets, deps row pointers as
parallel numpy arrays) plus a per-store **BatchEngine** that computes the
protocol's per-txn scans — waiting-graph release fan-out, frontier-init
dependency classification, progress-log settlement scans — as vectorized
passes over all in-flight txns instead of per-txn Python attribute chases.

DESIGN CONTRACT (the on-vs-off byte-identity proof, tests/
test_protocol_batch.py): the engine NEVER changes a protocol decision,
a message, an RNG draw, or a scheduling point.  Every vectorized pass is
either (a) a pure read answering bit-identically to the scalar code it
replaces, or (b) an *exact-skip prefilter*: it may only skip scalar work
it can PROVE is a no-op (no mutation, no observation, no fault-in), and
falls back to the scalar path whenever the mirror cannot prove it.  A
same-seed hostile burn with ``columnar=on`` vs ``off`` is therefore
byte-identical by construction — the knob buys wall-clock, never
trajectory.

Knob: ``LocalConfig.columnar`` / ``ACCORD_COLUMNAR`` in {auto, on, off}
(auto resolves to on — numpy is always present; off keeps every legacy
code path untouched).  The burn CLI exposes ``--columnar``; bench.py's
``protocol_ramp`` stage measures the commits/s-vs-concurrency curve both
ways.
"""
from .columns import ENGAGE_FLOOR, TS_ORDER_LANES, TxnBatch, pack_order_lanes
from .engine import BatchEngine, columnar_enabled, make_engine

__all__ = ["TxnBatch", "BatchEngine", "make_engine", "columnar_enabled",
           "pack_order_lanes", "TS_ORDER_LANES", "ENGAGE_FLOOR"]
