"""Workload shapes for the burn harness (ROADMAP item 4a-c).

The default burn workload is a closed-loop uniform/zipf single-range
read/write mix.  This module grows the axis the fault matrix was missing —
the traffic SHAPES production clusters actually generate — as pluggable
presets behind ``run_burn(workload=...)`` / ``burn --workload``:

- ``multirange``  multi-range transactions (keys spread across shards, 2-4
  range reads) plus INTERACTIVE operations driven through the coordinate
  surface: barriers (LOCAL / GLOBAL_ASYNC / GLOBAL_SYNC over keys and
  ranges) and inclusive sync points — under whatever fault matrix the burn
  runs (the elastic+hostile regime is the target).
- ``zipf``        Zipf-skewed key selection (theta=0.99: a hot head) with a
  MID-BURN HOT-RANGE MIGRATION: at the half-way op the hot ranks rotate to
  the far side of the keyspace, moving the contention point across shard
  boundaries while in-flight txns still target the old one.
- ``openloop``    open-loop Poisson arrivals at a target rate (txn/s of
  SIM-time): the client submits at the drawn instants no matter what is in
  flight — the regime where queueing collapses show up as latency-SLO burn
  (the PR-10 burn-rate monitors are the pass/fail oracle; zero ``slo.burn``
  events = the rate was sustained).

Determinism contract: every preset draws ONLY from the RandomSource the
harness hands it at bind time (a fork of the burn's seeded stream), so a
seed fully determines the workload; ``workload=None`` leaves the original
inline generation untouched (byte-identical trajectories for every existing
seed).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from ..api.interfaces import BarrierType
from ..impl.list_store import list_txn, range_read_txn
from ..primitives.keys import IntKey, Keys, Range, Ranges


class WorkloadOp:
    """One generated client operation.

    ``control`` is None for a data txn (``txn`` set), else a tuple:
    ``("barrier", barrier_type, seekables)`` or ``("sync_point", seekables)``
    — executed through the node's coordinate surface, with no data payload.
    """

    __slots__ = ("txn", "read_keys", "writes", "control")

    def __init__(self, txn=None, read_keys: Tuple = (),
                 writes: Optional[Dict] = None, control=None):
        self.txn = txn
        self.read_keys = tuple(read_keys)
        self.writes = dict(writes or {})
        self.control = control


class Workload:
    """Base preset: bind once per burn, then generate ops by id."""

    name = "workload"
    open_loop = False

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.rng = None
        self.key_count = 0
        self.bound = 1000
        self.ops = 0

    def bind(self, rng, key_count: int, bound: int, ops: int) -> None:
        self.rng = rng
        self.key_count = key_count
        self.bound = bound
        self.ops = ops

    def _count(self, kind: str) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def _key(self, idx: int) -> IntKey:
        return IntKey((idx * self.bound) // self.key_count)

    def _list_op(self, op_id: int, keys) -> WorkloadOp:
        keys = sorted(set(keys))
        kind = self.rng.pick(["read", "write", "rw", "rw"])
        reads = keys if kind in ("read", "rw") else []
        writes = {key: f"v{op_id}.{ki}" for ki, key in enumerate(keys)} \
            if kind in ("write", "rw") else {}
        return WorkloadOp(txn=list_txn(reads, writes),
                          read_keys=tuple(reads), writes=writes)

    def next_op(self, op_id: int) -> WorkloadOp:
        raise NotImplementedError


class MultiRangeWorkload(Workload):
    """Cross-shard txns + interactive barrier/sync-point traffic."""

    name = "multirange"

    def next_op(self, op_id: int) -> WorkloadOp:
        rng = self.rng
        u = rng.next_float()
        if u < 0.10:
            # interactive barrier: local or global, over a key or ranges
            btype = rng.pick([BarrierType.LOCAL, BarrierType.GLOBAL_ASYNC,
                              BarrierType.GLOBAL_SYNC])
            if rng.next_boolean():
                seekables = Keys.of([self._key(rng.next_int(self.key_count))])
            else:
                seekables = Ranges.of(*self._ranges(1 + rng.next_int(2)))
            self._count("barrier")
            return WorkloadOp(control=("barrier", btype, seekables))
        if u < 0.18:
            # inclusive sync point over ranges (non-blocking coordination)
            seekables = Ranges.of(*self._ranges(1 + rng.next_int(2)))
            self._count("sync_point")
            return WorkloadOp(control=("sync_point", seekables))
        if u < 0.40:
            # multi-range read: 2-4 ranges
            self._count("range_read")
            rngs = self._ranges(2 + rng.next_int(3))
            return WorkloadOp(txn=range_read_txn(Ranges.of(*rngs)))
        # cross-shard key txn: 2-5 keys strided across the keyspace so they
        # land in DIFFERENT shards whenever the topology has several
        self._count("multirange_txn")
        n = 2 + rng.next_int(4)
        base = rng.next_int(self.key_count)
        stride = max(1, self.key_count // n)
        keys = [self._key((base + j * stride) % self.key_count)
                for j in range(n)]
        return self._list_op(op_id, keys)

    def _ranges(self, n: int):
        out = []
        for _ in range(n):
            start = self.rng.next_int(self.bound - 1)
            width = 1 + self.rng.next_int(self.bound // 2)
            out.append(Range(IntKey(start),
                             IntKey(min(self.bound, start + width))))
        return out


class ZipfWorkload(Workload):
    """Zipf-skewed keys with a mid-burn hot-range migration."""

    name = "zipf"

    def __init__(self, theta: float = 0.99, migrate_at: float = 0.5):
        super().__init__()
        self.theta = theta
        self.migrate_at = migrate_at
        self.key_log = []   # (op_id, key_index) — migration forensics

    def _zipf_key_index(self, op_id: int) -> int:
        # rank 0 is the hottest key; before the migration point ranks map to
        # the LOW end of the keyspace (clustered in the first shard), after
        # it they rotate half the keyspace away — the hot range MOVES
        rank = self.rng.next_zipf(self.key_count, self.theta)
        if op_id >= int(self.ops * self.migrate_at):
            rank = (rank + self.key_count // 2) % self.key_count
            self._count("post_migration")
        idx = rank
        self.key_log.append((op_id, idx))
        return idx

    def next_op(self, op_id: int) -> WorkloadOp:
        rng = self.rng
        if rng.next_float() < 0.10:
            # skewed range read around the hot point
            self._count("range_read")
            center = (self._zipf_key_index(op_id) * self.bound) \
                // self.key_count
            width = 1 + rng.next_zipf(self.bound // 4)
            lo = max(0, center - width // 2)
            r = Range(IntKey(lo), IntKey(min(self.bound, lo + width)))
            return WorkloadOp(txn=range_read_txn(Ranges.of(r)))
        self._count("txn")
        n = 1 + rng.next_int(3)
        keys = [self._key(self._zipf_key_index(op_id)) for _ in range(n)]
        return self._list_op(op_id, keys)


class OpenLoopWorkload(Workload):
    """Poisson arrivals at ``rate_txn_s`` of sim-time, uniform key mix.

    Overload hooks (PR-17): ``rate_mult`` is the nemesis-driven offered-load
    multiplier (a ramp/burst phase setting 4.0 quadruples the arrival rate),
    and ``pace`` is the client-side AIMD backpressure state — ``on_shed()``
    multiplicatively stretches inter-arrival gaps when the cluster sheds,
    ``on_ok()`` additively-ish recovers toward pace 1.0 on success.  Both
    default to exactly 1.0, and ``x * 1.0`` is bitwise ``x`` in IEEE floats,
    so the un-overloaded arrival stream is byte-identical to pre-PR-17."""

    name = "openloop"
    open_loop = True

    def __init__(self, rate_txn_s: float = 25.0, aimd: bool = True,
                 aimd_backoff: float = 2.0, aimd_recover: float = 0.9,
                 pace_max: float = 8.0):
        super().__init__()
        assert rate_txn_s > 0, "openloop needs a positive --rate"
        self.rate_txn_s = float(rate_txn_s)
        self.rate_mult = 1.0         # nemesis-set offered-load multiplier
        self.pace = 1.0              # AIMD gap stretch (1.0 = full rate)
        self.aimd = aimd
        self.aimd_backoff = float(aimd_backoff)
        self.aimd_recover = float(aimd_recover)
        self.pace_max = float(pace_max)
        self.paced_arrivals = 0      # arrivals drawn while pace > 1.0
        self.pace_downs = 0          # on_shed() events that stretched pace

    def on_shed(self) -> None:
        """A shed/Overloaded nack: multiplicatively back the offered rate
        off (stretch the inter-arrival gap), capped at ``pace_max``."""
        if self.aimd:
            self.pace = min(self.pace_max, self.pace * self.aimd_backoff)
            self.pace_downs += 1

    def on_ok(self) -> None:
        """A success: recover pace geometrically toward 1.0."""
        if self.aimd and self.pace > 1.0:
            self.pace = max(1.0, self.pace * self.aimd_recover)

    def next_arrival_s(self) -> float:
        # inverse-CDF exponential inter-arrival; 1-u keeps the argument in
        # (0, 1] (next_float may return exactly 0.0)
        u = 1.0 - self.rng.next_float()
        if self.pace > 1.0:
            self.paced_arrivals += 1
        return -math.log(u) * self.pace / (self.rate_txn_s * self.rate_mult)

    def next_op(self, op_id: int) -> WorkloadOp:
        rng = self.rng
        if rng.next_float() < 0.10:
            self._count("range_read")
            start = rng.next_int(self.bound - 1)
            width = 1 + rng.next_int(self.bound // 2)
            r = Range(IntKey(start), IntKey(min(self.bound, start + width)))
            return WorkloadOp(txn=range_read_txn(Ranges.of(r)))
        self._count("txn")
        n = 1 + rng.next_int(3)
        keys = [self._key(rng.next_int(self.key_count)) for _ in range(n)]
        return self._list_op(op_id, keys)


PRESETS = {
    "multirange": MultiRangeWorkload,
    "zipf": ZipfWorkload,
    "openloop": OpenLoopWorkload,
}


def make_workload(spec, rate_txn_s: float = 25.0) -> Workload:
    """Resolve a preset name or pass a ``Workload`` instance through."""
    if isinstance(spec, Workload):
        return spec
    cls = PRESETS.get(spec)
    if cls is None:
        raise ValueError(f"unknown workload {spec!r}; presets: "
                         f"{sorted(PRESETS)} (or pass a Workload instance)")
    if cls is OpenLoopWorkload:
        return OpenLoopWorkload(rate_txn_s=rate_txn_s)
    return cls()
