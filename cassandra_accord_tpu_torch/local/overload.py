"""Overload robustness primitives: admission control and retry budgets.

Metastable failures (KNOWN_ISSUES rounds 4 and 7) are load problems, not
protocol bugs: offered work above capacity — client arrivals, recovery
retries, bootstrap re-fencing — feeds on itself until goodput collapses and
STAYS collapsed after the trigger passes.  The defense here has two local
mechanisms, both deterministic and RNG-stream-free:

- ``AdmissionController``: watermark hysteresis over a composite per-node
  load signal (outstanding RPC callbacks at the node's sink + the
  command stores' ``unapplied_pressure``, the PR-7 signal).  Over the high
  watermark the node sheds NEW work with a fast explicit ``Overloaded``
  nack — the caller learns in one round-trip what a timeout would have
  taken seconds to say — and readmits only once load drains below the low
  watermark, so the verdict doesn't flap per message.

- ``TokenBucket``: a sim-time token bucket whose refill rate carries
  deterministic hash-derived jitter (golden-ratio mixing, the same
  construction as ``backoff_timeout_us``) so co-resident buckets never
  phase-lock into a retry herd.  It consumes NO RNG stream: with the
  budgets off, trajectories are byte-identical to the pre-budget tree, and
  with them on, two same-seed runs are byte-identical to each other.

Both are constructed only when their ``LocalConfig`` knob is on; the
default-off path allocates nothing and touches nothing.
"""
from __future__ import annotations

_GOLD = 0x9E3779B97F4A7C15
_MIX = 0xD1B54A32D192ED03
_MASK = 0xFFFFFFFFFFFFFFFF


def hash_jitter(salt: int, n: int, frac: float) -> float:
    """Deterministic jitter in ``[-frac, +frac)`` for draw ``n`` of stream
    ``salt`` — golden-ratio hash mixing, no RNG stream consumed (the
    ``backoff_timeout_us`` construction, recentered around zero)."""
    h = (salt * _GOLD + (n + 1) * _MIX) & _MASK
    return frac * (2.0 * ((h >> 40) / float(1 << 24)) - 1.0)


class TokenBucket:
    """Deterministic sim-time token bucket with hash-jittered refill.

    ``try_acquire(now_s)`` lazily refills from the elapsed sim-time, takes a
    token if one is available, and counts the denial otherwise — callers
    defer denied work to their next natural cadence (poll tick, retry rung)
    rather than rescheduling, which is what de-herds the retry surfaces."""

    __slots__ = ("rate", "burst", "jitter", "salt", "tokens", "last_s",
                 "refills", "denied", "granted")

    def __init__(self, rate_per_s: float, burst: float,
                 jitter_frac: float = 0.0, salt: int = 0,
                 now_s: float = 0.0):
        assert rate_per_s > 0.0 and burst > 0.0
        self.rate = rate_per_s
        self.burst = burst
        self.jitter = jitter_frac
        self.salt = salt
        self.tokens = burst          # start full: the first burst is free
        self.last_s = now_s
        self.refills = 0
        self.denied = 0
        self.granted = 0

    def _refill(self, now_s: float) -> None:
        dt = now_s - self.last_s
        if dt <= 0.0:
            return
        self.last_s = now_s
        self.refills += 1
        rate = self.rate * (1.0 + hash_jitter(self.salt, self.refills,
                                              self.jitter))
        self.tokens = min(self.burst, self.tokens + dt * rate)

    def try_acquire(self, now_s: float, n: float = 1.0) -> bool:
        self._refill(now_s)
        if self.tokens >= n:
            self.tokens -= n
            self.granted += 1
            return True
        self.denied += 1
        return False


class AdmissionController:
    """Watermark-hysteresis admission control for one node.

    Load = outstanding reply callbacks at the node's message sink (every
    un-replied RPC this node has in flight) + the sum of per-store
    ``unapplied_pressure`` (decided-but-unapplied txns older than the age
    horizon — the execution plane visibly behind).  The composite is
    recomputed at most once per sim 100 ms (the pressure scan is O(commands);
    per-message recomputation would make admission itself the overload),
    which stays deterministic because sim-time is.

    Hysteresis: shedding starts at/above ``admission_hi`` and stops only
    at/below ``admission_lo``, so a node hovering at the watermark doesn't
    flap per message.  Only work-INITIATING requests are ever shed
    (replica-side PreAccepts; harness clients consult ``overloaded()``
    before dispatching) — never mid-protocol Commit/Apply/recovery traffic,
    which must drain for load to ever fall."""

    __slots__ = ("node", "hi", "lo", "pressure_age_s", "shedding", "nacks",
                 "sheds", "_cache_bucket", "_cache_load")

    # sim-time granularity of the load recomputation, in micros
    _RECOMPUTE_US = 100_000

    def __init__(self, node):
        cfg = node.config
        self.node = node
        self.hi = cfg.admission_hi
        self.lo = min(cfg.admission_lo, cfg.admission_hi)
        self.pressure_age_s = cfg.admission_pressure_age_s
        self.shedding = False
        self.nacks = 0               # replica-side Overloaded nacks sent
        self.sheds = 0               # client-entry sheds recorded against us
        self._cache_bucket = -1
        self._cache_load = 0

    def load(self) -> int:
        """The composite load signal, recomputed at most once per 100 sim-ms."""
        bucket = self.node.now_micros() // self._RECOMPUTE_US
        if bucket == self._cache_bucket:
            return self._cache_load
        sink = self.node.message_sink
        n = len(getattr(sink, "callbacks", ()))
        for cs in self.node.command_stores.all_stores():
            n += cs.unapplied_pressure(self.pressure_age_s)
        self._cache_bucket = bucket
        self._cache_load = n
        return n

    def overloaded(self) -> bool:
        """Update the hysteresis state from the current load and return it."""
        load = self.load()
        if self.shedding:
            if load <= self.lo:
                self.shedding = False
        elif load >= self.hi:
            self.shedding = True
        return self.shedding
