"""The one traffic generator: every event of a cell, drawn from ``--seed``.

A configuration file fixes the store (slots, keys, how a transaction names
its keys, the share of writes, the coordinators); its key distribution is
the module ``keys/<dist>.py`` (a ``Keys`` whose ``draw`` gives a
``KeySets``); a traffic file fixes the mix (batch or window sizes, the
execution backlog, GC cadence, status moves, warm-up).  This module
reads both and emits the same events to the program and to the reference.
Events are absolute (slot, keys, TxnId lanes, new status, new executeAt), so
neither side has to derive one from the other's state.

TxnIds.  A transaction's arrival number ``g`` gives its TxnId lanes
(epoch, hlc_hi, hlc_lo, flags, node) with ``hlc_lo = HLC_BASE + 64 * (g -
lag) + g % 64``: unique for lags below 64, and, with ``lag = 0``, strictly
rising with ``g``.  ``flags`` carries the kind as a TxnId does (kind << 2),
its routing-domain bit that of a key (0).  ``hlc_lo`` stays far below 2**31 - 1,
where the next timestamp's carry would be taken.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

HLC_BASE = 1 << 22
LAG_MAX = 64                  # lags are drawn in [0, LAG_MAX)
SLOW_SPREAD = 64 * 64         # a slow executeAt lies 1..SLOW_SPREAD past its hlc
PREACCEPTED, ACCEPTED, STABLE, APPLIED, INVALIDATED = 1, 2, 4, 5, 6
STATUSES = (1, 2, 3, 4, 5)    # PREACCEPTED .. APPLIED
# does a query of kind a witness a transaction of kind b, for the two kinds
# the traffic sends (READ 0, WRITE 1): reads witness writes, writes both
# (Accord's Txn.Kind.witnesses)
WITNESSES = np.array([[False, True], [True, True]])


def rng(seed: int, *stream: int) -> np.random.Generator:
    """An independent stream of draws for (seed, *stream)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


class KeySets:
    """The key slots of ``n`` transactions: ``cols`` [n, m] int32, distinct
    within a row, over a store of ``k`` key slots."""

    def __init__(self, k: int, cols: np.ndarray):
        self.k, self.cols = k, np.asarray(cols, dtype=np.int32)

    def __len__(self) -> int:
        return len(self.cols)

    def incidence(self) -> np.ndarray:
        """[n, K] int8 0/1."""
        inc = np.zeros((len(self), self.k), dtype=np.int8)
        inc[np.arange(len(self))[:, None], self.cols] = 1
        return inc

    def key_lists(self) -> list:
        """Each transaction's key slots as a tuple of ints, as a store hands
        them to a consult."""
        return [tuple(r) for r in self.cols.tolist()]

    def distinct(self) -> int:
        """How many key slots these transactions name between them."""
        return int(np.unique(self.cols).size)

    def overlap(self, other: "KeySets") -> np.ndarray:
        """[len(self), len(other)] bool: which pairs share a key slot."""
        by_key = np.zeros((self.k, len(other)), dtype=bool)
        by_key[other.cols, np.arange(len(other))[:, None]] = True
        return by_key[self.cols].any(axis=1)


class Clock:
    """TxnId and executeAt lanes of one run."""

    def __init__(self, cfg: dict, seed: int):
        self.epoch = 1 + int(seed) % 5
        self.hlc_hi = (int(seed) // 5) % 4
        self.nodes = int(cfg["nodes"])

    def hlc(self, g, lag=0) -> np.ndarray:
        g = np.asarray(g, dtype=np.int64)
        return HLC_BASE + 64 * (g - lag) + g % 64

    def txn_ids(self, g, kind, node, lag=0) -> np.ndarray:
        g = np.asarray(g, dtype=np.int64)
        out = np.empty((g.size, 5), dtype=np.int32)
        out[:, 0] = self.epoch
        out[:, 1] = self.hlc_hi
        out[:, 2] = self.hlc(g, lag)
        out[:, 3] = np.asarray(kind, dtype=np.int32) << 2
        out[:, 4] = node
        return out

    def later(self, hlc, delta, node) -> np.ndarray:
        """executeAt lanes ``delta`` past ``hlc``: flags clear, as a
        proposed timestamp has them."""
        hlc = np.asarray(hlc, dtype=np.int64)
        out = np.zeros((hlc.size, 5), dtype=np.int32)
        out[:, 0] = self.epoch
        out[:, 1] = self.hlc_hi
        out[:, 2] = hlc + delta
        out[:, 4] = node
        return out

    def watermark(self, g) -> np.ndarray:
        """Lanes below every TxnId of arrival ``g`` and above every earlier
        one (lag 0)."""
        return np.array([self.epoch, self.hlc_hi, HLC_BASE + 64 * int(g), 0, 0],
                        dtype=np.int32)


def _new_txns(keys, clock: Clock, cfg: dict, r, g0: int, n: int,
              lagged: bool) -> Dict[str, object]:
    kind = (r.random(n) < float(cfg["write_share"])).astype(np.int8)
    node = r.integers(1, clock.nodes + 1, n).astype(np.int32)
    lag = r.integers(0, LAG_MAX, n) if lagged else 0
    g = np.arange(g0, g0 + n, dtype=np.int64)
    return {"g": g, "keys": keys.draw(r, n), "kind": kind, "node": node,
            "txn_id": clock.txn_ids(g, kind, node, lag)}


# ---------------------------------------------------------------------------
# step: batches through the conflict-graph step, GC every few batches
# ---------------------------------------------------------------------------

class StepTraffic:
    """Batches of ``batch`` new transactions into a full store of ``T``
    slots.  The store starts as right after a GC: ``T - gc_free``
    transactions in slots ``gc_free..T-1`` (transaction ``g`` takes slot
    ``g % T``).  The newest ``backlog`` batches of them are stable and not
    yet executed: execution runs ``backlog`` waves behind stabilisation, as
    a store's does while its dependencies' Apply is in flight.  So every key
    that each batch names carries a chain of ``backlog`` waiting batches,
    each step's wave applies the frontier of the whole store, and a new
    transaction applies at most ``backlog`` waves after its own.  The rest
    are applied.  After every ``gc_every``-th batch the GC watermark leaves
    the newest ``T - gc_free`` transactions live, long applied below it, so
    each batch finds ``batch`` free slots and the live set moves between
    ``T - gc_free`` and ``T``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, keys):
        self.cfg, self.seed, self.keys = cfg, seed, keys
        self.t = int(cfg["txn_slots"])
        self.batch = int(traffic["batch"])
        self.gc_every = int(traffic["gc_every"])
        self.gc_free = int(traffic["gc_free"])
        self.backlog = int(traffic["backlog"])
        if self.gc_free != self.batch * self.gc_every or self.gc_free >= self.t:
            raise ValueError("gc_free must equal batch * gc_every and be "
                             "below the store's slots")
        if self.backlog * self.batch > self.t - self.gc_free:
            raise ValueError("the backlog must fit in the store")
        self.clock = Clock(cfg, seed)

    def initial(self) -> Dict[str, object]:
        """The transactions the store holds before the first batch: slots,
        keys, TxnIds, kinds, executeAt (a share on the slow path, later than
        their TxnId) and status; ``deps`` [P, T] bool, the dependency rows of
        the last P = backlog * batch (the stable ones): the transactions
        before their batch that share a key and that their kind witnesses."""
        r = rng(self.seed, 2)
        g0, n = self.gc_free, self.t - self.gc_free
        ev = _new_txns(self.keys, self.clock, self.cfg, r, g0, n, False)
        slow = r.random(n) < float(self.cfg["slow_share"])
        ts = ev["txn_id"].copy()
        ts[slow] = self.clock.later(
            self.clock.hlc(ev["g"][slow]), r.integers(1, SLOW_SPREAD, int(slow.sum())),
            ev["node"][slow])
        slot = (ev["g"] % self.t).astype(np.int32)
        p = self.backlog * self.batch
        status = np.full(n, APPLIED, dtype=np.int8)
        status[n - p:] = STABLE
        keys, kind = ev["keys"], ev["kind"]
        deps = np.zeros((p, self.t), dtype=bool)
        for a in range(n - p, n, self.batch):
            rows = slice(a - (n - p), a - (n - p) + self.batch)
            before = KeySets(keys.k, keys.cols[:a])
            deps[rows, slot[:a]] = (
                KeySets(keys.k, keys.cols[a:a + self.batch]).overlap(before)
                & WITNESSES[kind[a:a + self.batch, None], kind[None, :a]])
        ev.update(slot=slot, ts=ts, status=status, deps=deps)
        return ev

    def step(self, s: int) -> Dict[str, object]:
        """Batch ``s``: its transactions (slots, keys, kinds, TxnIds) and,
        when a GC follows it, the watermark."""
        g0 = self.t + s * self.batch
        ev = _new_txns(self.keys, self.clock, self.cfg, rng(self.seed, 3, s),
                       g0, self.batch, False)
        ev["slot"] = (ev["g"] % self.t).astype(np.int32)
        ev["gc"] = None
        if (s + 1) % self.gc_every == 0:
            ev["gc"] = self.clock.watermark(g0 + self.batch - (self.t - self.gc_free))
        return ev


# ---------------------------------------------------------------------------
# windows: delivery windows of consults, then the store's mutations
# ---------------------------------------------------------------------------

class WindowTraffic:
    """Windows of consults over a full store of ``T`` live transactions
    (transaction ``g`` in slot ``g % T``).  A window holds a Poisson number
    of consults, clipped; its transactions then join the store in the slots
    of as many of the oldest, which retire, and as many live transactions
    move one status up.  The first windows take the sizes ``warm_sizes``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, keys):
        self.cfg, self.seed, self.keys = cfg, seed, keys
        self.t = int(cfg["txn_slots"])
        c = traffic["consults"]
        self.mean, self.lo, self.hi = float(c["mean"]), int(c["min"]), int(c["max"])
        self.warm_sizes = [int(x) for x in traffic.get("warm_sizes", [])]
        self.moves = float(traffic["moves_per_consult"])
        self.invalidate = float(traffic["invalidate_share"])
        self.slow = float(cfg["slow_share"])
        self.clock = Clock(cfg, seed)
        self.status: Optional[np.ndarray] = None     # the generator's view
        self.g_next = self.t
        self.w_next = 0

    def initial(self) -> Dict[str, object]:
        r = rng(self.seed, 4)
        ev = _new_txns(self.keys, self.clock, self.cfg, r, 0, self.t, True)
        status = r.choice(np.array(STATUSES, dtype=np.int8), self.t)
        status[r.random(self.t) < self.invalidate] = INVALIDATED
        slow = (status >= ACCEPTED) & (r.random(self.t) < self.slow)
        ts = ev["txn_id"].copy()
        ts[slow] = self.clock.later(
            self.clock.hlc(ev["g"][slow]), r.integers(1, SLOW_SPREAD, int(slow.sum())),
            ev["node"][slow])
        self.status = status.copy()
        ev.update(slot=(ev["g"] % self.t).astype(np.int32), ts=ts, status=status)
        return ev

    def size(self, r, w: int) -> int:
        if w < len(self.warm_sizes):
            return self.warm_sizes[w]
        return int(min(self.hi, max(self.lo, r.poisson(self.mean))))

    def window(self) -> Dict[str, object]:
        """The next window: its consults (the joining transactions) and the
        status moves that follow its answers.  Windows come in order."""
        if self.status is None:
            raise RuntimeError("initial() first")
        w = self.w_next
        r = rng(self.seed, 5, w)
        n = self.size(r, w)
        ev = _new_txns(self.keys, self.clock, self.cfg, r, self.g_next, n, True)
        ev["slot"] = (ev["g"] % self.t).astype(np.int32)
        self.status[ev["slot"]] = PREACCEPTED
        m = int(round(self.moves * n))
        slots = r.choice(self.t, m, replace=False).astype(np.int32)
        old = self.status[slots]
        new = np.minimum(old + 1, APPLIED).astype(np.int8)
        new[old == INVALIDATED] = INVALIDATED
        new[(old == PREACCEPTED) & (r.random(m) < self.invalidate)] = INVALIDATED
        set_ts = (new == ACCEPTED) & (r.random(m) < self.slow)
        now = self.clock.hlc(ev["g"][-1])
        ts = self.clock.later(np.full(m, now), r.integers(1, SLOW_SPREAD, m),
                              r.integers(1, self.clock.nodes + 1, m))
        self.status[slots] = new
        ev.update(w=w, move_slot=slots, move_status=new, move_set_ts=set_ts,
                  move_ts=ts)
        self.g_next += n
        self.w_next += 1
        return ev

