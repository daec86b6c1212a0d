"""The plain reference: what a replica's conflict index must answer, in plain
PyTorch, from the generator's events alone.

It imports nothing of the program and takes nothing the program made: it
builds its own index from the events, keeps it as plain tensors, and answers
each batch or consult by the rules of Accord's replica-side PreAccept:

- deps: every live transaction that shares a key with the query, is not
  invalidated, started before the query's TxnId (lexicographic lanes), and
  whose kind the query's kind witnesses (Txn.Kind.witnesses,
  Txn.java:221-262: reads witness writes, writes witness reads and writes);
- max conflict: the lexicographic max of max(executeAt, TxnId) over every
  live transaction sharing a key (MaxConflicts.java:32), zero lanes if none;
- a step also stabilises its batch at executeAt = TxnId when no dependency
  executes later (else the next timestamp after the latest, node 0), runs
  one execution wave (a stable transaction applies when every dependency is
  applied, invalidated or gone), and after a GC watermark evicts every
  applied transaction whose TxnId is below it (RedundantBefore).  A step
  store's stable backlog before its first batch is stabilised batch by batch
  here from its events, each batch witnessing the store before it.

Key overlap is a float32 product of 0/1 incidences with TF32 off: exact, as
every sum is a small whole number.  ``stale=True`` is the control: each
answer is taken from the index as it stood one batch or window earlier (the
state itself still moves on as it should), which breaks the configurations'
guarantee (deps exact over the live index).

Inputs are arrays or tensors (moved to the reference's device); a replay
waits on the device only every ``PRUNE_EVERY`` steps, so it runs near the
device's pace.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

STABLE, APPLIED, INVALIDATED = 4, 5, 6
LANES = 5
PRUNE_EVERY = 16


def _witness_table() -> torch.Tensor:
    """[6, 6] bool: does a query of kind a depend on a transaction of kind b
    (READ, WRITE, EPHEMERAL_READ, SYNC_POINT, EXCLUSIVE_SYNC_POINT,
    LOCAL_ONLY)."""
    w = torch.zeros((6, 6), dtype=torch.bool)
    w[0, 1] = w[2, 1] = True                      # reads: writes
    w[1, 0:2] = w[3, 0:2] = True                  # writes, sync points: both
    w[4, 0:2] = w[4, 3:5] = True                  # exclusive sync point
    return w


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b, lexicographic over the last axis (broadcast)."""
    less = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1],
                       dtype=torch.bool, device=a.device)
    equal = torch.ones_like(less)
    for lane in range(LANES):
        less |= equal & (a[..., lane] < b[..., lane])
        equal &= a[..., lane] == b[..., lane]
    return less


def lex_max(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, 5] int32: the lexicographic max of vals [T, 5] (lanes in [0,
    2**31)) over the slots where mask [B, T] holds; zero lanes where it holds
    nowhere."""
    cand = mask.clone()
    out = torch.zeros((mask.shape[0], LANES), dtype=torch.int32,
                      device=mask.device)
    for lane in range(LANES):
        v = vals[:, lane][None, :]
        best = torch.where(cand, v, torch.full_like(v, -1)).amax(dim=1)
        out[:, lane] = best.clamp_min(0)
        cand &= v == best[:, None]
    return out


def next_ts(ts: torch.Tensor) -> torch.Tensor:
    """The smallest timestamp after ts (hlc + 1, carried), flags clear, node 0."""
    ts = ts.long()
    lo = ts[:, 2] + 1
    out = torch.zeros_like(ts)
    out[:, 0] = ts[:, 0]
    out[:, 1] = ts[:, 1] + (lo >> 31)
    out[:, 2] = lo & 0x7FFFFFFF
    return out.to(torch.int32)


def _exact_matmul():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Index:
    """One store's conflict index as plain tensors (lanes int32)."""

    def __init__(self, t: int, k: int, device):
        _exact_matmul()
        self.dev = dev = torch.device(device)
        self.key = torch.zeros((t, k), dtype=torch.float32, device=dev)
        self.txn = torch.zeros((t, LANES), dtype=torch.int32, device=dev)
        self.ts = torch.zeros((t, LANES), dtype=torch.int32, device=dev)
        self.kind = torch.zeros((t,), dtype=torch.long, device=dev)
        self.status = torch.zeros((t,), dtype=torch.long, device=dev)
        self.active = torch.zeros((t,), dtype=torch.bool, device=dev)
        self.wit = _witness_table().to(dev)

    def on(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, device=self.dev).to(dtype)

    def put(self, slot, inc, txn, ts, kind, status) -> None:
        s = self.on(slot, torch.long)
        self.key[s] = self.on(inc, torch.float32)
        self.txn[s] = self.on(txn, torch.int32)
        self.ts[s] = self.on(ts, torch.int32)
        self.kind[s] = self.on(kind, torch.long)
        self.status[s] = self.on(status, torch.long)
        self.active[s] = True

    def snapshot(self) -> "Index":
        c = Index.__new__(Index)
        c.__dict__.update({n: (v.clone() if isinstance(v, torch.Tensor) else v)
                           for n, v in self.__dict__.items()})
        return c

    def overlap(self, inc) -> torch.Tensor:
        return (self.on(inc, torch.float32) @ self.key.T) > 0

    def deps(self, overlap, before, qkind) -> torch.Tensor:
        before, qkind = self.on(before, torch.int32), self.on(qkind, torch.long)
        live = self.active & (self.status != INVALIDATED)
        return (overlap & live[None, :]
                & lex_less(self.txn[None, :, :], before[:, None, :])
                & self.wit[qkind][:, self.kind])

    def max_conflict(self, overlap) -> torch.Tensor:
        later = torch.where(lex_less(self.ts, self.txn)[:, None], self.txn,
                            self.ts)
        return lex_max(later, overlap & self.active[None, :])

    def union(self, overlap) -> torch.Tensor:
        """Live slots that share a key with some query (a device scalar)."""
        return (overlap & self.active[None, :]).any(dim=0).sum()


class StepReference:
    """The conflict-graph step, batch by batch, from the events."""

    def __init__(self, cfg: dict, initial: Dict[str, object], batch: int,
                 device, stale: bool = False):
        """``initial``: the store's transactions (slots, keys, TxnIds,
        executeAt, kinds, statuses); the stable ones are the backlog, taken
        in order in batches of ``batch``, each witnessing the store before
        it: their deps are worked out here, not taken from the events."""
        self.ix = ix = Index(int(cfg["txn_slots"]), int(cfg["key_slots"]), device)
        status = np.asarray(initial["status"])
        inc = initial["keys"].incidence()
        slot, txn, ts, kind = (np.asarray(initial[f])
                               for f in ("slot", "txn_id", "ts", "kind"))
        done = status != STABLE
        ix.put(slot[done], inc[done], txn[done], ts[done], kind[done], status[done])
        # stable slots still waiting: [slots [n], dependency rows [n, T],
        # pending [n]]; blocks whose rows all applied are dropped every
        # PRUNE_EVERY steps, the one wait on the device a replay makes
        self.waiting: List[list] = []
        backlog = np.flatnonzero(~done)
        for a in range(0, backlog.size, batch):
            r = backlog[a:a + batch]
            deps = ix.deps(ix.overlap(inc[r]), txn[r], kind[r])
            ix.put(slot[r], inc[r], txn[r], ts[r], kind[r], status[r])
            self.waiting.append([ix.on(slot[r], torch.long), deps,
                                 torch.ones(r.shape, dtype=torch.bool, device=ix.dev)])
        self.stale = stale
        self.prev = self.ix.snapshot() if stale else None
        self.steps = 0

    def _answer(self, ix: Index, inc, bid, kind):
        overlap = ix.overlap(inc)
        deps = ix.deps(overlap, bid, kind)
        latest = lex_max(ix.ts, deps)
        fast = ~deps.any(dim=1) | lex_less(latest, bid)
        return deps, torch.where(fast[:, None], bid, next_ts(latest)), \
            ix.union(overlap)

    def step(self, slot, inc, txn_id, kind, gc=None):
        """(deps [B, T] bool, executeAt [B, 5], applied [T] bool, the live
        slots sharing a key with the batch, the stable slots the wave
        tests) for one batch: its slots, key incidence [B, K], TxnIds,
        kinds, and the GC watermark that follows it, if any."""
        ix = self.ix
        bid = ix.on(txn_id, torch.int32)
        deps, exec_at, union = self._answer(ix, inc, bid, kind)
        out = self._answer(self.prev, inc, bid, kind) if self.stale \
            else (deps, exec_at, union)
        if self.stale:
            self.prev = ix.snapshot()
        slots = ix.on(slot, torch.long)
        ix.put(slots, inc, bid, exec_at, kind,
               torch.full(slots.shape, STABLE, device=ix.dev))
        self.waiting.append([slots, deps.clone(),
                             torch.ones(slots.shape, dtype=torch.bool, device=ix.dev)])
        tested = (ix.active & (ix.status == STABLE)).sum()
        applied = self._wave()
        if gc is not None:
            self._gc(gc)
        self.steps += 1
        if self.steps % PRUNE_EVERY == 0:
            alive = torch.stack([w[2].any() for w in self.waiting]).tolist()
            self.waiting = [w for w, a in zip(self.waiting, alive) if a]
        return out[0], out[1], applied, out[2], tested

    def _wave(self) -> torch.Tensor:
        ix = self.ix
        done = (ix.status == APPLIED) | (ix.status == INVALIDATED) | ~ix.active
        stable = ix.active & (ix.status == STABLE)
        ready = torch.zeros(ix.active.shape, dtype=torch.int32, device=ix.dev)
        for block in self.waiting:
            slots, rows, pending = block
            free = pending & stable[slots] & ~(rows & ~done[None, :]).any(dim=1)
            ready.index_add_(0, slots, free.to(torch.int32))
            block[2] = pending & ~free
        ready = ready > 0
        ix.status.masked_fill_(ready, APPLIED)
        return ready

    def _gc(self, watermark) -> None:
        ix = self.ix
        w = ix.on(watermark, torch.int32)
        gone = (ix.active & ((ix.status == APPLIED) | (ix.status == INVALIDATED))
                & lex_less(ix.txn, w[None, :]))
        ix.key.masked_fill_(gone[:, None], 0)
        for name in ("txn", "ts"):
            getattr(ix, name).masked_fill_(gone[:, None], 0)
        for name in ("kind", "status"):
            getattr(ix, name).masked_fill_(gone, 0)
        ix.active &= ~gone
        for _slots, rows, _pending in self.waiting:
            rows.masked_fill_(gone[None, :], False)


class WindowReference:
    """Consult windows over a store, from the events."""

    def __init__(self, cfg: dict, initial: Dict[str, object], device,
                 stale: bool = False):
        self.ix = Index(int(cfg["txn_slots"]), int(cfg["key_slots"]), device)
        self.ix.put(initial["slot"], initial["keys"].incidence(),
                    initial["txn_id"], initial["ts"], initial["kind"],
                    initial["status"])
        self.stale = stale
        self.prev: Optional[Index] = self.ix.snapshot() if stale else None

    def answer(self, inc, txn_id, kind):
        """(deps [n, T] bool, max conflict [n, 5], the live slots sharing a
        key with the window) for a window's consults: their key incidence
        [n, K], TxnIds (the started-before bound) and kinds."""
        seen = self.prev if self.stale else self.ix
        overlap = seen.overlap(inc)
        return (seen.deps(overlap, txn_id, kind), seen.max_conflict(overlap),
                seen.union(overlap))

    def apply(self, slot, inc, txn_id, kind, move_slot, move_status,
              move_set_ts, move_ts) -> None:
        """The window's joins (in the slots of the oldest, PreAccepted, at
        executeAt = TxnId) and its status moves (some with a new executeAt)."""
        ix = self.ix
        if self.stale:
            self.prev = ix.snapshot()
        slots = ix.on(slot, torch.long)
        ix.put(slots, inc, txn_id, txn_id, kind,
               torch.ones(slots.shape, dtype=torch.long, device=ix.dev))
        m = ix.on(move_slot, torch.long)
        ix.status[m] = ix.on(move_status, torch.long)
        set_ts = ix.on(move_set_ts, torch.bool)
        ix.ts[m] = torch.where(set_ts[:, None], ix.on(move_ts, torch.int32), ix.ts[m])
