"""The ``windows`` driver: delivery windows of consults through the port's
``device_service.service.DeviceConsultService``.

The service runs over ``Store``, the benchmark's own command-store index:
host arrays in the resolver's layout, the rows changed since the last
window, and the occupancy marks (the surface the service reads of a
resolver).  A window is ``begin_window`` (the service refreshes the changed
rows and pins the snapshot), one ``submit`` per consult, ``result`` on every
future (the first demand dispatches the whole window) and ``end_window``;
the store then applies the window's joins and status moves, outside the
window's time.  The set-up uploads the index (the service's first full
upload) and runs the traffic's warm windows, which are checked like the
rest.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from accord_bench import gen
from accord_bench.reference import WindowReference


class Store:
    """One command store's conflict index on the host, as the service reads
    a resolver: ``host_index()``, ``take_dirty_rows()``, the slot marks."""

    def __init__(self, initial: dict, t: int, k: int, device: torch.device):
        from cassandra_accord_tpu_torch.config import LocalConfig
        key_inc = np.zeros((t, k), dtype=np.int8)
        slot = initial["slot"]
        key_inc[slot] = initial["keys"].incidence()
        h = {"key_inc": key_inc, "live_inc": key_inc,
             "ts": np.zeros((t, 5), np.int32), "txn_id": np.zeros((t, 5), np.int32),
             "kind": np.zeros(t, np.int8), "status": np.zeros(t, np.int8),
             "active": np.zeros(t, np.bool_)}
        h["ts"][slot] = initial["ts"]
        h["txn_id"][slot] = initial["txn_id"]
        h["kind"][slot] = initial["kind"]
        h["status"][slot] = initial["status"]
        h["active"][slot] = True
        self._h = h
        self._dirty: set = set()
        self._max_slot = t - 1
        self._max_key_slot = k - 1
        self.store = None
        self.device_consults = 0
        self.config = LocalConfig(tpu_service="on", tpu_service_backend="torch",
                                  device=str(device))

    def host_index(self) -> Dict[str, np.ndarray]:
        return self._h

    def take_dirty_rows(self) -> set:
        d, self._dirty = self._dirty, set()
        return d

    def apply(self, ev: dict) -> None:
        """The window's transactions join in the slots of the oldest; as
        many live ones move one status up."""
        h, s = self._h, ev["slot"]
        h["key_inc"][s] = ev["keys"].incidence()
        h["txn_id"][s] = ev["txn_id"]
        h["ts"][s] = ev["txn_id"]
        h["kind"][s] = ev["kind"]
        h["status"][s] = gen.PREACCEPTED
        h["active"][s] = True
        m = ev["move_slot"]
        h["status"][m] = ev["move_status"]
        h["ts"][m[ev["move_set_ts"]]] = ev["move_ts"][ev["move_set_ts"]]
        self._dirty.update(s.tolist())
        self._dirty.update(m.tolist())


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device,
                 tracer, keys):
        from cassandra_accord_tpu_torch.device_service.service import \
            DeviceConsultService
        self.service_cls = DeviceConsultService
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev, self.tracer = device, tracer
        self.gen = gen.WindowTraffic(cfg, traffic, seed, keys)
        self.t, self.k = self.gen.t, int(cfg["key_slots"])
        self.sampled = gen.rng(seed, 8).random(1 << 16) < float(traffic["check_deps_share"])
        self.events: List[dict] = []
        self.records: List[dict] = []
        self.out_max: List[np.ndarray] = []
        self.out_deps: Dict[int, list] = {}
        self.failed = 0

    def _extend(self, windows: int) -> None:
        self.events.extend(self.gen.window() for _ in range(windows))

    def setup(self, seconds: float) -> None:
        self.initial = self.gen.initial()
        self.store = Store(self.initial, self.t, self.k, self.dev)
        self.svc = self.service_cls(self.store, config=self.store.config)
        warm = len(self.gen.warm_sizes)
        self._extend(warm)
        for w in range(warm):
            self._window(w, in_window=False)
        half = self.records[warm // 2:]
        pace = sum(r["t1"] - r["t0"] for r in half) / max(1, len(half))
        self._extend(int(math.ceil(seconds / max(pace, 1e-4) * 1.5)) + 16)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _window(self, w: int, in_window: bool) -> None:
        ev, svc, span = self.events[w], self.svc, self.tracer.span
        submit = list(zip(ev["keys"].key_lists(),
                          [tuple(r) for r in ev["txn_id"].tolist()],
                          ev["kind"].tolist()))
        t0 = time.perf_counter()
        with span("bench.refresh"):
            svc.begin_window()
        t_refresh = time.perf_counter()
        with span("bench.submit"):
            futs = [svc.submit(cols, before, kind) for cols, before, kind in submit]
        with span("bench.demand"):
            answers = [f.result() for f in futs]
        svc.end_window()
        t1 = time.perf_counter()
        self.records.append({"t0": t0, "t1": t1, "refresh_s": t_refresh - t0,
                             "n": len(futs), "window": in_window})
        missing = [i for i, a in enumerate(answers) if a is None]
        self.failed += len(missing)
        lanes = np.zeros((len(answers), 5), dtype=np.int64)
        for i, a in enumerate(answers):
            if a is not None:
                lanes[i] = a[1]
        self.out_max.append(lanes)
        if self.sampled[w % self.sampled.size] or w == 0:
            self.out_deps[w] = [None if a is None else a[0] for a in answers]
        with span("bench.mutate"):
            self.store.apply(ev)

    def run(self, seconds: float) -> None:
        w = len(self.records)
        self.stats0 = (self.svc.dispatch_seconds, self.svc.dispatch_count)
        start = time.perf_counter()
        while True:
            if w >= len(self.events):
                with self.tracer.span("bench.traffic"):
                    self._extend(64)
            self._window(w, in_window=True)
            w += 1
            if self.records[-1]["t1"] - start >= seconds:
                break
        self.window = (start, self.records[-1]["t1"])
        self.stats1 = (self.svc.dispatch_seconds, self.svc.dispatch_count)

    def end_to_end(self) -> Dict[str, float]:
        wins = [r for r in self.records if r["window"]]
        span = self.window[1] - self.window[0]
        return {"consults_per_s": sum(r["n"] for r in wins) / span}

    def attempted(self) -> int:
        return sum(r["n"] for r in self.records if r["window"])

    def counters(self) -> Dict[str, float]:
        return {"dispatch_seconds": self.stats1[0] - self.stats0[0],
                "dispatch_count": self.stats1[1] - self.stats0[1]}

    def release(self) -> None:
        self.svc = None
        self.store = None

    def check(self, stale: bool = False) -> Dict[str, dict]:
        """Replay every window run through the reference: the max conflict
        of every consult, the deps of every consult of the sampled windows.
        Events go up in one upload per field and chunk; the counts are read
        once."""
        dev, n = self.dev, len(self.records)
        ref = WindowReference(self.cfg, self.initial, dev, stale=stale)
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        prog_max = up(np.concatenate(self.out_max).astype(np.int32))
        zero = torch.zeros((), dtype=torch.long, device=dev)
        deps_bad, max_bad = zero.clone(), zero.clone()
        unions = torch.zeros((n,), dtype=torch.long, device=dev)
        at = 0
        for c0 in range(0, n, 256):
            evs = self.events[c0:min(n, c0 + 256)]
            cat = lambda f: up(np.concatenate([e[f] for e in evs]))  # noqa: E731
            inc = up(np.concatenate([e["keys"].incidence() for e in evs]))
            slot, txn, kind = cat("slot"), cat("txn_id"), cat("kind")
            m_slot, m_status, m_set, m_ts = (cat(f) for f in (
                "move_slot", "move_status", "move_set_ts", "move_ts"))
            a = b = 0
            for i, ev in enumerate(evs):
                w, k, m = c0 + i, len(ev["slot"]), len(ev["move_slot"])
                deps, mx, unions[w] = ref.answer(inc[a:a + k], txn[a:a + k],
                                                 kind[a:a + k])
                max_bad += (mx != prog_max[at:at + k]).any(dim=1).sum()
                if w in self.out_deps:
                    rows = self.out_deps[w]
                    if any(r is None or r.shape[0] < self.t or r[self.t:].any()
                           for r in rows):
                        deps_bad += sum(r is None for r in rows) or 1
                    else:
                        mine = up(np.stack([r[:self.t] for r in rows]))
                        deps_bad += (mine != deps).any(dim=1).sum()
                ref.apply(slot[a:a + k], inc[a:a + k], txn[a:a + k], kind[a:a + k],
                          m_slot[b:b + m], m_status[b:b + m], m_set[b:b + m],
                          m_ts[b:b + m])
                a, b, at = a + k, b + m, at + k
        for rec, ev, u in zip(self.records, self.events, unions.tolist()):
            rec["union"], rec["distinct"] = u, ev["keys"].distinct()
            rec["cols"] = int(sum(len(c) for c in ev["keys"].key_lists()))
        return {"deps_rows_differ": {"value": int(deps_bad), "limit": 0},
                "max_conflict_differ": {"value": int(max_bad), "limit": 0},
                "unanswered": {"value": self.failed, "limit": 0}}
