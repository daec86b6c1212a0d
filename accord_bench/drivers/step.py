"""The ``step`` driver: batches through the port's conflict-graph step.

Each step runs ``models.conflict_graph.txn_step`` on the device-resident
``GraphState`` (witness, stabilise, one execution wave), gathers the batch's
executeAt from the state, and brings the batch's deps, its executeAt and the
applied set to the host; after every GC-th batch ``gc_step`` runs inside the
same step's time.  The set-up makes the state directly from the generator's
initial events (applied transactions, and the execution backlog, stable,
with its dependency rows in the adjacency) and runs the traffic's first
``warm_steps`` batches, which are checked like the rest.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from accord_bench import gen
from accord_bench.reference import StepReference


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device,
                 tracer, keys):
        from cassandra_accord_tpu_torch.models import conflict_graph
        from cassandra_accord_tpu_torch.ops import graph_state
        self.cg, self.gs = conflict_graph, graph_state
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev, self.tracer = device, tracer
        self.gen = gen.StepTraffic(cfg, traffic, seed, keys)
        self.t, self.k, self.b = self.gen.t, int(cfg["key_slots"]), self.gen.batch
        self.warm = int(traffic["warm_steps"])
        self.sampled = gen.rng(seed, 7).random(1 << 16) < float(traffic["check_deps_share"])
        self.events: List[dict] = []
        self.chunks: List[dict] = []        # device batches, as generated
        self.records: List[dict] = []       # one per step run
        self.out_exec: List[np.ndarray] = []
        self.out_applied: List[np.ndarray] = []
        self.out_deps: Dict[int, np.ndarray] = {}
        self.state = None

    # -- traffic -----------------------------------------------------------
    def _extend(self, steps: int) -> None:
        """Generate ``steps`` more batches and put them on the device in one
        upload per field; the key incidence is made there from the key
        slots."""
        s0 = len(self.events)
        evs = [self.gen.step(s) for s in range(s0, s0 + steps)]
        self.events.extend(evs)
        up = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa: E731
            self.dev, dtype=dt)
        cols = up(np.stack([e["keys"].cols for e in evs]), torch.int64)
        key_inc = torch.zeros((steps, self.b, self.k), dtype=torch.int8, device=self.dev)
        key_inc.scatter_(2, cols, 1)
        self.chunks.append({
            "s0": s0, "n": steps,
            "slots": up(np.stack([e["slot"] for e in evs]), torch.int32),
            "key_inc": key_inc,
            "txn_id": up(np.stack([e["txn_id"] for e in evs]), torch.int32),
            "kind": up(np.stack([e["kind"] for e in evs]), torch.int8),
            "gc": {e_i: up(e["gc"], torch.int32)
                   for e_i, e in enumerate(evs) if e["gc"] is not None}})

    def _batch(self, s: int):
        for c in reversed(self.chunks):
            if c["s0"] <= s < c["s0"] + c["n"]:
                i = s - c["s0"]
                return (self.cg.TxnBatch(c["slots"][i], c["key_inc"][i],
                                         c["txn_id"][i], c["kind"][i], self.valid),
                        c["gc"].get(i))
        raise IndexError(s)

    # -- set-up ------------------------------------------------------------
    def setup(self, seconds: float) -> None:
        gs = self.gs
        ini = self.gen.initial()
        state = gs.init_state(self.t, self.k, device=self.dev)
        slot = torch.from_numpy(ini["slot"].astype(np.int64)).to(self.dev)
        state.key_inc[slot] = torch.from_numpy(ini["keys"].incidence()).to(self.dev)
        state.txn_id[slot] = torch.from_numpy(ini["txn_id"]).to(self.dev)
        state.ts[slot] = torch.from_numpy(ini["ts"]).to(self.dev)
        state.kind[slot] = torch.from_numpy(ini["kind"]).to(self.dev)
        state.status[slot] = torch.from_numpy(ini["status"]).to(self.dev)
        state.active[slot] = True
        waiting = slot[torch.from_numpy(ini["status"] == gen.STABLE).to(self.dev)]
        state.adj[waiting] = torch.from_numpy(ini["deps"]).to(self.dev, torch.int8)
        self.state, self.initial = state, ini
        self.valid = torch.ones((self.b,), dtype=torch.bool, device=self.dev)
        pin = self.dev.type == "cuda"
        self.buf_deps = torch.empty((self.b, self.t), dtype=torch.bool, pin_memory=pin)
        self.buf_applied = torch.empty((self.t,), dtype=torch.bool, pin_memory=pin)
        self.buf_exec = torch.empty((self.b, 5), dtype=torch.int32, pin_memory=pin)
        self._extend(self.warm)
        for s in range(self.warm):
            self._step(s, in_window=False)
        # enough batches for the window at the warm steps' pace (the last
        # half of them), generated now; more are made in the window if needed
        half = self.records[self.warm // 2:]
        pace = sum(r["t1"] - r["t0"] for r in half) / max(1, len(half))
        need = int(math.ceil(seconds / max(pace, 1e-4) * 1.5)) + 16
        self._extend(need)
        self.pool = [torch.empty((self.b, self.t), dtype=torch.bool, pin_memory=pin)
                     for _ in range(int(need * float(self.traffic["check_deps_share"]) * 1.5) + 2)]
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- the timed path ----------------------------------------------------
    def _step(self, s: int, in_window: bool) -> None:
        batch, watermark = self._batch(s)
        sample = bool(self.sampled[s % self.sampled.size]) or s == 0
        deps_out = self.pool.pop() if (sample and in_window and self.pool) \
            else self.buf_deps
        with self.tracer.span("bench.step"):
            t0 = time.perf_counter()
            state, deps, applied = self.cg.txn_step(self.state, batch)
            exec_at = state.ts[batch.slots.long()]
            nb = self.dev.type == "cuda"
            deps_out.copy_(deps, non_blocking=nb)
            self.buf_applied.copy_(applied, non_blocking=nb)
            self.buf_exec.copy_(exec_at, non_blocking=nb)
            if watermark is not None:
                state = self.cg.gc_step(state, watermark)
            if nb:
                torch.cuda.current_stream(self.dev).synchronize()
            t1 = time.perf_counter()
        self.state = state
        self.records.append({"t0": t0, "t1": t1, "gc": watermark is not None,
                             "window": in_window})
        self.out_exec.append(self.buf_exec.numpy().copy())
        self.out_applied.append(np.flatnonzero(self.buf_applied.numpy()))
        if sample:
            self.out_deps[s] = (deps_out if deps_out is not self.buf_deps
                                else deps_out.clone()).numpy()

    def run(self, seconds: float) -> None:
        s = len(self.records)
        start = time.perf_counter()
        while True:
            if s >= len(self.events):
                with self.tracer.span("bench.traffic"):
                    self._extend(64)
            self._step(s, in_window=True)
            s += 1
            if self.records[-1]["t1"] - start >= seconds:
                break
        self.window = (start, self.records[-1]["t1"])

    def end_to_end(self) -> Dict[str, float]:
        steps = [r for r in self.records if r["window"]]
        times = sorted((r["t1"] - r["t0"]) * 1e3 for r in steps)
        span = self.window[1] - self.window[0]
        return {"txns_per_s": len(steps) * self.b / span,
                "step_p99_ms": times[max(0, math.ceil(0.99 * len(times)) - 1)]}

    def attempted(self) -> int:
        return sum(r["window"] for r in self.records) * self.b

    def counters(self) -> Dict[str, float]:
        return {}

    def release(self) -> None:
        self.state = None
        self.chunks = []
        self.pool = []
        self.buf_deps = self.buf_applied = None

    # -- the check ---------------------------------------------------------
    def check(self, stale: bool = False) -> Dict[str, dict]:
        """Replay every step run through the reference: executeAt and the
        applied set of every step, the deps of the sampled steps.  Events go
        up in one upload per field and chunk; the counts are read once."""
        dev, n = self.dev, len(self.records)
        ref = StepReference(self.cfg, self.initial, self.b, dev, stale=stale)
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        prog_exec = up(np.stack(self.out_exec))
        ends = np.cumsum([0] + [a.size for a in self.out_applied]).tolist()
        prog_applied = up(np.concatenate(self.out_applied))
        zero = torch.zeros((), dtype=torch.long, device=dev)
        deps_bad, exec_bad, applied_bad = zero.clone(), zero.clone(), zero.clone()
        unions = torch.zeros((n,), dtype=torch.long, device=dev)
        tested = torch.zeros((n,), dtype=torch.long, device=dev)
        for c0 in range(0, n, 256):
            evs = self.events[c0:min(n, c0 + 256)]
            slot, txn, kind = (up(np.stack([e[f] for e in evs]))
                               for f in ("slot", "txn_id", "kind"))
            inc = up(np.stack([e["keys"].incidence() for e in evs]))
            for i, ev in enumerate(evs):
                s = c0 + i
                deps, exec_at, applied, unions[s], tested[s] = ref.step(
                    slot[i], inc[i], txn[i], kind[i], ev["gc"])
                exec_bad += (exec_at != prog_exec[s]).any(dim=1).sum()
                mine = torch.zeros_like(applied)
                mine[prog_applied[ends[s]:ends[s + 1]]] = True
                applied_bad += (mine != applied).any()
                if s in self.out_deps:
                    deps_bad += (up(self.out_deps[s]) != deps).any(dim=1).sum()
        for rec, ev, u, w in zip(self.records, self.events, unions.tolist(),
                                 tested.tolist()):
            rec["union"], rec["tested"] = u, w
            rec["distinct"] = ev["keys"].distinct()
        return {"deps_rows_differ": {"value": int(deps_bad), "limit": 0},
                "exec_at_differ": {"value": int(exec_bad), "limit": 0},
                "applied_sets_differ": {"value": int(applied_bad), "limit": 0}}
