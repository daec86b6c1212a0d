"""Start one process per rank, run a function in each, collect the results.

The reference's mesh is driven by one controller process (``shard_map``);
here every rank is a process of its own, so the port needs this launcher.

    from cassandra_accord_tpu_torch.parallel import launch
    results = launch.run_ranks(4, fn, args, device="cpu")   # gloo, 4 CPU ranks
    results = launch.run_ranks(4, fn, args)                 # nccl, 4 cards

``fn(mesh, *args)`` runs in every rank, inside an initialised process
group; it must be a module-level function of an importable module (the
processes are spawned, so it is sent by name, and ``args`` are pickled once
into the run's directory).  Rank ``r`` runs on ``cuda:(r % device_count)``,
or on the CPU when asked for (one thread per rank).  The rendezvous is a
file in a fresh temporary directory, never a TCP port.

The backend is the caller's: ``"nccl"`` needs one card per rank and raises
when there are fewer; ``"gloo"`` runs the collectives through host memory
whatever the tensors' device (the compute stays on the rank's device).
The default is ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``; nothing
switches between them by itself.  Processes talk over the loopback
interface only.

The kernels are built in the parent before the ranks start (they would
race on the build directory).  A rank that raises, dies or outlives
``timeout_s`` makes ``run_ranks`` kill every rank and raise.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device

BACKENDS = ("nccl", "gloo")


class RankResult(NamedTuple):
    value: Any                 # fn's result, tensors turned into numpy
    launches: Dict[str, int]   # that rank's kernel launches during fn


def to_numpy(x):
    """``x`` with every tensor in it (nested in tuples, lists and dicts)
    copied to a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x


def sequence(mesh, calls: Sequence):
    """Run several rank functions in one process group: ``calls`` is a
    list of ``(fn, args)``; returns their results in order."""
    return [fn(mesh, *args) for fn, args in calls]


def _rank_main(rank: int, world: int, fn, run_dir: str, device: str,
               backend: str, timeout_s: float) -> None:
    import torch.distributed as dist
    from ..ops import _kernels
    from .mesh import make_mesh
    out_path = os.path.join(run_dir, f"rank{rank}.pkl")
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if device == "cpu":
            torch.set_num_threads(1)
            dev = torch.device("cpu")
        else:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(run_dir, "rdzv"),
            rank=rank, world_size=world, timeout=timedelta(seconds=timeout_s),
            **kw)
        try:
            with open(os.path.join(run_dir, "args.pkl"), "rb") as f:
                args = pickle.load(f)
            mesh = make_mesh(dev)
            _kernels.reset_launches()
            value = fn(mesh, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            launches = dict(_kernels.LAUNCHES)
            result = {"ok": True,
                      "result": RankResult(to_numpy(value), launches)}
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent, then exit
        result = {"ok": False, "error": traceback.format_exc()}
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, out_path)
    if not result["ok"]:
        raise SystemExit(1)


def resolve_backend(backend, dev: torch.device, n: int) -> str:
    """The backend ``n`` ranks on ``dev`` use: ``backend``, or nccl on
    cuda and gloo on the CPU when it is None.  Raises for nccl without a
    card per rank."""
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs cuda ranks")
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(
                f"nccl needs one card per rank: {n} ranks, {have} card(s); "
                "ask for backend='gloo' to put several ranks on one card")
    return backend


def run_ranks(n: int, fn, args: Sequence = (), device="cuda", backend=None,
              timeout_s: float = 60.0) -> List[RankResult]:
    """Run ``fn(mesh, *args)`` in ``n`` spawned ranks; return each rank's
    ``RankResult`` in rank order.  Raises without CUDA unless ``device`` is
    the CPU, for ``nccl`` with fewer cards than ranks, and when any rank
    fails or the ranks are not done within ``timeout_s`` (every rank is
    killed first)."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    backend = resolve_backend(backend, dev, n)
    if dev.type == "cuda":
        from ..ops import _kernels
        _kernels.build()
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="accord_ranks_") as run_dir:
        with open(os.path.join(run_dir, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, fn, run_dir, dev.type, backend,
                                   timeout_s))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.exitcode is None for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break               # one rank failed: the rest may wait
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{n} ranks not done within {timeout_s} s "
                        f"(exit codes {[p.exitcode for p in procs]})")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(run_dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result (exit code {p.exitcode})")
                continue
            with open(path, "rb") as f:
                res = pickle.load(f)
            if res["ok"]:
                results.append(res["result"])
            else:
                errors.append(f"rank {r}:\n{res['error']}")
        if errors:
            raise RuntimeError(f"{len(errors)} of {n} ranks failed:\n"
                               + "\n".join(errors))
    return results


# ---------------------------------------------------------------------------
# rank programs: host inputs in, this rank's results out (run_ranks turns
# their tensors into numpy).  Each shards its inputs itself, so a rank
# holds only its block on its device.
# ---------------------------------------------------------------------------

def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _timed(mesh, fn):
    """(fn(), its numbers) for one call, the device synchronised before and
    after it and around each collective: wall ms, device ms (CUDA events;
    None on the CPU), the ms spent in collectives (waiting for the other
    ranks included), and the kernel launches it made.  No barrier lines
    the ranks up first: with several ranks on one card that made every
    step slower (all their kernels then reach the card at once)."""
    from ..ops import _kernels
    _sync(mesh)
    mesh.timed = True
    c0, l0 = mesh.collective_s, dict(_kernels.LAUNCHES)
    e0 = e1 = None
    if mesh.device.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    w0 = time.perf_counter()
    out = fn()
    if e1 is not None:
        e1.record()
    _sync(mesh)
    mesh.timed = False
    return out, {"wall_ms": (time.perf_counter() - w0) * 1e3,
                 "device_ms": e0.elapsed_time(e1) if e0 is not None else None,
                 "collective_ms": (mesh.collective_s - c0) * 1e3,
                 "launches": {k: v - l0[k]
                              for k, v in _kernels.LAUNCHES.items()}}


def nonzero_rows(x: torch.Tensor, rows_per_chunk: int = 4096) -> torch.Tensor:
    """[E, 2] int64 coordinates of the nonzeros of a 2-D tensor, in
    row-major order, a block of rows at a time (so no call sees 2^31
    elements: the [T, T] adjacency at T = 65,536 has 2^32)."""
    parts = []
    for r0 in range(0, x.shape[0], rows_per_chunk):
        nz = torch.nonzero(x[r0:r0 + rows_per_chunk])
        nz[:, 0] += r0
        parts.append(nz)
    if not parts:
        return torch.zeros((0, 2), dtype=torch.long, device=x.device)
    return torch.cat(parts)


def local_state_numpy(state) -> dict:
    """A rank's GraphState, its adjacency as the coordinates and values of
    its nonzeros (``adj_index`` [E, 2], ``adj_values`` [E], ``adj_shape``)."""
    out = {f: getattr(state, f) for f in state._fields if f != "adj"}
    nz = nonzero_rows(state.adj)
    out["adj_index"] = nz
    out["adj_values"] = state.adj[nz[:, 0], nz[:, 1]]
    out["adj_shape"] = tuple(state.adj.shape)
    return out


def steps_rank(mesh, fields, batches) -> dict:
    """The sharded step (``mesh.build_sharded_step``) over ``batches``
    (numpy TxnBatch fields) from the host state ``fields`` (adj dense or a
    ``Coo``).  Returns each step's conflict_max [N, B, 5] and applied
    [N, T], the final local state (``local_state_numpy``), each step's
    numbers (``_timed``) and the peak device bytes of the steps."""
    from ..models.conflict_graph import TxnBatch
    from .mesh import build_sharded_step, shard_state
    state = shard_state(fields, mesh)
    ups = [TxnBatch(**{k: torch.from_numpy(np.ascontiguousarray(b[k]))
                       .to(mesh.device) for k in TxnBatch._fields})
           for b in batches]
    step = build_sharded_step(mesh)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    cmax, applied, times = [], [], []
    for batch in ups:
        (state, c, a), t = _timed(mesh, lambda: step(state, batch))
        cmax.append(c)
        applied.append(a)
        times.append(t)
    peak = torch.cuda.max_memory_allocated(mesh.device) \
        if mesh.device.type == "cuda" else None
    return {"conflict_max": torch.stack(cmax), "applied": torch.stack(applied),
            "state": local_state_numpy(state), "times": times,
            "peak_bytes": peak}


def store_consult_rank(mesh, arrays) -> dict:
    """The store-sharded consult (``mesh.build_sharded_store_consult``)
    over this rank's block of the store-stacked ``arrays`` (live_inc,
    key_inc, ts, txn_id, kind, status, active, q, before, qkind).  Returns
    deps [Sl, B, T], global_max [B, 5], max_lanes [Sl, B, 5] and the
    call's numbers (``_timed``)."""
    from .mesh import build_sharded_store_consult, shard_rows
    local = [shard_rows(a, mesh) for a in arrays]
    consult = build_sharded_store_consult(mesh)
    (deps, gmax, lanes), t = _timed(mesh, lambda: consult(*local))
    return {"deps": deps, "global_max": gmax, "max_lanes": lanes, "times": t}


def closure_rank(mesh, adj) -> dict:
    """The row-parallel closure (``mesh.build_sharded_closure``) of this
    rank's rows of ``adj`` ([T, T] numpy or ``Coo``): the local
    reachability rows [T/n, T] and the call's numbers."""
    from .mesh import build_sharded_closure, shard_rows
    local = shard_rows(adj, mesh)
    closure = build_sharded_closure(mesh)
    reach, t = _timed(mesh, lambda: closure(local))
    return {"reach": reach, "times": t}


def frontier_rank(mesh, adj, status, active) -> dict:
    """The per-store frontier (``mesh.build_sharded_frontier``) of this
    rank's block of stores (``adj`` [S, T, T] numpy or ``Coo``): ready
    [Sl, T] and the call's numbers."""
    from .mesh import build_sharded_frontier, shard_rows
    local = (shard_rows(adj, mesh), shard_rows(status, mesh),
             shard_rows(active, mesh))
    frontier = build_sharded_frontier(mesh)
    ready, t = _timed(mesh, lambda: frontier(*local))
    return {"ready": ready, "times": t}
