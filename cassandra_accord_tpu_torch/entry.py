"""Entry points of the port: the conflict-graph step with example arguments,
and the multi-device dry run.

The twin of the reference's ``__graft_entry__.entry()``: ``entry()`` returns
the full step (``models.conflict_graph.txn_step``: witness, stabilise and one
execution wave over the device-resident conflict graph) with example
arguments sized for one card, built from the same seeded draws as the
reference's, so both packages step the same state and batch.

    from cassandra_accord_tpu_torch.entry import entry
    fn, args = entry()              # on the card; raises without CUDA
    fn, args = entry(device="cpu")  # on the CPU, when asked for
    state, deps, applied = fn(*args)

``dryrun_multichip(n)`` is the twin of the reference's: the sharded data
plane (``parallel/``) over n ranks, one process each, with parity checks
against one device; ``dryrun_multichip(4, device="cpu")`` runs four gloo
ranks on the CPU, and on one card several ranks need ``backend="gloo"``.
"""
import os
from unittest import mock

import numpy as np
import torch


def _example(T, K, B, device="cuda"):
    from .models import TxnBatch
    from .ops import graph_state as gs
    from .primitives.timestamp import TxnId, TxnKind, Domain

    rng = np.random.default_rng(0)
    state = gs.init_state(T, K, device)
    key_inc = np.zeros((B, K), dtype=np.int8)
    lanes = np.zeros((B, gs.TS_LANES), dtype=np.int32)
    kinds = np.zeros(B, dtype=np.int8)
    for i in range(B):
        key_inc[i, rng.choice(K, 3, replace=False)] = 1
        kind = TxnKind.WRITE if rng.random() < 0.5 else TxnKind.READ
        tid = TxnId(epoch=1, hlc=100 + i, node=1 + int(rng.integers(0, 4)),
                    kind=kind, domain=Domain.KEY)
        lanes[i] = tid.pack_lanes()
        kinds[i] = int(kind)
    dev = state.key_inc.device
    batch = TxnBatch(
        slots=torch.arange(B, dtype=torch.int32, device=dev),
        key_inc=torch.from_numpy(key_inc).to(dev),
        txn_id=torch.from_numpy(lanes).to(dev),
        kind=torch.from_numpy(kinds).to(dev),
        valid=torch.ones((B,), dtype=torch.bool, device=dev))
    return state, batch


def entry(device="cuda"):
    """(fn, example_args) — the forward step on the conflict-graph model, on
    ``device`` (the card unless the caller asks for the CPU)."""
    from .models import txn_step
    state, batch = _example(T=256, K=128, B=64, device=device)
    return txn_step, (state, batch)


def _dryrun_rank(mesh, state, batch, frames, adj, status, active):
    """One rank of ``dryrun_multichip``: the sharded step and a sharded
    closure of the adjacency it leaves, the store-sharded consult of every
    live frame, and the per-store frontier of the live wait graphs."""
    from .models import TxnBatch
    from .parallel import launch, mesh as pm
    state = pm.shard_state(state, mesh)
    batch = TxnBatch(**{k: torch.from_numpy(v).to(mesh.device)
                        for k, v in batch.items()})
    state, conflict_max, applied = pm.build_sharded_step(mesh)(state, batch)
    reach = pm.build_sharded_closure(mesh)(state.adj)
    consults = [launch.store_consult_rank(mesh, f) for f in frames]
    ready = launch.frontier_rank(mesh, adj, status, active)["ready"]
    return {"conflict_max": conflict_max, "applied": applied, "reach": reach,
            "consults": consults, "ready": ready}


def dryrun_multichip(n_devices: int, device="cuda", backend=None,
                     timeout_s: float = 300.0) -> dict:
    """Run the FULL sharded data plane over ``n_devices`` ranks, each a
    process on its own device (``parallel.launch.run_ranks``): the sharded
    step and a sharded closure on a small graph, then a REAL contended
    burn whose recorded consult stream (mid-stream and final states, mixed
    query classes, >= 1,000 queries) is answered by the store-sharded
    consult, one store per rank, with parity asserted against the
    single-device consult and a host reference; then the per-store
    frontier of the live wait graphs.

    The twin of the reference's ``__graft_entry__.dryrun_multichip``.  It
    runs on the card (``backend`` nccl by default: one card per rank)
    unless the caller asks for the CPU (gloo); it raises without CUDA, and
    on any parity failure.  Returns a summary (queries, frames, consult
    rates, each rank's kernel launches)."""
    from .device import resolve_device
    from .models import txn_step
    from .ops import TS_LANES
    from .ops import deps_kernels as dk
    from .parallel import launch
    from .parallel import live_dryrun as ld

    dev = resolve_device(device)
    T, K, B = 8 * n_devices, 32, 8
    state, batch = _example(T, K, B, device="cpu")
    state_np = {k: v.numpy() for k, v in state._asdict().items()}
    batch_np = {k: v.numpy() for k, v in batch._asdict().items()}

    # ---- PROTOCOL path on LIVE state: a real contended burn builds every
    # command store's resolver index; its OWN recorded consult stream is
    # replayed over the ranks, one store per rank
    # the burn's resolvers take their device from the environment
    with mock.patch.dict(os.environ, {"ACCORD_DEVICE": dev.type}):
        stores, recorder, snapshots = ld.collect_live_state(n_devices)
    if len(stores) != n_devices:
        raise RuntimeError(f"burn produced {len(stores)} live stores, "
                           f"need {n_devices}")
    usable = [f for f in snapshots if all(s in f for s in stores)]
    per_frame_batch = max(8, 1000 // max(1, len(usable) * n_devices) + 40)
    frames, n_real = [], []
    for frame in usable:
        st = ld.stack_store_indexes(stores, frame=frame)
        if not st["active"].any():
            raise RuntimeError("live indexes are empty")
        q, before, qkind, real = ld.build_query_batches(
            stores, recorder, st["key_inc"].shape[2], batch=per_frame_batch,
            frame=frame)
        if real <= 0:
            raise RuntimeError("no replayable recorded consults")
        frames.append((st["live_inc"], st["key_inc"], st["ts"], st["txn_id"],
                       st["kind"], st["status"], st["active"], q, before,
                       qkind))
        n_real.append(real)
    total_queries = sum(n_real)
    if total_queries < 1000:
        raise RuntimeError(f"only {total_queries} mixed live queries "
                           "replayed over the ranks")
    # final live state: the per-store wait graphs (resolver.edges mirrors
    # of Commands WaitingOn)
    st = ld.stack_store_indexes(stores)
    S, Ts, _Ks = st["key_inc"].shape
    adj = np.zeros((S, Ts, Ts), dtype=np.int8)
    for i, s in enumerate(stores):
        tpu = ld._tpu(s)
        for waiter, deps_set in tpu.edges.items():
            wm = tpu.txns.get(waiter)
            if wm is None:
                continue
            for d in deps_set:
                dm = tpu.txns.get(d)
                if dm is not None:
                    adj[i, wm.slot, dm.slot] = 1

    results = launch.run_ranks(
        n_devices, _dryrun_rank,
        (state_np, batch_np, frames, adj, st["status"], st["active"]),
        device=dev, backend=backend, timeout_s=timeout_s)
    vals = [r.value for r in results]

    # ---- the sharded step and closure against one device ----------------
    applied, conflict_max = vals[0]["applied"], vals[0]["conflict_max"]
    if not applied.any():
        raise RuntimeError("no txn executed in dry run")
    if conflict_max.shape != (B, TS_LANES):
        raise RuntimeError(f"conflict_max shape {conflict_max.shape}")
    single, _deps, applied1 = txn_step(*_example(T, K, B, device=dev))
    if not np.array_equal(applied, applied1.cpu().numpy()):
        raise RuntimeError("sharded step applied != single-device txn_step")
    reach = np.concatenate([v["reach"] for v in vals])
    if not np.array_equal(reach,
                          dk.transitive_closure(single.adj).cpu().numpy()):
        raise RuntimeError("sharded closure != single-device closure")

    # ---- the store-sharded consult of every frame -----------------------
    consult_ms = 0.0
    for i, args in enumerate(frames):
        deps = np.concatenate([v["consults"][i]["deps"] for v in vals])
        global_max = vals[0]["consults"][i]["global_max"]
        consult_ms += max(v["consults"][i]["times"]["wall_ms"] for v in vals)
        # parity 1: sharded == unsharded single-device on the same arrays
        for s in range(S):
            d1, _m1 = dk.consult(*(torch.from_numpy(np.ascontiguousarray(
                x[s])).to(dev) for x in args))
            if not np.array_equal(deps[s], d1.cpu().numpy()):
                raise RuntimeError(
                    "sharded deps != single-device deps on live state")
        # parity 2: the cross-store lane-lex reduce against a host reference
        live_inc, key_inc, ts, txn_id, _k, _s, active, q, _b, _qk = args
        per_slot = np.where(_lex_less_np(ts, txn_id)[..., None], txn_id, ts)
        mc_mask = (np.einsum("sbk,stk->sbt", q.astype(np.int32),
                             key_inc.astype(np.int32)) > 0) \
            & active[:, None, :]
        per_slot_b = np.broadcast_to(per_slot[:, None, :, :],
                                     mc_mask.shape + (5,))
        expect = ld.host_lex_max(per_slot_b, mc_mask)            # [S, B, 5]
        expect = ld.host_lex_max(expect.transpose(1, 0, 2),
                                 np.ones(expect.shape[1::-1], dtype=bool))
        if not all(np.array_equal(v["consults"][i]["global_max"], expect)
                   for v in vals):
            raise RuntimeError(
                "cross-store max-conflict reduce mismatch on live state")
        if global_max.shape != (q.shape[1], TS_LANES):
            raise RuntimeError(f"global_max shape {global_max.shape}")

    # ---- the per-store frontier ------------------------------------------
    ready = np.concatenate([v["ready"] for v in vals])
    for s in range(S):
        want = dk.kahn_frontier(*(torch.from_numpy(x[s]).to(dev) for x in (
            adj, st["status"], st["active"])))
        if not np.array_equal(ready[s], want.cpu().numpy()):
            raise RuntimeError("sharded frontier != single-device frontier")
    seconds = consult_ms / 1e3
    return {"ranks": n_devices,
            "backend": launch.resolve_backend(backend, dev, n_devices),
            "device": str(dev), "queries": total_queries,
            "frames": len(frames), "skipped_frames": len(snapshots) - len(usable),
            "stores": S, "txn_slots": Ts,
            "consult_s": seconds,
            "queries_per_s": total_queries / max(seconds, 1e-9),
            "launches": [r.launches for r in results]}


def _lex_less_np(a, b):
    lt = a[..., 4] < b[..., 4]
    for lane in range(3, -1, -1):
        lt = (a[..., lane] < b[..., lane]) | ((a[..., lane] == b[..., lane]) & lt)
    return lt
