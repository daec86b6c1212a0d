"""Live-state multichip dry run: shard a REAL burn's resolver indexes.

VERDICT r03 item 5: ``dryrun_multichip`` must execute protocol-BUILT state,
not synthetic arrays.  This module runs a small contended burn with the
device resolver mirrors live on every command store (the per-store conflict
index the protocol actually maintained: registrations, elision cover bits,
prunes, recycled slots), stacks those indexes store-per-device, and replays
the burn's OWN recorded consult stream through the mesh-sharded consult
(``parallel.build_sharded_store_consult``) — asserting parity against the
unsharded single-device computation on the same arrays.

The cross-store timestamp-proposal reduce (all_gather + lane-lex max over
ICI) is exactly the on-device analog of ``CommandStores.map_reduce`` over
``SafeCommandStore.max_conflict`` (CommandStores.java:580-620), now driven
by live protocol state.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


# the arrays stack_store_indexes consumes — snapshots copy nothing else
_FRAME_KEYS = ("live_inc", "key_inc", "ts", "txn_id", "kind", "status",
               "active")


def collect_live_state(n_stores: int, seed: int = 7, ops: int = 1000,
                       concurrency: int = 16,
                       snapshot_fracs: Tuple[float, ...] = (1 / 3, 2 / 3)):
    """Run a contended burn recording every store's consult stream; return
    (stores, recorder, snapshots) where ``stores`` are the n_stores command
    stores with the largest live device indexes and ``snapshots`` are
    MID-STREAM copies of each store's device mirrors (host arrays + key-slot
    map + recorded-event position) captured at the given op fractions —
    VERDICT r04 item 7: mid-stream states over the mesh, not just the final
    index."""
    from ..harness.burn import run_burn
    from ..harness.consult_trace import ConsultRecorder

    rec = ConsultRecorder()
    targets = sorted({max(1, int(ops * f)) for f in snapshot_fracs})
    snapshots: List[Dict] = []

    def snap(op_id, _txn_id, _txn, _coord) -> None:
        if not targets or op_id != targets[0]:
            return
        targets.pop(0)
        frame: Dict = {}
        for store, events in rec.streams.items():
            tpu = _tpu(store)
            tpu._flush()
            if tpu._h is None:
                continue
            frame[store] = {
                "h": {k: np.array(tpu._h[k]) for k in _FRAME_KEYS},
                "key_slot": dict(tpu.key_slot),
                "event_pos": len(events),
            }
        snapshots.append(frame)

    # shards*nodes >= n_stores so every device can own a distinct live store;
    # few keys -> contention -> deep deps rows in the live index
    run_burn(seed, ops=ops, concurrency=concurrency, nodes=4, rf=3,
             key_count=6, num_shards=max(2, (n_stores + 3) // 4),
             resolver="tpu", consult_recorder=rec, on_submit=snap)
    stores = list(rec.streams.keys())
    stores.sort(key=lambda s: -len(_tpu(s).txns))
    stores = stores[:n_stores]
    # final state as the last "snapshot" frame (live mirrors, full stream)
    final: Dict = {}
    for store in stores:
        tpu = _tpu(store)
        tpu._flush()
        if tpu._h is None:
            continue
        final[store] = {
            "h": {k: np.array(tpu._h[k]) for k in _FRAME_KEYS},
            "key_slot": dict(tpu.key_slot),
            "event_pos": len(rec.streams.get(store, ())),
        }
    snapshots.append(final)
    return stores, rec, snapshots


def _tpu(store):
    r = store.resolver
    # unwrap the recording shim, then any verify pairing
    r = getattr(r, "inner", r)
    return getattr(r, "tpu", r)


def stack_store_indexes(stores, frame: Dict = None) -> Dict[str, np.ndarray]:
    """Stack each store's canonical host mirror into [S, T, ...] arrays,
    padded to the max capacity (pad rows inactive — the kernels mask).
    With ``frame`` (a snapshot from collect_live_state), the SNAPSHOTTED
    mirrors are stacked instead of the live ones."""
    hs = []
    for s in stores:
        if frame is not None:
            hs.append(frame[s]["h"])
            continue
        tpu = _tpu(s)
        tpu._flush()
        hs.append(tpu._h)
    T = max(h["key_inc"].shape[0] for h in hs)
    K = max(h["key_inc"].shape[1] for h in hs)
    S = len(hs)
    out = {
        "live_inc": np.zeros((S, T, K), dtype=np.int8),
        "key_inc": np.zeros((S, T, K), dtype=np.int8),
        "ts": np.zeros((S, T, 5), dtype=np.int32),
        "txn_id": np.zeros((S, T, 5), dtype=np.int32),
        "kind": np.zeros((S, T), dtype=np.int8),
        "status": np.zeros((S, T), dtype=np.int8),
        "active": np.zeros((S, T), dtype=np.bool_),
    }
    for i, h in enumerate(hs):
        t, k = h["key_inc"].shape
        out["live_inc"][i, :t, :k] = h["live_inc"]
        out["key_inc"][i, :t, :k] = h["key_inc"]
        out["ts"][i, :t] = h["ts"]
        out["txn_id"][i, :t] = h["txn_id"]
        out["kind"][i, :t] = h["kind"]
        out["status"][i, :t] = h["status"]
        out["active"][i, :t] = h["active"]
    return out


def build_query_batches(stores, recorder, K: int, batch: int = 8,
                        frame: Dict = None) -> Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray, int]:
    """Per-store [S, B, ...] query arrays from each store's RECORDED consult
    stream — MIXED ops: key_conflicts (kc), max-conflict (mc), and range
    queries (rc, expanded to the indexed keys inside the range), replayed
    through the key-slot mapping of the state they're asked against.  With
    ``frame`` (a mid-stream snapshot), only events recorded BEFORE the
    snapshot replay, against the snapshotted slots.  Stores with fewer than
    ``batch`` replayable queries pad with zero (no-key) queries.

    mc rows use a zero ``before`` bound with kind 0 — the consult kernel's
    max tier ignores the bound (elision never applies to MaxConflicts)."""
    S = len(stores)
    q = np.zeros((S, batch, K), dtype=np.int8)
    before = np.zeros((S, batch, 5), dtype=np.int32)
    qkind = np.zeros((S, batch), dtype=np.int8)
    total_real = 0
    for i, s in enumerate(stores):
        key_slot = frame[s]["key_slot"] if frame is not None \
            else _tpu(s).key_slot
        events = recorder.streams.get(s, [])
        if frame is not None:
            events = events[:frame[s]["event_pos"]]
        got = 0
        # replay the LATEST queries first: they saw the most index state
        for ev in reversed(events):
            if got >= batch:
                break
            tag = ev[0]
            if tag == "kc":
                _t, by, keys, bound = ev
                cols = [key_slot.get(rk) for rk in keys]
                if any(c is None for c in cols) or not cols:
                    continue   # keys pruned from the index since: skip
                q[i, got, cols] = 1
                before[i, got] = bound.pack_lanes()
                qkind[i, got] = int(by.kind)
            elif tag == "mc":
                cols = [key_slot.get(rk) for rk in ev[1]]
                if any(c is None for c in cols) or not cols:
                    continue
                q[i, got, cols] = 1    # before stays 0: max-tier row
            elif tag == "rc":
                _t, by, rng, bound = ev
                cols = [c for rk, c in key_slot.items() if rng.contains(rk)]
                if not cols:
                    continue
                q[i, got, cols] = 1
                before[i, got] = bound.pack_lanes()
                qkind[i, got] = int(by.kind)
            else:
                continue
            got += 1
        total_real += got
    return q, before, qkind, total_real


def host_lex_max(vals: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """[..., N, 5] lane-lexicographic max over N where mask [..., N]; zeros
    when empty — host reference for the device lane-lex reduces."""
    lead = mask.shape[:-1]
    out = np.zeros(lead + (5,), dtype=np.int64)
    tie = mask.copy()
    for lane in range(5):
        v = np.where(tie, vals[..., lane], -1)
        best = v.max(axis=-1)
        tie = tie & (vals[..., lane] == best[..., None])
        out[..., lane] = np.maximum(best, 0)
    return out
