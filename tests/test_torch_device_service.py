"""The port's persistent batched consult service (device_service/), on the CPU.

Mirrors tests/test_device_service.py against ``cassandra_accord_tpu_torch``:
ragged ingress, batched answers equal per-txn answers, one-shot answers
equal the cfk walk, pinned-snapshot answers while rows refresh (the
copy-on-write contract), incremental refresh, bounded shapes, counters per
consult, zero-launch undemanded windows.  Then the cross-package check: the
same host index loaded through ``front_from_host`` and through the
reference's upload gives the same answers from both services.
"""
import numpy as np
import pytest
import torch

from cassandra_accord_tpu_torch.config import LocalConfig
from cassandra_accord_tpu_torch.device_service.batch import (build_batch,
                                                             pow2_bucket,
                                                             split_rows)
from cassandra_accord_tpu_torch.device_service.index import front_from_host
from cassandra_accord_tpu_torch.device_service.kernel import unpack_deps
from cassandra_accord_tpu_torch.device_service.service import \
    DeviceConsultService
from cassandra_accord_tpu_torch.impl.resolver import (CpuDepsResolver,
                                                      QuerySpec)
from cassandra_accord_tpu_torch.impl.tpu_resolver import TpuDepsResolver
from cassandra_accord_tpu_torch.local.cfk import InternalStatus
from cassandra_accord_tpu_torch.primitives.keys import IntKey, Range
from cassandra_accord_tpu_torch.primitives.timestamp import (Domain,
                                                             Timestamp, TxnId,
                                                             TxnKind)
from cassandra_accord_tpu_torch.utils.random import RandomSource


def k(v):
    return IntKey(v)


def rk(v):
    return IntKey(v).to_routing()


def tid(hlc, node=1, kind=TxnKind.WRITE):
    return TxnId(epoch=1, hlc=hlc, node=node, kind=kind, domain=Domain.KEY)


class _FakeStore:
    """The port's twin of tests/test_resolver.py::_FakeStore: .cfks plus a
    high majority-durable watermark over the keyspace."""

    def __init__(self):
        from cassandra_accord_tpu_torch.local.durability import DurableBefore
        from cassandra_accord_tpu_torch.primitives.keys import Ranges
        self.cfks = {}
        self.durable_before = DurableBefore.of(
            Ranges.of(Range(k(0), k(100000))),
            majority_before=tid(1 << 40), universal_before=None)
        self.durable_gen = 0

    def cfk(self, key):
        from cassandra_accord_tpu_torch.local.cfk import CommandsForKey
        c = self.cfks.get(key)
        if c is None:
            c = CommandsForKey(key)
            self.cfks[key] = c
        return c


def make_service_resolver(txn_capacity=64, key_capacity=64, backend="torch"):
    store = _FakeStore()
    cfg = LocalConfig.from_env(tpu_service="on", tpu_service_backend=backend,
                               tpu_tier="device", device="cpu")
    r = TpuDepsResolver(store, txn_capacity=txn_capacity,
                        key_capacity=key_capacity, config=cfg)
    r.tier = "device"
    return store, r, CpuDepsResolver(store)


def register_both(store, resolver, txn_id, status, execute_at, keys):
    indexed = tuple(key for key in keys
                    if store.cfk(key).update(txn_id, status, execute_at))
    if indexed:
        resolver.register(txn_id, status, execute_at, indexed)


def _random_index(store, resolver, rng, keys, n_txns=120):
    hlc = 0
    live = []
    for _ in range(n_txns):
        hlc += rng.next_int(1, 4)
        kind = rng.pick([TxnKind.WRITE, TxnKind.READ, TxnKind.WRITE])
        t = tid(hlc, node=1 + rng.next_int(3), kind=kind)
        ks = sorted({rng.pick(keys) for _ in range(rng.next_int(1, 5))})
        register_both(store, resolver, t, InternalStatus.PREACCEPTED, None, ks)
        live.append((t, ks))
        if live and rng.next_float() < 0.4:
            t2, ks2 = rng.pick(live)
            st = rng.pick([InternalStatus.ACCEPTED, InternalStatus.COMMITTED,
                           InternalStatus.STABLE, InternalStatus.APPLIED])
            ea = Timestamp(1, hlc + rng.next_int(10), 0, t2.node) \
                if st in (InternalStatus.ACCEPTED, InternalStatus.COMMITTED,
                          InternalStatus.STABLE) else None
            register_both(store, resolver, t2, st, ea, ks2)
    return hlc


# ---------------------------------------------------------------------------
# batch ingress
# ---------------------------------------------------------------------------

def test_pow2_buckets():
    assert pow2_bucket(1, 8) == 8
    assert pow2_bucket(9, 8) == 16
    assert pow2_bucket(300, 8, 256) == 256
    assert split_rows(list(range(10)), 4) == [[0, 1, 2, 3], [4, 5, 6, 7],
                                              [8, 9]]


def test_ragged_batch_shapes_and_densify():
    rows = [(0, 1), (), (2, 2, 2), tuple(range(7))]   # empty + dups + wide
    b = build_batch(rows, [(1, 0, 0, 0, 0)] * 4, [0] * 4)
    assert b.rows == 4 and b.before.shape[0] == 8
    assert b.flat_cols.shape[0] == 16
    assert list(b.offsets[4:]) == [12] * 5            # padding rows width 0
    q = b.densify(8)
    assert q[2].tolist() == [0, 0, 1, 0, 0, 0, 0, 0]  # dups collapse
    # the kernels' plain densify keeps the count (int32, no wrap) and only
    # reads entries below offsets[B]
    from cassandra_accord_tpu_torch.ops._kernels import dense_query
    dq = dense_query(torch.from_numpy(b.offsets), torch.from_numpy(b.flat_cols),
                     8)
    assert dq.shape == (8, 8)
    assert dq[2].tolist() == [0, 0, 3, 0, 0, 0, 0, 0]
    assert (dq[:4] > 0).numpy().astype(np.int8).tolist() == q.tolist()
    assert not dq[4:].any()


# ---------------------------------------------------------------------------
# answers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [11, 12])
def test_ragged_property_batched_equals_per_txn(seed):
    rng = RandomSource(seed)
    store, resolver, oracle = make_service_resolver()
    keys = [rk(i * 10) for i in range(10)]
    hlc = _random_index(store, resolver, rng, keys)
    svc = resolver.service()
    for _round in range(6):
        specs, queries = [], []
        for _q in range(rng.next_int(1, 9)):
            hlc += 1
            q = tid(hlc, kind=rng.pick([TxnKind.WRITE, TxnKind.READ]))
            width = rng.pick([0, 1, 2, len(keys)])
            qk = [rng.pick(keys) for _ in range(width)]
            if qk and rng.next_boolean():
                qk = qk + [qk[0]]
            before = q.as_timestamp()
            specs.append(QuerySpec("kc", q, qk, before))
            if rng.next_boolean():
                specs.append(QuerySpec("mc", None, qk, None))
            queries.append((q, qk, before))
        resolver.prefetch(specs)
        for q, qk, before in queries:
            got = resolver.key_conflicts(q, qk, before)
            expect = oracle.key_conflicts(q, sorted(set(qk)), before)
            assert sorted(set(got)) == sorted(set(expect))
            assert resolver.max_conflict_keys(qk) \
                == oracle.max_conflict_keys(sorted(set(qk)))
        resolver.end_batch()
    assert resolver.device_consults > 0
    assert svc.submitted > 0


def test_oneshot_consult_matches_walk_oracle():
    rng = RandomSource(77)
    store, resolver, oracle = make_service_resolver()
    keys = [rk(i * 10) for i in range(8)]
    hlc = _random_index(store, resolver, rng, keys, n_txns=80)
    for key in keys[:3]:
        cfk = store.cfks.get(key)
        if cfk is not None:
            resolver.on_pruned(key, cfk.prune_applied_before(tid(hlc + 1)))
    for _ in range(20):
        hlc += 2
        q = tid(hlc, kind=rng.pick([TxnKind.WRITE, TxnKind.READ]))
        qk = sorted({rng.pick(keys) for _ in range(rng.next_int(1, 5))})
        assert sorted(resolver.key_conflicts(q, qk, q.as_timestamp())) \
            == sorted(oracle.key_conflicts(q, qk, q.as_timestamp()))
        assert resolver.max_conflict_keys(qk) == oracle.max_conflict_keys(qk)
    assert resolver.device_consults > 0


def _oneshot_path_against_walk(seed, txn_capacity):
    rng = RandomSource(seed)
    store = _FakeStore()
    cfg = LocalConfig.from_env(tpu_service="off", tpu_tier="device",
                               device="cpu")
    resolver = TpuDepsResolver(store, txn_capacity=txn_capacity,
                               key_capacity=64, config=cfg)
    oracle = CpuDepsResolver(store)
    keys = [rk(i * 10) for i in range(8)]
    hlc = _random_index(store, resolver, rng, keys, n_txns=60)
    for _ in range(15):
        hlc += 2
        q = tid(hlc, kind=rng.pick([TxnKind.WRITE, TxnKind.READ]))
        qk = sorted({rng.pick(keys) for _ in range(rng.next_int(1, 5))})
        assert sorted(resolver.key_conflicts(q, qk, q.as_timestamp())) \
            == sorted(oracle.key_conflicts(q, qk, q.as_timestamp()))
        assert resolver.max_conflict_keys(qk) == oracle.max_conflict_keys(qk)
    assert resolver.device_consults > 0 and resolver._service_obj is None
    # the one-shot path keeps the kernels' layout, not [T, K] copies
    assert resolver._device["live_T"].shape == (64, txn_capacity)


def test_legacy_oneshot_path_matches_walk_oracle():
    """tpu_service="off": the one-shot ragged_consult_t path."""
    _oneshot_path_against_walk(78, 64)


def test_oneshot_path_bit_packed_at_32k_slots_matches_walk_oracle():
    """At T >= 32,768 slots the one-shot path bit-packs the deps mask."""
    _oneshot_path_against_walk(79, 32768)


# ---------------------------------------------------------------------------
# pinned snapshots (copy-on-write refresh)
# ---------------------------------------------------------------------------

def test_window_answers_against_pinned_snapshot():
    store, resolver, oracle = make_service_resolver()
    key = rk(10)
    register_both(store, resolver, tid(10), InternalStatus.PREACCEPTED,
                  None, [key])
    svc = resolver.service()
    svc.begin_window()
    pinned = {n: v.clone() for n, v in svc._window.buffers.items()}
    q = tid(100)
    fut = svc.submit([resolver.key_slot[key]], q.as_timestamp().pack_lanes(),
                     int(q.kind), post=resolver._post_kc([key]))
    register_both(store, resolver, tid(50), InternalStatus.PREACCEPTED,
                  None, [key])
    # a one-shot consult refreshes the index while the window is still open
    now = {t for _k, t in resolver.key_conflicts(tid(101), [key],
                                                 tid(101).as_timestamp())}
    assert now == {tid(10), tid(50)}
    assert svc.index.front is not svc._window.buffers
    for name, before in pinned.items():
        assert torch.equal(svc._window.buffers[name], before), \
            f"refresh wrote into the pinned buffer {name}"
    got = {t for _k, t in fut.result()}
    assert got == {tid(10)}, "snapshot window must not see mid-window txns"
    svc.end_window()
    assert svc.index.incremental_refreshes + svc.index.full_uploads >= 2


def test_incremental_refresh_not_full_reupload():
    store, resolver, _ = make_service_resolver(txn_capacity=256,
                                               key_capacity=64)
    keys = [rk(i * 10) for i in range(8)]
    for i in range(80):
        register_both(store, resolver, tid(10 + i, node=1 + i % 3),
                      InternalStatus.PREACCEPTED, None,
                      [keys[i % len(keys)]])
    resolver.key_conflicts(tid(500), keys[:2], tid(500).as_timestamp())
    svc = resolver.service()
    full_before = svc.index.full_uploads
    for i in range(30):
        register_both(store, resolver, tid(1000 + i, node=1 + i % 3),
                      InternalStatus.PREACCEPTED, None,
                      [keys[i % len(keys)]])
        resolver.key_conflicts(tid(2000 + i), [keys[i % len(keys)]],
                               tid(2000 + i).as_timestamp())
    assert svc.index.incremental_refreshes >= 25
    assert svc.index.full_uploads == full_before
    # the refreshed buffers equal a fresh upload of the host index
    h = resolver.host_index()
    fresh = front_from_host(h, *svc.index.view, "cpu")
    for name, v in fresh.items():
        assert torch.equal(svc.index.front[name], v), name


def test_steady_state_shapes_bounded():
    rng = RandomSource(5)
    store, resolver, _ = make_service_resolver(txn_capacity=256,
                                               key_capacity=64)
    keys = [rk(i * 10) for i in range(8)]
    _random_index(store, resolver, rng, keys, n_txns=100)
    svc = resolver.service()
    hlc_box = [10_000]

    def drive(rounds):
        sizes, widths = [1, 3, 8, 12], [0, 1, 2, 3]
        for r in range(rounds):
            svc.begin_window()
            futs = []
            for q_i in range(sizes[r % len(sizes)]):
                hlc_box[0] += 1
                q = tid(hlc_box[0])
                qk = [keys[(q_i + j) % len(keys)]
                      for j in range(widths[(r + q_i) % len(widths)])]
                known = [x for x in qk if x in resolver.key_slot]
                futs.append(svc.submit([resolver.key_slot[x] for x in known],
                                       q.as_timestamp().pack_lanes(),
                                       int(q.kind),
                                       post=resolver._post_kc(known)))
            for f in futs:
                f.result()
            svc.end_window()

    drive(12)
    mid = set(svc.jit_shapes) | set(svc.index.jit_shapes)
    drive(12)
    end = set(svc.jit_shapes) | set(svc.index.jit_shapes)
    assert end == mid
    assert len(end) <= 24


def test_device_consults_counted_per_consult_not_per_batch():
    store, resolver, _ = make_service_resolver()
    keys = [rk(i * 10) for i in range(6)]
    for i in range(20):
        register_both(store, resolver, tid(10 + i),
                      InternalStatus.PREACCEPTED, None, [keys[i % 6]])
    svc = resolver.service()
    before_consults, before_batches = resolver.device_consults, svc.batches
    svc.begin_window()
    futs = [svc.submit([resolver.key_slot[keys[i % 6]]],
                       tid(1000 + i).as_timestamp().pack_lanes(), 0,
                       post=resolver._post_kc([keys[i % 6]]))
            for i in range(10)]
    futs[0].result()
    svc.end_window()
    assert resolver.device_consults - before_consults == 10
    assert svc.batches - before_batches == 1
    assert all(f.done for f in futs)


def test_undemanded_window_costs_zero_launches():
    store, resolver, _ = make_service_resolver()
    key = rk(10)
    register_both(store, resolver, tid(10), InternalStatus.PREACCEPTED,
                  None, [key])
    svc = resolver.service()
    svc.begin_window()
    svc.submit([resolver.key_slot[key]], tid(99).as_timestamp().pack_lanes(),
               0, post=resolver._post_kc([key]))
    batches, consults = svc.batches, resolver.device_consults
    svc.end_window()
    assert svc.batches == batches
    assert resolver.device_consults == consults
    assert svc.dropped_windows == 1


# ---------------------------------------------------------------------------
# a window's read-back: only the real rows, unpacked without a conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [32768, 65536])
@pytest.mark.parametrize("bucket,rows", [
    (bucket, rows) for bucket in (8, 32, 64)
    for rows in (1, 7, 8, 31, 32, 33, 63, 64) if rows <= bucket])
def test_unpack_deps_equals_unpack_then_convert(t, bucket, rows):
    """``unpack_deps`` on a bucket's real rows gives what unpacking every
    row and converting to bool, then cutting, gave: same values, bool,
    ``(rows, t)``, C-contiguous, and a fresh array each call."""
    rng = np.random.default_rng(t + 100 * bucket + rows)
    packed = rng.integers(0, 256, (bucket, t // 8), dtype=np.uint8)
    want = np.unpackbits(packed, axis=1, bitorder="little") \
        .astype(bool)[:rows, :t]
    got = unpack_deps(packed[:rows], t)
    again = unpack_deps(packed[:rows], t)
    assert got.dtype == np.bool_ and got.shape == (rows, t)
    assert got.flags.c_contiguous
    assert np.array_equal(got, want) and np.array_equal(again, want)
    assert not np.shares_memory(got, again)
    assert not np.shares_memory(got, packed)


def test_window_counts_padding_rows_not_read_back():
    """Each dispatch counts its padding rows (bucket less real rows) in
    ``pad_rows_skipped``, answers only its real rows, and a later window
    leaves an earlier window's answers as they were."""
    store, resolver, oracle = make_service_resolver()
    keys = [rk(i * 10) for i in range(6)]
    for i in range(20):
        register_both(store, resolver, tid(10 + i),
                      InternalStatus.PREACCEPTED, None, [keys[i % 6]])
    svc = resolver.service()
    skipped, held = 0, []
    for n in (1, 9, 31, 33):
        svc.begin_window()
        qs = [(keys[i % 6], tid(1000 + i)) for i in range(n)]
        futs = [svc.submit([resolver.key_slot[key]],
                           q.as_timestamp().pack_lanes(), int(q.kind),
                           post=resolver._post_kc([key])) for key, q in qs]
        got = [f.result() for f in futs]
        svc.end_window()
        skipped += pow2_bucket(n, 8, svc.max_window) - n
        assert svc.stats()["pad_rows_skipped"] == skipped
        for (key, q), answer in zip(qs, got):
            want = {t for _k, t in oracle.key_conflicts(
                q, [key], q.as_timestamp())}
            assert want and {t for _k, t in answer} == want
        held.append((got, [list(a) for a in got]))
        register_both(store, resolver, tid(500 + n),
                      InternalStatus.PREACCEPTED, None, [keys[n % 6]])
        for answers, copies in held:
            assert [list(a) for a in answers] == copies


# ---------------------------------------------------------------------------
# configuration: no silent CPU, no unknown backend
# ---------------------------------------------------------------------------

def test_service_without_cpu_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    store = _FakeStore()
    cfg = LocalConfig.from_env(tpu_service="on", tpu_tier="device")
    assert cfg.device == "cuda"
    r = TpuDepsResolver(store, config=cfg)
    with pytest.raises(RuntimeError):
        DeviceConsultService(r, config=cfg)
    # the host backend needs no device
    host = DeviceConsultService(r, config=LocalConfig.from_env(
        tpu_service_backend="host"))
    assert not host.deferred


def test_unknown_backend_raises():
    store = _FakeStore()
    cfg = LocalConfig.from_env(tpu_service_backend="jax", device="cpu")
    with pytest.raises(ValueError):
        DeviceConsultService(TpuDepsResolver(store, config=cfg), config=cfg)


def test_device_env_field(monkeypatch):
    monkeypatch.setenv("ACCORD_DEVICE", "CPU")
    assert LocalConfig.from_env().device == "cpu"


# ---------------------------------------------------------------------------
# cross-package: one host index, both services
# ---------------------------------------------------------------------------

def _bare(resolver_cls, cfg, h):
    """A resolver shell over a given host index (bench.py's stand-in)."""
    t, k_ = h["key_inc"].shape
    r = resolver_cls.__new__(resolver_cls)
    r.host_consults = r.native_consults = r.device_consults = 0
    r._host_engine = "numpy"
    r._h = h
    r._dirty_rows = set()
    r._max_slot = t - 1
    r._max_key_slot = k_ - 1
    r.store = None
    r.config = cfg
    r.host_index = lambda: r._h

    def take_dirty():
        d = r._dirty_rows
        r._dirty_rows = set()
        return d
    r.take_dirty_rows = take_dirty
    return r


@pytest.mark.parametrize("seed", [31, 32])
def test_same_host_index_same_answers_as_reference_service(seed):
    from cassandra_accord_tpu.config import LocalConfig as RefConfig
    from cassandra_accord_tpu.device_service.index import \
        DoubleBufferedIndex as RefIndex
    from cassandra_accord_tpu.device_service.service import \
        DeviceConsultService as RefService
    from cassandra_accord_tpu.impl.tpu_resolver import \
        TpuDepsResolver as RefResolver
    rng = RandomSource(seed)
    store, resolver, _ = make_service_resolver(txn_capacity=128)
    keys = [rk(i * 10) for i in range(12)]
    _random_index(store, resolver, rng, keys, n_txns=100)
    h = {n: v.copy() for n, v in resolver.host_index().items()}
    t_view, k_view = 128, 64
    # the state-carrying upload: the port's buffers equal the reference's
    ref_ix = RefIndex()
    ref_ix._full_upload(h, t_view, k_view)
    port_front = front_from_host(h, t_view, k_view, "cpu")
    for name in ("ts", "txn_id", "kind", "status", "active"):
        assert np.array_equal(port_front[name].numpy(),
                              np.asarray(ref_ix.front[name])), name
    for name in ("live_T", "key_T"):
        assert np.array_equal(port_front[name].numpy(),
                              np.asarray(ref_ix.front[name]) != 0), name
    # both services over the same host index answer the same batch
    nprng = np.random.default_rng(seed)
    b = 24
    q = (nprng.random((b, h["key_inc"].shape[1])) < 0.08).astype(np.int8)
    q[0] = 0
    before = np.zeros((b, 5), dtype=np.int32)
    before[:, 0] = 1
    before[:, 2] = nprng.integers(0, 400, b)
    before[:, 4] = nprng.integers(1, 4, b)
    kind = nprng.choice([0, 1, 3, 4], b).astype(np.int8)
    ref_svc = RefService(_bare(RefResolver, RefConfig.from_env(
        tpu_service="on", tpu_service_backend="jax"), h))
    port_svc = DeviceConsultService(_bare(TpuDepsResolver, LocalConfig.from_env(
        tpu_service="on", tpu_service_backend="torch", device="cpu"), h))
    ref_deps, ref_lanes = ref_svc.consult_rows(q, before, kind)
    deps, lanes = port_svc.consult_rows(q, before, kind)
    assert np.array_equal(deps, ref_deps)
    assert np.array_equal(lanes, ref_lanes)
    assert deps.any()
