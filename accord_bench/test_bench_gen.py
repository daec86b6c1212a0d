"""CPU tests of the traffic generator (accord_bench/gen.py)."""
from pathlib import Path

import numpy as np

from accord_bench import gen, named

HERE = Path(__file__).resolve().parent
POINT = {"txn_slots": 256, "key_slots": 32, "nodes": 5,
         "keys": {"dist": "ycsb_zipfian", "items": 10 ** 10,
                  "theta": 0.99, "zetan": 26.46902820178302},
         "write_share": 0.5, "slow_share": 0.5}
STEP = {"batch": 8, "gc_every": 4, "gc_free": 32, "backlog": 3}
WINDOWS = {"consults": {"mean": 4, "min": 1, "max": 8}, "moves_per_consult": 1,
           "invalidate_share": 0.1, "warm_sizes": [1, 2]}
BIG_SEED = 2 ** 31 + 12345


def keys(cfg, seed):
    return named.load(HERE / "keys" / f"{cfg['keys']['dist']}.py").Keys(cfg, seed)


def test_same_seed_same_events():
    a = gen.WindowTraffic(POINT, WINDOWS, BIG_SEED, keys(POINT, BIG_SEED))
    b = gen.WindowTraffic(POINT, WINDOWS, BIG_SEED, keys(POINT, BIG_SEED))
    for x, y in ((a.initial(), b.initial()), (a.window(), b.window())):
        assert np.array_equal(x["txn_id"], y["txn_id"])
        assert np.array_equal(x["keys"].incidence(), y["keys"].incidence())
    other = gen.WindowTraffic(POINT, WINDOWS, 7, keys(POINT, 7))
    assert not np.array_equal(other.initial()["txn_id"], a.initial()["txn_id"])


def test_ycsb_zipfian_records():
    cfg = dict(POINT, key_slots=1000)
    ks = keys(cfg, 3).draw(gen.rng(3, 0), 20000)
    assert ks.cols.shape == (20000, 1)
    assert (ks.incidence().sum(axis=1) == 1).all()
    assert ks.cols.min() >= 0 and ks.cols.max() < 1000
    share = np.bincount(ks.cols.ravel(), minlength=1000) / ks.cols.size
    # rank 0 alone takes 1 / ZETAN = 3.8% of the draws, on one record
    assert 0.03 < share.max() < 0.06 and (share > 0).sum() > 900


def test_fnvhash64():
    mod = named.load(HERE / "keys" / "ycsb_zipfian.py")
    # FNV-1a over the 8 little-endian bytes, as YCSB's Utils.fnvhash64
    want = 0xCBF29CE484222325
    for byte in (1, 0, 0, 0, 0, 0, 0, 0):
        want = ((want ^ byte) * 1099511628211) % 2 ** 64
    want = abs(want - 2 ** 64 if want >= 2 ** 63 else want)
    assert int(mod.fnvhash64(np.array([1]))[0]) == want


def test_key_sets_overlap():
    a = gen.KeySets(8, np.array([[0, 1], [2, 3]]))
    b = gen.KeySets(8, np.array([[1, 5], [4, 6], [3, 0]]))
    assert a.overlap(b).tolist() == [[True, False, True], [False, False, True]]
    assert a.distinct() == 4 and a.key_lists() == [(0, 1), (2, 3)]


def test_txn_ids_unique_and_lagged_order():
    clock = gen.Clock(POINT, BIG_SEED)
    g = np.arange(0, 5000)
    r = gen.rng(1, 1)
    lag = r.integers(0, gen.LAG_MAX, g.size)
    ids = clock.txn_ids(g, np.zeros(g.size, np.int8), np.ones(g.size, np.int32), lag)
    assert len({tuple(x) for x in ids.tolist()}) == g.size
    assert ids[:, 2].max() < 2 ** 31 - 2 ** 20
    straight = clock.txn_ids(g, np.ones(g.size, np.int8), 3)
    assert (np.diff(straight[:, 2]) > 0).all()
    assert (straight[:, 3] == 4).all()           # a write's kind in the flags


def test_step_backlog_deps():
    """The backlog's deps rows: earlier transactions before the row's
    batch that share a key and that its kind witnesses, by brute force."""
    tr = gen.StepTraffic(POINT, STEP, 5, keys(POINT, 5))
    ini = tr.initial()
    n, p = 256 - 32, 3 * 8
    assert (ini["status"][:n - p] == gen.APPLIED).all()
    assert (ini["status"][n - p:] == gen.STABLE).all()
    sets = [set(r) for r in ini["keys"].cols.tolist()]
    for i in range(p):
        row = n - p + i
        start = n - p + (i // 8) * 8
        want = [j for j in range(start) if sets[row] & sets[j]
                and gen.WITNESSES[ini["kind"][row], ini["kind"][j]]]
        assert np.flatnonzero(ini["deps"][i]).tolist() == [int(ini["slot"][j]) for j in want]
    assert ini["deps"].any()


def test_step_gc_keeps_the_live_set_in_bounds():
    tr = gen.StepTraffic(POINT, STEP, 5, keys(POINT, 5))
    ini = tr.initial()
    live = {int(g): int(s) for g, s in zip(ini["g"], ini["slot"])}
    assert len(live) == 256 - 32
    for s in range(12):
        ev = tr.step(s)
        assert not set(ev["slot"].tolist()) & set(live.values())
        live.update({int(g): int(x) for g, x in zip(ev["g"], ev["slot"])})
        assert len(live) <= 256
        if ev["gc"] is not None:
            w = int(ev["gc"][2])
            live = {g: x for g, x in live.items() if tr.clock.hlc(g) >= w}
            assert len(live) == 256 - 32


def test_windows_join_oldest_and_move_statuses():
    tr = gen.WindowTraffic(POINT, WINDOWS, 9, keys(POINT, 9))
    ini = tr.initial()
    assert set(np.unique(ini["status"]).tolist()) <= {1, 2, 3, 4, 5, 6}
    status = ini["status"].copy()
    sizes = []
    for _ in range(30):
        ev = tr.window()
        n = len(ev["slot"])
        sizes.append(n)
        assert (ev["slot"] == ev["g"] % 256).all()     # the oldest retire
        status[ev["slot"]] = gen.PREACCEPTED
        old = status[ev["move_slot"]]
        assert len(ev["move_slot"]) == n
        moved = ev["move_status"]
        assert ((moved == np.minimum(old + 1, 5)) | (moved == gen.INVALIDATED)).all()
        status[ev["move_slot"]] = moved
        assert ev["move_set_ts"].sum() <= (moved == gen.ACCEPTED).sum()
    assert sizes[:2] == [1, 2]
    assert all(1 <= n <= 8 for n in sizes)
    assert np.array_equal(status, tr.status)
