"""The ``zipf-scan`` configuration on the CPU: YCSB workload E's key
distribution (``keys/ycsb_scan.py``), whose rows follow the kinds the
generator draws, and a tiny ``zipf-scan.step``-shaped cell built from the
new files alone in a temporary folder."""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from accord_bench import gen, named, run

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CFG = json.loads((HERE / "configs" / "zipf-scan.json").read_text())
BIG_SEED = 2 ** 31 + 4321
N = 20000


def scan_keys(cfg=CFG, seed=BIG_SEED):
    return named.load(HERE / "keys" / "ycsb_scan.py").Keys(cfg, seed)


def key_order():
    """Each keynum's place in YCSB's key-name order, worked out apart from
    the distribution."""
    fnv = named.load(HERE / "keys" / "ycsb_zipfian.py").fnvhash64
    names = ["user" + str(h) for h in fnv(np.arange(1100)).tolist()]
    order = sorted(range(1100), key=lambda i: names[i])
    place = np.empty(1100, dtype=np.int64)
    place[order] = np.arange(1100)
    return place


def txns(cfg=CFG, seed=BIG_SEED, n=N):
    """``n`` new transactions as the generator makes them: their kinds,
    then their rows."""
    return gen._new_txns(scan_keys(cfg, seed), gen.Clock(cfg, seed), cfg,
                         gen.rng(seed, 0), 0, n, False)


class Drawn:
    """The rows and kinds of ``txns()``."""

    def __init__(self, ev):
        self.k, self.cols, self.kinds = ev["keys"].k, ev["keys"].cols, ev["kind"]
        self.key_lists = ev["keys"].key_lists


@pytest.fixture(scope="module")
def drawn():
    return Drawn(txns())


def test_same_seed_same_draw(drawn):
    again = Drawn(txns())
    assert np.array_equal(again.cols, drawn.cols)
    assert np.array_equal(again.kinds, drawn.kinds)
    other = Drawn(txns(seed=7))
    assert not np.array_equal(other.cols, drawn.cols)


def test_scans_are_contiguous_in_key_name_order(drawn):
    assert drawn.cols.shape == (N, 100) and drawn.k == 2048
    assert drawn.cols.min() >= 0 and drawn.cols.max() < 1100
    lengths = set()
    for row, kind in zip(drawn.cols, drawn.kinds):
        if kind != 0:
            continue
        slots = list(dict.fromkeys(row.tolist()))
        assert slots == list(range(slots[0], slots[0] + len(slots)))
        assert (row[len(slots):] == slots[0]).all()      # padded with the first
        lengths.add(len(slots))
    assert lengths == set(range(1, 101))
    assert drawn.key_lists()[0] == tuple(dict.fromkeys(drawn.cols[0].tolist()))


def test_inserts_are_single_insert_keys(drawn):
    place = key_order()
    inserts = drawn.kinds == 1
    assert 0.04 < inserts.mean() < 0.06
    rows = drawn.cols[inserts]
    assert (rows == rows[:, :1]).all()
    assert set(rows[:, 0].tolist()) == set(place[1000:1100].tolist())


def test_starts_follow_the_scrambled_zipfian_chooser(drawn):
    """A scan starts at the keynum ScrambledZipfianGenerator(0, 1100) draws
    (1,101 items), drawn again where it is 1,100."""
    place = key_order()
    r = gen.rng(BIG_SEED, 0)
    r.random(N)                                     # the kinds
    r.integers(1, CFG["nodes"] + 1, N)              # the coordinators
    chooser = named.load(HERE / "keys" / "ycsb_zipfian.py").Keys(
        dict(CFG, key_slots=1101), BIG_SEED)
    first = chooser.draw(r, N).cols[:, 0]
    scans = drawn.kinds == 0
    kept = scans & (first < 1100)
    assert np.array_equal(drawn.cols[kept, 0], place[first[kept]])
    assert (scans & (first == 1100)).sum() > 0
    hot = np.bincount(first, minlength=1101) / N
    assert 0.03 < hot.max() < 0.06                  # rank 0's 1 / ZETAN


def test_small_store_folds_the_key_order():
    cfg = dict(CFG, key_slots=32)
    ks = txns(cfg, 3, 2000)["keys"]
    assert ks.cols.min() >= 0 and ks.cols.max() == 31 and ks.k == 32


TINY = {"batch": 8, "gc_every": 4, "gc_free": 32, "backlog": 3,
        "warm_steps": 5, "check_deps_share": 0.25}


def tiny_traffic(seed):
    cfg = dict(CFG, txn_slots=256, key_slots=32)
    tr = dict(json.loads((HERE / "traffic" / "scan-step.json").read_text()), **TINY)
    return cfg, tr, gen.StepTraffic(cfg, tr, seed, scan_keys(cfg, seed))


def test_generator_kinds_follow_the_shape():
    """Through the step traffic, a write names one insert key and a read a
    scan's range, in the store and in batches taken in any order."""
    _, _, traffic = tiny_traffic(BIG_SEED)
    kinds, wide_reads = set(), 0
    for ev in (traffic.initial(), traffic.step(5), traffic.step(0)):
        cols = ev["keys"].cols
        single = (cols == cols[:, :1]).all(axis=1)
        assert single[ev["kind"] == 1].all()
        assert np.array_equal(ev["txn_id"][:, 3], ev["kind"].astype(np.int32) << 2)
        kinds.update(ev["kind"].tolist())
        wide_reads += int((~single[ev["kind"] == 0]).sum())
    assert kinds == {0, 1} and wide_reads > 0


def test_rows_only_after_the_generators_kinds():
    """A generator that did not just draw the kinds and nodes of ``n``
    transactions is refused: the rows could not follow their kinds."""
    keys = scan_keys()
    with pytest.raises(ValueError):
        keys.draw(gen.rng(BIG_SEED, 0), 10)
    r = gen.rng(BIG_SEED, 0)
    r.random(10)
    r.integers(1, CFG["nodes"] + 1, 10)
    assert len(keys.draw(r, 10)) == 10
    with pytest.raises(ValueError):
        keys.draw(r, 10)


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    """A BENCHMARK.json of the one tiny ``zipf-scan.step`` cell, over
    copies of the new files."""
    root = tmp_path_factory.mktemp("scan")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = root / "accord_bench"
    for sub in ("configs", "traffic"):
        (base / sub).mkdir(parents=True)
    for sub in ("metrics", "drivers", "keys"):
        shutil.copytree(HERE / sub, base / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cfg, tr, _ = tiny_traffic(1)
    (base / "configs" / "zipf-scan.json").write_text(json.dumps(cfg))
    (base / "traffic" / "scan-step.json").write_text(json.dumps(tr))
    cell = "zipf-scan.step"
    spec["configs"] = [c for c in spec["configs"] if c["name"] == "zipf-scan"]
    spec["workloads"] = [w for w in spec["workloads"] if w["name"] == cell]
    for group in ("end_to_end", "per_layer"):
        spec[group] = [m for m in spec[group] if cell in m.get("workloads", [cell])]
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path


def go(path, *extra):
    return run.main(["--workload", "zipf-scan.step", "--seed", str(BIG_SEED),
                     "--seconds", "0.3", "--device", "cpu", "--bench", str(path),
                     *extra])


@pytest.mark.parametrize("trace", ["0", "1"])
def test_tiny_cell_is_correct(tiny_cell, trace):
    res = go(tiny_cell, "--trace", trace)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert all(v["value"] == 0 for v in res["checks"].values())
    if trace == "0":
        assert set(res["metrics"]) == {"txns_per_s", "step_p99_ms", "setup_s"}
    else:
        # no device on the CPU: the device-trace readers find nothing but idle
        assert set(res["metrics"]) <= {"device.idle_pct.step"}


def test_tiny_cell_stale_control_is_not_correct(tiny_cell):
    res = go(tiny_cell, "--control", "stale")
    assert res["correct"] is False
    assert res["checks"]["deps_rows_differ"]["value"] > 0


def test_join_counts():
    m = named.load(HERE / "metrics" / "scan.join_roofline_pct.py")
    # T = 64, K = 16, B = 2, 3 keys named, 10 live slots sharing one:
    # 3 * 64 / 8 = 24; 10 * (20 + 7/8) = 208.75; 2 * (2 + 20 + 3/8) = 44.75;
    # 2 * 64 / 8 = 16
    assert m.join_bytes(64, 16, 2, 3, 10) == pytest.approx(293.5)
    assert m.join_ops(2, 10) == 160


@pytest.mark.parametrize("name", ["scan.join_roofline_pct", "scan.join_us"])
def test_nothing_to_read_reads_none(name):
    class Run:
        trace = None
    assert named.load(HERE / "metrics" / f"{name}.py").read(Run()) is None
