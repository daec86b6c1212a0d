"""The harness end to end on the CPU, at tiny sizes of its own: every cell's
result line, the control and each fault the cells can have read as not
correct, a cell added from new files alone, a run with no card fails, and
what the harness and the reference import."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from accord_bench import run

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def tiny_bench(root: Path) -> Path:
    """BENCHMARK.json's cells and metrics over tiny copies of its
    configurations and traffic mixes, under ``root``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = root / "accord_bench"
    for sub in ("configs", "traffic"):
        (base / sub).mkdir(parents=True)
    for sub in ("metrics", "drivers", "keys"):
        shutil.copytree(HERE / sub, base / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(txn_slots=256, key_slots=32)
        (base / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    for name in {w["traffic"] for w in bench["workloads"]}:
        tr = json.loads((HERE / "traffic" / f"{name}.json").read_text())
        if tr["driver"] == "step":
            tr.update(batch=8, gc_every=4, gc_free=32, warm_steps=5, backlog=3)
        else:
            tr["consults"].update(mean=4, max=8)
            tr["warm_sizes"] = [1, 2, 3, 8]
        tr["check_deps_share"] = 0.25
        (base / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("bench"))


def cells():
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def go(bench, workload, *extra, seed=2 ** 31 + 77):
    return run.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.3",
                     "--device", "cpu", "--bench", str(bench), *extra])


@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_result_line(bench, workload, trace, capsys):
    res = go(bench, workload, "--trace", trace)
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == res
    assert KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert res["device"]["platform"] == "cpu" and res["device"]["count"] == 1
    spec = json.loads(bench.read_text())
    if trace == "0":
        want = {m["name"] for m in spec["end_to_end"]
                if workload in m.get("workloads", [workload])}
        assert set(res["metrics"]) == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        allowed = {m["name"] for m in spec["per_layer"]
                   if workload in m.get("workloads", [workload])}
        assert set(res["metrics"]) <= allowed
    last = out.err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in last)


@pytest.mark.parametrize("workload", cells())
def test_control_is_not_correct(bench, workload):
    res = go(bench, workload, "--control", "stale")
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


def _clone_state(state):
    return type(state)(*(x.clone() for x in state))


STEP_FAULTS = {
    "state_unchanged": lambda orig: lambda state, batch: (
        state, *orig(_clone_state(state), batch)[1:]),
    "half_batch_left_out": lambda orig: lambda state, batch: orig(
        state, batch._replace(valid=torch.arange(batch.valid.numel()) < batch.valid.numel() // 2)),
    "answer_altered": lambda orig: lambda state, batch: (
        lambda out: (out[0], out[1] ^ (torch.arange(out[1].numel()).reshape(out[1].shape) == 0),
                     out[2]))(orig(state, batch)),
}


@pytest.mark.parametrize("fault", sorted(STEP_FAULTS))
def test_step_fault_is_not_correct(bench, fault, monkeypatch):
    from cassandra_accord_tpu_torch.models import conflict_graph as cg
    monkeypatch.setattr(cg, "txn_step", STEP_FAULTS[fault](cg.txn_step))
    step_cells = [w for w in cells() if w.endswith(".step")]
    assert step_cells
    assert go(bench, step_cells[0])["correct"] is False


def _window_fault(fault, monkeypatch):
    from cassandra_accord_tpu_torch.device_service import index, kernel, service
    if fault == "state_unchanged":
        orig = index.DoubleBufferedIndex.refresh

        def refresh(self, host, dirty, t_used, k_used):
            if self.front is None:
                orig(self, host, dirty, t_used, k_used)
        monkeypatch.setattr(index.DoubleBufferedIndex, "refresh", refresh)
    elif fault == "half_batch_left_out":
        orig = service.split_rows
        monkeypatch.setattr(service, "split_rows", lambda items, cap: orig(
            items[:max(1, len(items) // 2)] if len(items) > 1 else items, cap))
    else:
        orig = kernel.to_host

        def to_host(deps, max_lanes):
            d, m = orig(deps, max_lanes)
            d = d.copy()
            d[0, 0] = not d[0, 0]
            return d, m
        monkeypatch.setattr(kernel, "to_host", to_host)


@pytest.mark.parametrize("workload", [w for w in cells() if w.endswith(".windows")])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_left_out",
                                   "answer_altered"])
def test_window_fault_is_not_correct(bench, workload, fault, monkeypatch):
    _window_fault(fault, monkeypatch)
    assert go(bench, workload)["correct"] is False


NEW_METRIC = '''"""tiny.steps: steps in the window (a cell added from files alone)."""


def read(run):
    return run.counters.get("steps")
'''

NEW_DRIVER = '''"""tiny-steps: the step driver, counting the window's steps."""
from pathlib import Path

from accord_bench import named

Step = named.load(Path(__file__).resolve().parent / "step.py").Driver


class Driver(Step):
    def counters(self):
        return {"steps": float(sum(r["window"] for r in self.records))}
'''

NEW_KEYS = '''"""uniform: per_txn distinct key slots a transaction, uniform."""
import numpy as np

from accord_bench.gen import KeySets


class Keys:
    def __init__(self, cfg, seed):
        self.k, self.m = int(cfg["key_slots"]), int(cfg["keys"]["per_txn"])

    def draw(self, r, n):
        return KeySets(self.k, np.argsort(r.random((n, self.k)), axis=1)[:, :self.m])
'''


def test_cell_from_new_files_alone(tmp_path):
    """A configuration with a key distribution of its own, a traffic mix
    with a driver of its own and a per-layer metric, each a new file found
    by its name, make a new cell without an edit to any file."""
    path = tiny_bench(tmp_path)
    base = tmp_path / "accord_bench"
    cfg = json.loads((base / "configs" / "zipf-point.json").read_text())
    cfg.update(txn_slots=128, key_slots=16, keys={"dist": "uniform", "per_txn": 3})
    (base / "configs" / "tiny-point.json").write_text(json.dumps(cfg))
    (base / "keys" / "uniform.py").write_text(NEW_KEYS)
    tr = json.loads((base / "traffic" / "step.json").read_text())
    tr.update(driver="tiny-steps", batch=4, gc_every=8, gc_free=32, backlog=2)
    (base / "traffic" / "tiny-step.json").write_text(json.dumps(tr))
    (base / "drivers" / "tiny-steps.py").write_text(NEW_DRIVER)
    (base / "metrics" / "tiny.steps.py").write_text(NEW_METRIC)
    spec = json.loads(path.read_text())
    spec["configs"].append({"name": "tiny-point", "source": "a test",
                            "file": "accord_bench/configs/tiny-point.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny-point.tiny-step", "config": "tiny-point",
                              "traffic": "tiny-step", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "tiny.steps", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "a test",
                              "moves": "txns_per_s", "workloads": ["tiny-point.tiny-step"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("txns_per_s", "step_p99_ms"):
            m["workloads"].append("tiny-point.tiny-step")
    path.write_text(json.dumps(spec))
    res = go(path, "tiny-point.tiny-step", "--trace", "1")
    assert res["correct"] is True
    assert res["metrics"]["tiny.steps"]["value"] > 0
    res = go(path, "tiny-point.tiny-step")
    assert {"txns_per_s", "step_p99_ms", "setup_s"} == set(res["metrics"])


def _run_script(*args, cwd=ROOT):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=600)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", cells()[0], "--seed", "1", "--seconds", "1"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out.strip() == ""


def test_bare_checkout_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and accord_bench/ has no
    program to run: the harness exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "accord_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_script("accord_bench/run.py", "--workload", cells()[0], "--seed", "1",
                    "--seconds", "1", "--device", "cpu", cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


JAX_READER = '''"""tiny.jax: a reader that loads a module named jax."""
import jax  # noqa: F401


def read(run):
    return 1.0
'''


def test_forbidden_module_after_the_window_no_result(tmp_path):
    """A per-layer reader that loads ``jax`` once the window has closed:
    the run names it on standard error, exits non-zero and prints no
    result."""
    path = tiny_bench(tmp_path / "bench")
    (tmp_path / "bench" / "accord_bench" / "metrics" / "tiny.jax.py").write_text(JAX_READER)
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text('"""a module named jax, and nothing else"""\n')
    spec = json.loads(path.read_text())
    workload = spec["workloads"][0]["name"]
    moves = next(m["name"] for m in spec["end_to_end"]
                 if workload in m.get("workloads", []))
    spec["per_layer"].append({"name": "tiny.jax", "unit": "x", "better": "higher",
                              "source": "host_clock", "layer": "a test",
                              "moves": moves, "workloads": [workload]})
    path.write_text(json.dumps(spec))
    p = subprocess.run(
        [sys.executable, "accord_bench/run.py", "--workload", workload, "--seed", "11",
         "--seconds", "0.2", "--trace", "1", "--device", "cpu", "--bench", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(stub)})
    assert p.returncode not in (0, None)
    assert p.stdout.strip() == ""
    assert "jax" in p.stderr.strip().splitlines()[-1]


def test_imports(bench):
    """What a run loads holds no ``jax``, ``jaxlib``, ``flax`` or
    ``cassandra_accord_tpu`` (whole top-level names: the port's own name
    begins with the last); the reference and the generator load nothing of
    the port either."""
    code = ("import runpy, sys; sys.argv = ['run.py', '--workload', {w!r}, '--seed', '3', "
            "'--seconds', '0.2', '--device', 'cpu', '--bench', {b!r}]; "
            "runpy.run_path('accord_bench/run.py', run_name='__main__'); "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    for w in cells():
        p = _run_script("-c", code.format(w=w, b=str(bench)))
        assert p.returncode == 0, p.stderr[-2000:]
        loaded = set(eval(p.stdout.strip().splitlines()[-1]))
        assert not loaded & set(run.FORBIDDEN)
        assert "cassandra_accord_tpu_torch" in loaded
    p = _run_script("-c", "import sys; import accord_bench.reference, accord_bench.gen; "
                          "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not loaded & {*run.FORBIDDEN, "cassandra_accord_tpu_torch"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", cells())
def test_tiny_cell_on_the_card(bench, workload, card):
    res = run.main(["--workload", workload, "--seed", "5", "--seconds", "0.5",
                    "--bench", str(bench)])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
