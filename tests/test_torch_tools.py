"""The port's tools (``tools_torch/``) against the reference's (``tools/``),
and the burn CLI's fault matrix through the port's device tier on the CPU.

``tools_torch/perfgate.py`` and ``tools_torch/explain.py`` are the
reference's files with their imports pointed at ``cassandra_accord_tpu_torch``:
their ASTs, without docstrings and with the package renamed in the imports,
are equal.  The gate's smoke metrics are deterministic sim-time numbers, so
the port's equal the reference's; the gate passes on the tree and trips on
the injected 2x latency; explain exits 0 on identical dumps and 3 on a
divergent one, its last stdout line one JSON object.  No test here writes
``BASELINE.json`` or the repository's ``BENCH_HISTORY.jsonl``: trend
appends go to a temporary file through ``ACCORD_BENCH_HISTORY``.
"""
import ast
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import pytest

from cassandra_accord_tpu.harness import burn as ref_burn
from cassandra_accord_tpu_torch.harness import burn as port_burn
from cassandra_accord_tpu_torch.harness.burn import run_burn
from cassandra_accord_tpu_torch.observe import ProvenanceRecorder
from tools import perfgate as ref_perfgate
from tools_torch import perfgate

ROOT = Path(__file__).resolve().parent.parent
TWINS = ("perfgate.py", "explain.py")
REF_PKG, PORT_PKG = "cassandra_accord_tpu", "cassandra_accord_tpu_torch"

# the device tier forced through the consult service, asked for the CPU
DEVICE_TIER = dict(ACCORD_DEVICE="cpu", ACCORD_RESOLVER="tpu",
                   ACCORD_TPU_TIER="device", ACCORD_TPU_WALK_MAX="0",
                   ACCORD_TPU_WALK_WIDTH="0", ACCORD_TPU_SERVICE="on",
                   ACCORD_TPU_SERVICE_BACKEND="torch")


def _sha(path: Path):
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else None


@pytest.fixture
def history(monkeypatch, tmp_path):
    """Trend appends go to a temporary ledger; the repository's ledger and
    baseline are byte for byte the same after the test."""
    path = tmp_path / "history.jsonl"
    monkeypatch.setenv("ACCORD_BENCH_HISTORY", str(path))
    monkeypatch.delenv("ACCORD_PERFGATE_INJECT_LATENCY", raising=False)
    kept = {p: _sha(ROOT / p) for p in ("BENCH_HISTORY.jsonl",
                                        "BASELINE.json")}
    yield path
    assert {p: _sha(ROOT / p) for p in kept} == kept


# ---------------------------------------------------------------------------
# the twins are the reference's code
# ---------------------------------------------------------------------------

def _strip_docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _code(path: Path, rename: bool):
    """(AST dump with imports masked, the imported module names); with
    ``rename`` the reference package's name in them becomes the port's."""
    tree = _strip_docstrings(ast.parse(path.read_text()))
    imports = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if rename and mod.split(".")[0] == REF_PKG:
                mod = PORT_PKG + mod[len(REF_PKG):]
            imports.append((mod, tuple(a.name for a in node.names)))
            node.module, node.names = "<import>", []
        elif isinstance(node, ast.Import):
            imports.append((None, tuple(a.name for a in node.names)))
            node.names = []
    return ast.dump(tree), imports


@pytest.mark.parametrize("name", TWINS)
def test_twin_is_reference_code_with_port_imports(name):
    got, got_imports = _code(ROOT / "tools_torch" / name, rename=False)
    want, want_imports = _code(ROOT / "tools" / name, rename=True)
    assert got == want, f"tools_torch/{name} differs beyond its imports"
    assert got_imports == want_imports


@pytest.mark.parametrize("name", TWINS + ("__init__.py",))
def test_twin_imports_neither_jax_nor_reference_nor_other_tools(name):
    _, imports = _code(ROOT / "tools_torch" / name, rename=False)
    mods = [m for m, _ in imports if m] + \
        [n for m, names in imports if m is None for n in names]
    assert all(m.split(".")[0] not in ("jax", "jaxlib", REF_PKG)
               for m in mods), mods
    assert all(m == "tools.trend" for m in mods if m.split(".")[0] == "tools")


# ---------------------------------------------------------------------------
# perfgate
# ---------------------------------------------------------------------------

def test_smoke_sim_equals_reference(history):
    """The fixed-seed smoke's gated sim metrics equal the reference's (the
    port's host plane is the reference's code)."""
    got = perfgate.measure_smoke()
    want = ref_perfgate.measure_smoke()
    assert got["sim"] == want["sim"]
    assert got["workload"] == want["workload"]
    assert got["sim"]["commits"] > 0


def test_gate_passes_on_tree_and_appends_only_to_temp_ledger(history):
    """``tools_torch/perfgate.py --gate`` as a script in a process where
    the reference package and JAX cannot be imported: rc 0, one ledger
    record, and it went to the temporary path."""
    block = ("import runpy, sys; "
             "sys.modules.update(jax=None, jaxlib=None, "
             "cassandra_accord_tpu=None); "
             "sys.argv = ['perfgate.py', '--gate']; "
             "runpy.run_path('tools_torch/perfgate.py', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", block], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "perfgate: PASS" in proc.stdout
    records = [json.loads(x) for x in history.read_text().splitlines()]
    assert len(records) == 1 and records[0]["kind"] == "perfgate"
    assert records[0]["seeds"] == [perfgate.SMOKE_SEED]


def test_gate_trips_on_injected_latency(history, monkeypatch, capsys):
    monkeypatch.setenv("ACCORD_PERFGATE_INJECT_LATENCY", "2.0")
    assert perfgate.run(gate=True) == perfgate.EXIT_REGRESSION
    assert "REGRESSION" in capsys.readouterr().out
    assert not history.exists()        # a doctored run is never recorded


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------

def _explain(*argv):
    """tools_torch/explain.py as a script, JAX and the reference package
    unimportable: (exit code, stdout lines)."""
    block = ("import runpy, sys; "
             "sys.modules.update(jax=None, jaxlib=None, "
             "cassandra_accord_tpu=None); "
             f"sys.argv = ['explain.py', *{list(argv)!r}]; "
             "runpy.run_path('tools_torch/explain.py', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", block], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    return proc.returncode, [x for x in proc.stdout.splitlines() if x.strip()]


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Two same-seed port burns' provenance dumps, and a copy of the first
    with one event's message changed halfway through."""
    tmp = tmp_path_factory.mktemp("prov")
    paths = []
    for name in ("a", "b"):
        prov = ProvenanceRecorder()
        run_burn(3, ops=30, concurrency=8, nodes=3, rf=3, key_count=4,
                 provenance=prov)
        paths.append(tmp / f"{name}.json")
        prov.save(str(paths[-1]))
    doc = json.loads(paths[0].read_text())
    events = doc["events"]
    i = next(i for i in range(len(events) // 2, len(events))
             if events[i][1] == "msg")
    events[i][-1] = str(events[i][-1]) + " (injected)"
    paths.append(tmp / "c.json")
    paths[-1].write_text(json.dumps(doc))
    return [str(p) for p in paths]


def test_explain_identical_dumps_exit_zero(dumps):
    rc, lines = _explain(dumps[0], dumps[1])
    assert rc == 0, lines[-5:]
    tail = json.loads(lines[-1])
    assert tail["identical"] is True
    assert tail["events_a"] == tail["events_b"] > 0


def test_explain_injected_divergence_exit_three(dumps):
    rc, lines = _explain(dumps[0], dumps[2])
    assert rc == 3, lines[-5:]
    tail = json.loads(lines[-1])
    assert tail["identical"] is False and isinstance(tail["index"], int)
    assert len(lines[-1]) < 4096


# ---------------------------------------------------------------------------
# the burn CLI's fault matrix through the device tier
# ---------------------------------------------------------------------------

def _cli(module, tmp_path, monkeypatch, env, tag):
    out = tmp_path / f"{tag}.json"
    with monkeypatch.context() as mp:
        for var, value in env.items():
            mp.setenv(var, value)
        module.main(["--seeds", "0", "--ops", "60", "--audit=strict",
                     "--json", str(out)])
    return json.loads(out.read_text())["results"][0]


OUTCOME = ("status", "rf", "resolved", "ok", "recovered", "nacked", "lost",
           "failed", "shed", "sim_ms", "faults")


def test_fault_matrix_seed_through_device_tier_equals_reference_cli(
        tmp_path, monkeypatch):
    """One seed of the full fault matrix (chaos, churn, crash-restart,
    pause, disk stall, journal corruption on their default cadences) with
    the strict auditor: the port's CLI with the device tier forced gives
    the reference CLI's outcome, audit verdict and cluster metrics (the
    resolver's tier counters aside)."""
    got = _cli(port_burn, tmp_path, monkeypatch, DEVICE_TIER, "port")
    want = _cli(ref_burn, tmp_path, monkeypatch, {}, "ref")
    assert {k: got[k] for k in OUTCOME} == {k: want[k] for k in OUTCOME}
    assert got["status"] == "pass" and got["audit"]["violations"] == 0
    assert got["audit"] == want["audit"]
    assert got["metrics"]["resolver.device_consults"] > 0

    def cluster(m):
        return {k: v for k, v in m.items() if not k.startswith("resolver.")}
    assert cluster(got["metrics"]) == cluster(want["metrics"])
