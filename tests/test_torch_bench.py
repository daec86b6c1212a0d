"""The port's bench (``bench_torch.py``) against the reference's (``bench.py``)
on the CPU.

bench_torch.py is bench.py's twin on ``cassandra_accord_tpu_torch``: the same
stages, constants, result object and stdout tail.  Asked for the CPU
(``ACCORD_DEVICE=cpu``), its deterministic fields equal bench.py's on the
same seed and sizes, exactly: the smoke's sim block, the protocol planes'
outcomes and counters, the ramp's sim rates, the SLO stage's sim-time
percentiles and flags, and the replay's parity counts, events reached and
final index.  The reference side runs in a subprocess, because importing
bench.py sets ``ACCORD_TPU_*`` variables in ``os.environ`` (bench.py:37-39);
where its stage is a closure of ``main()`` (``protocol_slo``, ``record``),
the subprocess runs the closure's body with the same arguments.  Without
CUDA and without the CPU asked for, the twin exits non-zero before any
stage; a stage that raises, or a kill, exits non-zero with the error in the
tail; its consult stages hold every device answer against the host tier.
Every run's trend ledger is a temporary file: the repository's
``BENCH_HISTORY.jsonl`` is byte for byte the same afterwards.
"""
import ast
import hashlib
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench_torch

ROOT = Path(__file__).resolve().parent.parent
REF_PKG, PORT_PKG = "cassandra_accord_tpu", "cassandra_accord_tpu_torch"

# small sizes of the stages held against the reference (bench.py's are
# 1,200 protocol ops, ramp (8, 32, 128) at 400 ops, SLO at 5 and 15 nodes
# at 200 ops, the recording at 1,200 ops replayed at T = 4,096 and 32,768)
SIZES = dict(proto_ops=60, ramp_levels=[8], ramp_ops=40, slo_nodes=5,
             slo_ops=60, record_ops=120, replay_T=256)


def _sha(path: Path):
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else None


def _lines(stdout: str):
    return [x for x in stdout.splitlines() if x.strip()]


# ---------------------------------------------------------------------------
# the deterministic fields of each stage (also run in the reference's
# subprocess, from their source)
# ---------------------------------------------------------------------------

def _burn_fields(res, plane):
    """A protocol plane's outcome counters, sim time and stats; the device
    plane's tier-routing counters (``resolver_*``) are left out: they follow
    the cost model's timed calibration."""
    return {"ops_submitted": res.ops_submitted, "ops_ok": res.ops_ok,
            "ops_recovered": res.ops_recovered, "ops_nacked": res.ops_nacked,
            "ops_lost": res.ops_lost, "ops_failed": res.ops_failed,
            "sim_micros": res.sim_micros,
            "stats": {k: v for k, v in sorted(res.stats.items())
                      if plane == "cpu" or not k.startswith("resolver_")}}


def _ramp_fields(out):
    return {"sim_on": out["columnar_on"]["commits_per_sec_sim"],
            "sim_off": out["columnar_off"]["commits_per_sec_sim"],
            "sim_ramp_scaling": out["sim_ramp_scaling"],
            "columnar_stats": out["columnar_stats"]}


def _slo_fields(out):
    return {n: {k: v for k, v in row.items() if k != "commits_per_sec_wall"}
            for n, row in out.items()}


def _replay_fields(out):
    """Per tier: queries, answered sample, parity checks, events reached and
    the final index (no valve closes at this size)."""
    head = {k: out[k] for k in ("copies", "txn_capacity", "key_capacity",
                                "merged_events", "commits_replayed")}
    tiers = {t: {"queries": r["queries"],
                 "sampled_queries": r.get("sampled_queries"),
                 "parity_checked": r["parity_checked"],
                 "events_reached": r.get("truncated_at_event",
                                         out["merged_events"]),
                 "final_indexed": r.get("final_indexed")}
             for t, r in out["tiers"].items()}
    return dict(head, tiers=tiers)


REFERENCE = '''
import json, os, sys, time
import bench
from cassandra_accord_tpu.harness.burn import run_burn
P = json.loads(sys.argv[1])
out = {}
for plane, window in (("cpu", 0), ("tpu", bench.TPU_WINDOW_US)):
    _, res = bench.bench_protocol(plane, window, ops=P["proto_ops"], reps=1)
    out["protocol_" + plane] = _burn_fields(res, plane)
out["ramp"] = _ramp_fields(bench.bench_protocol_ramp(
    levels=tuple(P["ramp_levels"]), ops=P["ramp_ops"]))

# bench.py's protocol_slo closure (:875-924) at one size
from dataclasses import replace as _replace
from cassandra_accord_tpu.config import LocalConfig
from cassandra_accord_tpu.observe import InvariantAuditor
from cassandra_accord_tpu.observe import schema as _schema
from cassandra_accord_tpu.observe.registry import Histogram
pct = Histogram.snapshot_percentile
slo = {}
cfg = _replace(LocalConfig(), membership_interval_s=6.0)
for n_nodes in (P["slo_nodes"],):
    auditor = InvariantAuditor(mode="warn")
    t0 = time.perf_counter()
    res = run_burn(seed=bench.PROTO_SEED, ops=P["slo_ops"],
                   concurrency=bench.PROTO_CONC,
                   nodes=n_nodes, rf=5 if n_nodes >= 5 else 3,
                   chaos=True, allow_failures=True,
                   topology_churn=True, elastic_membership=True,
                   durability=True, journal=True, node_config=cfg,
                   observer=auditor, audit="warn",
                   stall_watchdog_s=300.0, max_tasks=80_000_000)
    dt = time.perf_counter() - t0
    hist = auditor.registry.histogram(_schema.LATENCY_METRIC).to_snapshot()
    verdict = res.audit or {}
    slo[f"nodes_{n_nodes}"] = {
        "ops": res.resolved, "joins": res.joins, "leaves": res.leaves,
        "commits_per_sec_wall": round(res.resolved / dt, 1) if dt else None,
        "commit_latency_us": {
            "p50": pct(hist, 0.50), "p95": pct(hist, 0.95),
            "p99": pct(hist, 0.99), "count": hist["count"],
            "mean": round(hist["total"] / hist["count"])
            if hist["count"] else None},
        "slo_flags": {"raised": verdict.get("slo_flags_raised"),
                      "open_at_quiesce": verdict.get("slo_flags_open")},
        "violations": verdict.get("violations")}
out["slo"] = _slo_fields(slo)

# bench.py's record closure (:1015-1020), then its replay (:1031-1042)
from cassandra_accord_tpu.harness.consult_trace import record_burn, scaled_replay
os.environ["ACCORD_TPU_F32_MAX"] = str(1 << 20)
rec = record_burn(seed=bench.PROTO_SEED, ops=P["record_ops"],
                  concurrency=bench.PROTO_CONC,
                  batch_window_us=bench.TPU_WINDOW_US, **bench.PROTO_KW)
out["replay"] = _replay_fields(scaled_replay(
    rec, P["replay_T"], ["walk", "host", "auto", "device"],
    parity_sample=500, walk_sample_target=300,
    tier_max_seconds={"device": 180.0, "host": 240.0, "auto": 240.0}))
print(json.dumps(out))
'''


def _reference_script():
    helpers = "\n".join(inspect.getsource(f) for f in (
        _burn_fields, _ramp_fields, _slo_fields, _replay_fields))
    return helpers + REFERENCE


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """(twin's fields, reference's fields) at SIZES: the reference in its
    subprocess while the twin runs here, asked for the CPU."""
    tmp = tmp_path_factory.mktemp("bench_stages")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               ACCORD_BENCH_HISTORY=str(tmp / "ref_history.jsonl"))
    ref = subprocess.Popen([sys.executable, "-c", _reference_script(),
                            json.dumps(SIZES)], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env,
                           cwd=ROOT)
    got = {}
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setenv("ACCORD_DEVICE", "cpu")
            m.setenv("ACCORD_BENCH_HISTORY", str(tmp / "history.jsonl"))
            # what bench.py's import sets, and what record() sets
            for k, v in bench_torch.BENCH_ENV.items():
                m.setenv(k, v)
            m.setenv("ACCORD_TPU_F32_MAX", str(1 << 20))
            for plane, window in (("cpu", 0), ("tpu", bench_torch.TPU_WINDOW_US)):
                _, res = bench_torch.bench_protocol(
                    plane, window, ops=SIZES["proto_ops"], reps=1)
                got["protocol_" + plane] = _burn_fields(res, plane)
            got["ramp"] = _ramp_fields(bench_torch.bench_protocol_ramp(
                levels=tuple(SIZES["ramp_levels"]), ops=SIZES["ramp_ops"]))
            got["slo"] = _slo_fields(bench_torch.protocol_slo(
                nodes=(SIZES["slo_nodes"],), ops=SIZES["slo_ops"]))
            rec = bench_torch.record(ops=SIZES["record_ops"])
            got["replay"] = _replay_fields(bench_torch.replay(
                rec, SIZES["replay_T"]))
        out, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    return got, json.loads(_lines(out)[-1])


@pytest.mark.parametrize("plane", ["cpu", "tpu"])
def test_protocol_plane_equals_reference(stages, plane):
    got, want = stages
    assert got[f"protocol_{plane}"]["ops_ok"] == SIZES["proto_ops"]
    assert got[f"protocol_{plane}"] == want[f"protocol_{plane}"]


def test_ramp_sim_rates_equal_reference(stages):
    got, want = stages
    assert got["ramp"]["sim_on"] and got["ramp"]["sim_on"][0] > 0
    assert got["ramp"] == want["ramp"]


def test_slo_percentiles_and_flags_equal_reference(stages):
    got, want = stages
    row = got["slo"][f"nodes_{SIZES['slo_nodes']}"]
    assert row["commit_latency_us"]["count"] > 0
    assert got["slo"] == want["slo"]


def test_replay_counts_equal_reference(stages):
    got, want = stages
    tiers = got["replay"]["tiers"]
    assert set(tiers) == {"walk", "host", "auto", "device"}
    assert all(t["parity_checked"] > 0 for n, t in tiers.items()
               if n != "walk")
    assert got["replay"] == want["replay"]


# ---------------------------------------------------------------------------
# --smoke: the tail contract, the sim block, the ledger
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smokes(tmp_path_factory):
    """bench_torch.py --smoke (CPU asked for) and bench.py --smoke, run side
    by side, each with its own temporary ledger."""
    tmp = tmp_path_factory.mktemp("bench_smoke")
    kept = _sha(ROOT / "BENCH_HISTORY.jsonl")
    procs = {}
    for name, script, extra in (("twin", "bench_torch.py",
                                 {"ACCORD_DEVICE": "cpu"}),
                                ("ref", "bench.py", {})):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   ACCORD_BENCH_DEADLINE_S="150",
                   ACCORD_BENCH_HISTORY=str(tmp / f"{name}.jsonl"), **extra)
        env.pop("ACCORD_PERFGATE_INJECT_LATENCY", None)
        procs[name] = subprocess.Popen(
            [sys.executable, script, "--smoke"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    done = {}
    for name, p in procs.items():
        out, err = p.communicate(timeout=200)
        done[name] = (p.returncode, out, err, tmp / f"{name}.jsonl")
    return done, kept


def test_smoke_tail_is_one_json_object_and_sim_equals_reference(smokes):
    done, kept = smokes
    rc, out, err, ledger = done["twin"]
    assert rc == 0, err[-2000:]
    lines = _lines(out)
    tail = json.loads(lines[-1])
    assert isinstance(tail, dict) and len(lines[-1]) < 4096
    assert tail["stages"] == {"smoke": "ok"} and tail["incomplete"] is False
    assert tail["metric"] == "smoke_commit_latency_mean_us"
    assert tail["device"]["name"] == "cpu"
    full = json.loads(lines[-2])
    ref_rc, ref_out, ref_err, _ = done["ref"]
    assert ref_rc == 0, ref_err[-2000:]
    want = json.loads(_lines(ref_out)[-2])["detail"]["smoke"]["sim"]
    assert full["detail"]["smoke"]["sim"] == want
    records = [json.loads(x) for x in ledger.read_text().splitlines()]
    assert len(records) == 1 and records[0]["kind"] == "bench"
    assert records[0]["sim"] == want
    assert _sha(ROOT / "BENCH_HISTORY.jsonl") == kept


def test_without_cuda_exits_before_any_stage(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    env = dict(os.environ, ACCORD_BENCH_HISTORY=str(tmp_path / "h.jsonl"))
    env.pop("ACCORD_DEVICE", None)
    proc = subprocess.run([sys.executable, "bench_torch.py", "--smoke"],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=ROOT)
    assert proc.returncode != 0
    tail = json.loads(_lines(proc.stdout)[-1])
    assert tail["stages"] == {}
    assert "CUDA is not available" in tail["errors"]["run"]


# ---------------------------------------------------------------------------
# fail closed: a stage error, a kill
# ---------------------------------------------------------------------------

@pytest.fixture
def cpu_run(monkeypatch, tmp_path):
    monkeypatch.setenv("ACCORD_DEVICE", "cpu")
    monkeypatch.setenv("ACCORD_BENCH_HISTORY", str(tmp_path / "h.jsonl"))
    monkeypatch.delenv("ACCORD_PERFGATE_INJECT_LATENCY", raising=False)


def test_smoke_stage_error_exits_nonzero_with_error_in_tail(
        cpu_run, monkeypatch, capsys):
    from tools_torch import perfgate

    def broken():
        raise RuntimeError("smoke broke")
    monkeypatch.setattr(perfgate, "measure_smoke", broken)
    assert bench_torch.smoke_main() != 0
    tail = json.loads(_lines(capsys.readouterr().out)[-1])
    assert tail["stages"] == {"smoke": "error"} and tail["incomplete"] is True
    assert "smoke broke" in tail["errors"]["smoke"]


STAGE_FNS = ("proto", "bench_protocol_ramp", "protocol_slo", "workload_slo",
             "overload", "frontier", "bench_deps_graph", "record", "replay",
             "consult_service_stage", "kernels", "bench_graph")
STAGES = ["protocol", "protocol_ramp", "protocol_slo", "workload_slo",
          "overload", "frontier_exec", "deps_graph", "record_burn",
          "replay_T4096", "replay_T32768", "consult_service",
          "kernel_scaling", "graph_kernels"]


@pytest.mark.parametrize("case", ["stage_raises", "deadline"])
def test_full_run_fails_closed_and_skips_at_the_deadline(
        cpu_run, monkeypatch, capsys, case):
    """Every stage stubbed: one raising fails the run (rc != 0) while the
    others still run; at the deadline every stage is skipped, as bench.py
    skips, and the tail says incomplete."""
    for fn in STAGE_FNS:
        monkeypatch.setattr(bench_torch, fn, lambda *a, **k: {"stub": True})

    def broken():
        raise ValueError("overload broke")
    monkeypatch.setattr(bench_torch, "overload", broken)
    run = bench_torch.Run(deadline_s=5 if case == "deadline" else 600)
    rc = bench_torch.main(run)
    tail = json.loads(_lines(capsys.readouterr().out)[-1])
    if case == "deadline":
        assert rc == 0
        assert tail["stages"] == {s: "skipped" for s in STAGES
                                  if not s.startswith("replay")}
        assert tail["incomplete"] is True
        return
    assert rc != 0
    assert list(tail["stages"]) == STAGES
    assert {s for s, v in tail["stages"].items() if v != "ok"} == {"overload"}
    assert "overload broke" in tail["errors"]["overload"]
    assert tail["incomplete"] is False


def test_kill_prints_the_tail_and_exits_nonzero(tmp_path):
    code = ("import os, signal, time, bench_torch\n"
            "run = bench_torch.Run()\n"
            "with bench_torch._Alarm(run, 60):\n"
            "    os.kill(os.getpid(), signal.SIGTERM)\n"
            "    time.sleep(30)\n")
    env = dict(os.environ, ACCORD_BENCH_HISTORY=str(tmp_path / "h.jsonl"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60, env=env, cwd=ROOT)
    assert proc.returncode != 0
    tail = json.loads(_lines(proc.stdout)[-1])
    assert tail["killed_by"] == "SIGTERM" and tail["incomplete"] is True


# ---------------------------------------------------------------------------
# the consult stages hold every device answer against the host tier
# ---------------------------------------------------------------------------

CONSULT_CASES = {
    "kernel": lambda: bench_torch.bench_kernel(256, k=16, b=32, iters=3),
    "kernel_packed": lambda: bench_torch.bench_kernel(256, k=16, b=32,
                                                      iters=3, packed=True),
    "service": lambda: bench_torch.bench_service(256, k=16),
}


@pytest.mark.parametrize("case", sorted(CONSULT_CASES))
def test_consult_stage_answers_equal_host_tier(cpu_run, case):
    out = CONSULT_CASES[case]()
    assert out["T"] == 256 and out["K"] == 16
    assert out["answers_checked"] >= 96


@pytest.mark.parametrize("case", sorted(CONSULT_CASES))
def test_consult_stage_fails_on_a_wrong_answer(cpu_run, monkeypatch, case):
    real = bench_torch.make_host_tier

    def flipped(*args):
        tier = real(*args)

        def answer(q, before, kind):
            deps, max_lanes = tier(q, before, kind)
            deps = deps.copy()
            deps[-1, 0] = not deps[-1, 0]
            return deps, max_lanes
        return answer
    monkeypatch.setattr(bench_torch, "make_host_tier", flipped)
    with pytest.raises(bench_torch.AnswerMismatch):
        CONSULT_CASES[case]()


def test_graph_stage_answers_equal_edge_twins(cpu_run):
    out = bench_torch.bench_graph(t=128, iters=1)
    assert set(out) >= {"closure", "scc_condense", "kahn_frontier"}


# ---------------------------------------------------------------------------
# imports and environment
# ---------------------------------------------------------------------------

def test_imports_neither_jax_nor_reference_nor_reference_tools():
    tree = ast.parse((ROOT / "bench_torch.py").read_text())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
        elif isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", REF_PKG)]
    assert not [m for m in mods if m in ("tools.perfgate", "tools.explain")]
    assert {m for m in mods if m.split(".")[0] == "tools"} == {"tools.trend"}
    assert any(m.startswith(PORT_PKG) for m in mods)


def test_import_leaves_the_environment_alone():
    code = ("import os, json; before = dict(os.environ); import bench_torch; "
            "print(json.dumps(dict(os.environ) == before))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(_lines(proc.stdout)[-1]) is True
