"""Same-seed burns through both packages: equal traces, equal outcomes.

One kwargs dict configures both ``LocalConfig``s (the port reads the
``tpu_*`` fields as "device tier"); the port is asked for the CPU through
``ACCORD_DEVICE=cpu``, which the reference ignores.  A trace event holds
only class names and txn-id strings (harness/trace.py), so traces from the
two packages compare directly with ``diff_traces``.
"""
import pytest

from cassandra_accord_tpu.config import LocalConfig as RefConfig
from cassandra_accord_tpu.harness.burn import run_burn as ref_run_burn
from cassandra_accord_tpu.harness.trace import Trace as RefTrace
from cassandra_accord_tpu.harness.trace import diff_traces

from cassandra_accord_tpu_torch.config import LocalConfig
from cassandra_accord_tpu_torch.harness.burn import run_burn
from cassandra_accord_tpu_torch.harness.trace import Trace
from cassandra_accord_tpu_torch.ops import frontier_kernels as fk

DEVICE = dict(resolver_kind="tpu", tpu_tier="device", tpu_walk_max=0,
              tpu_walk_width=0)
BENIGN = dict(ops=30, concurrency=6, durability=True)
HOSTILE = dict(ops=40, concurrency=8, chaos=True, allow_failures=True,
               durability=True, journal=True, max_tasks=3_000_000)

CASES = {
    # (a) host resolver, benign
    "cpu_benign": (5, dict(resolver="cpu", **BENIGN), {}),
    # (b) device tier forced through the service, benign
    "device_benign": (21, dict(resolver="tpu", batch_window_us=5000, **BENIGN),
                      dict(DEVICE, tpu_service="on")),
    # (c) the same, hostile network
    "device_hostile": (3, dict(resolver="tpu", batch_window_us=5000,
                               **HOSTILE), dict(DEVICE, tpu_service="on")),
    # (d) frontier-driven execution, hostile, strict audit
    "frontier_hostile_strict": (
        303, dict(resolver="tpu", batch_window_us=5000, frontier_exec=True,
                  audit="strict", delayed_stores=True, **HOSTILE),
        dict(DEVICE, tpu_service="on")),
    # (e) the verify resolver: every answer checked against the cfk walk,
    # frontier parity every 0.7 sim-s; bench.py's replay recording shape
    "verify_frontier": (
        7, dict(resolver="verify", ops=40, concurrency=64, nodes=3, rf=3,
                key_count=6, num_shards=1, durability=True,
                batch_window_us=5000, frontier_exec=True),
        dict(DEVICE, resolver_kind="verify", tpu_service="on")),
}

OUTCOME = ("ops_ok", "ops_recovered", "ops_nacked", "ops_lost", "ops_failed",
           "sim_micros")


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_seed_burn_equals_reference(case, monkeypatch):
    monkeypatch.setenv("ACCORD_DEVICE", "cpu")
    seed, burn_kw, cfg_kw = CASES[case]
    frontier_calls = []
    real_frontier = fk.frontier_ready_from_edges

    def counted_frontier(*args, **kwargs):
        frontier_calls.append(kwargs.get("device"))
        return real_frontier(*args, **kwargs)
    monkeypatch.setattr(fk, "frontier_ready_from_edges", counted_frontier)
    ref_trace, port_trace = RefTrace(), Trace()
    ref = ref_run_burn(seed, tracer=ref_trace.hook,
                       node_config=RefConfig.from_env(**cfg_kw), **burn_kw)
    port = run_burn(seed, tracer=port_trace.hook,
                    node_config=LocalConfig.from_env(**cfg_kw), **burn_kw)
    divergence = diff_traces(ref_trace, port_trace)
    assert divergence is None, f"port diverged from the reference:\n{divergence}"
    assert [getattr(port, f) for f in OUTCOME] == \
        [getattr(ref, f) for f in OUTCOME]
    assert port.resolved == burn_kw["ops"]
    if cfg_kw:
        assert port.stats.get("resolver_device_consults", 0) > 0
        assert {k: v for k, v in port.stats.items()
                if k.startswith("resolver_")} == \
            {k: v for k, v in ref.stats.items() if k.startswith("resolver_")}
    if burn_kw.get("frontier_exec"):
        # the port's release frontier ran, on the device it was asked for
        assert frontier_calls and set(map(str, frontier_calls)) == {"cpu"}
    if burn_kw.get("audit") == "strict":
        assert port.audit is not None and port.audit["violations"] == 0
        assert ref.audit["violations"] == 0
