"""The Maelstrom adapter on the port's device tier against the reference.

``maelstrom/`` is carried over from the reference; its nodes build their
``Node`` without a config, so the device tier is set only through the
environment (``LocalConfig.from_env``), which both packages read.  The port
is asked for the CPU with ``ACCORD_DEVICE=cpu``, which the reference
ignores.  The in-process runs are ``tests/test_maelstrom.py``'s shapes; the
stdio binary gets ``test_stdio_single_node``'s packets.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cassandra_accord_tpu.maelstrom.runner import run_workload as ref_run
from cassandra_accord_tpu_torch.maelstrom.runner import run_workload
from cassandra_accord_tpu_torch.ops import _kernels

ROOT = Path(__file__).resolve().parent.parent

# the device tier forced through the consult service
DEVICE_TIER = dict(ACCORD_RESOLVER="tpu", ACCORD_TPU_TIER="device",
                   ACCORD_TPU_WALK_MAX="0", ACCORD_TPU_WALK_WIDTH="0",
                   ACCORD_TPU_SERVICE="on")

STDIO_PACKETS = [
    {"src": "c1", "dest": "n1",
     "body": {"type": "init", "msg_id": 1, "node_id": "n1", "node_ids": ["n1"]}},
    {"src": "c1", "dest": "n1",
     "body": {"type": "txn", "msg_id": 2,
              "txn": [["append", 5, 1], ["r", 5, None]]}},
    {"src": "c1", "dest": "n1",
     "body": {"type": "txn", "msg_id": 3,
              "txn": [["append", 5, 2], ["r", 5, None]]}},
]


@pytest.mark.parametrize("seed,nodes,partitions", [(1, 3, None), (2, 5, 1.5)],
                         ids=["seed1_n3", "seed2_n5_partitions"])
def test_run_workload_on_device_tier_equals_reference(seed, nodes, partitions,
                                                      monkeypatch):
    for k, v in dict(DEVICE_TIER, ACCORD_DEVICE="cpu").items():
        monkeypatch.setenv(k, v)
    calls = {"deps_join": 0, "max_conflict": 0, "fused_consult": 0}

    def counted(name, real):
        def call(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return call
    for name in calls:
        monkeypatch.setattr(_kernels, name, counted(name,
                                                    getattr(_kernels, name)))
    want = ref_run(seed, n_nodes=nodes, ops=40, partition_interval_s=partitions)
    got = run_workload(seed, n_nodes=nodes, ops=40,
                       partition_interval_s=partitions)
    assert got == want
    assert got["ok"] == 40
    # the port's answers came from its kernel wrappers (plain versions
    # here): the service's window, both halves in one call (K12)
    assert calls["fused_consult"] > 0
    assert calls["deps_join"] == 0 and calls["max_conflict"] == 0


def _stdio(env, packets=STDIO_PACKETS,
           argv=("-m", "cassandra_accord_tpu_torch.maelstrom")):
    """The binary on ``packets`` under ``env`` (no other ACCORD_ setting of
    this process): (the process, reply bodies by in_reply_to)."""
    base = {k: v for k, v in os.environ.items() if not k.startswith("ACCORD_")}
    proc = subprocess.run(
        [sys.executable, *argv],
        input="".join(json.dumps(p) + "\n" for p in packets),
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(base, **env))
    replies = [json.loads(x) for x in proc.stdout.splitlines()
               if '"dest":"c1"' in x or '"dest": "c1"' in x]
    return proc, {r["body"].get("in_reply_to"): r["body"] for r in replies}


def test_stdio_binary_on_device_tier_answers():
    """The node binary Maelstrom execs, on the device tier on the CPU: the
    replies test_maelstrom.py::test_stdio_single_node expects.  The binary
    answers on a real-time clock that times a reply out after 1 s, so torch
    runs one CPU thread here: under a parallel test run, a pool of threads
    per op can cost more than the consults themselves."""
    proc, by_reply = _stdio(dict(DEVICE_TIER, ACCORD_DEVICE="cpu",
                                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Traceback" not in proc.stderr
    assert by_reply[1]["type"] == "init_ok"
    assert by_reply[2]["type"] == "txn_ok", by_reply[2]
    assert by_reply[2]["txn"][1] == ["r", 5, []]
    assert by_reply[3]["type"] == "txn_ok", by_reply[3]
    assert by_reply[3]["txn"][1] == ["r", 5, [1]]


def test_stdio_binary_without_cpu_request_never_answers_from_the_cpu():
    """Not asked for the CPU, on a machine without CUDA, the device tier
    raises: the binary exits non-zero or answers with an error, never
    txn_ok."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    proc, by_reply = _stdio(dict(DEVICE_TIER, OMP_NUM_THREADS="1"))
    assert not any(b.get("type") == "txn_ok" for b in by_reply.values())
    assert proc.returncode != 0 or all(
        by_reply.get(i, {}).get("type") == "error" for i in (2, 3))


# the binary run through runpy, reporting at exit which devices the cost
# model has calibrated (the device tier's warm-up)
CALIBRATED_MAIN = """
import atexit, runpy, sys
from cassandra_accord_tpu_torch.impl import tpu_resolver as R
atexit.register(lambda: print("CALIBRATED", sorted(R._CALIBRATED),
                              file=sys.stderr))
runpy.run_module("cassandra_accord_tpu_torch.maelstrom", run_name="__main__",
                 alter_sys=True)
"""


@pytest.mark.parametrize("env,calibrated", [
    ({}, "['cpu']"),
    ({"ACCORD_TPU_TIER": "host"}, "[]"),
    ({"ACCORD_TPU_SERVICE_BACKEND": "host"}, "[]")],
    ids=["device_tier", "host_tier", "host_backed_service"])
def test_stdio_binary_warms_the_device_tier_at_init(env, calibrated):
    """On ``init`` alone, before any txn, the binary pays the device tier's
    start-up (the cost model's calibration round trip); where no consult
    reaches the device it pays none.  Paid inside the first consult, that
    start-up stalled the real-time loop past the 1-s reply timeout and
    failed every txn in flight."""
    proc, by_reply = _stdio(dict(DEVICE_TIER, **env, ACCORD_DEVICE="cpu",
                                 OMP_NUM_THREADS="1"),
                            packets=STDIO_PACKETS[:1],
                            argv=("-c", CALIBRATED_MAIN))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert by_reply[1]["type"] == "init_ok"
    assert f"CALIBRATED {calibrated}" in proc.stderr.splitlines()
