"""The service's consult window, this checkout against an earlier one, in
turns on one card: host time per dispatched window and the cost model's
calibrated threshold.

    python3 tools_torch/window_compare.py build/parent

``build/parent`` holds the earlier checkout (``git archive <commit>``
unpacked there).  Each turn (parent, tree, tree, parent) is a fresh Python
process run from one checkout's root, so each imports its own package and
builds its own kernels.  A turn:

- calibrates the cost model's threshold ``calibrations`` times afresh
  (``impl/tpu_resolver.py::_calibrate_threshold``: one timed consult round
  trip times the host tier's element rate);
- runs the seed-7 300-op burn (``chip_smoke.BURN_KW``) with the device tier
  forced through the consult service on the card, and reads every
  service's own ``dispatch_seconds / dispatch_count``: the mean host time
  of one window's dispatch (upload, launches, read-back, unpack), and of
  it the host time in ``ragged_consult_t`` (checks, allocation, launches)
  and, where the checkout has it, in ``to_host`` (the wait for the
  kernels, the copy and the sync; the parent reads back inside the
  dispatch itself);
- replays the 6-key recording (``chip_smoke.REPLAY``'s) at T = 4,096
  through the device tier alone, under a ``valve_s`` valve, and reads the
  same.

One JSON line per turn, then the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CALIBRATIONS = 3
VALVE_S = 60.0

TURN = r"""
import json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from cassandra_accord_tpu_torch.config import LocalConfig
from cassandra_accord_tpu_torch.harness.burn import run_burn
from cassandra_accord_tpu_torch.harness.consult_trace import (record_burn,
                                                              scaled_replay)
from cassandra_accord_tpu_torch.device_service import kernel as kmod
from cassandra_accord_tpu_torch.impl import tpu_resolver as tr

spent = {"consult": 0.0, "to_host": 0.0}


def timed(name, fn):
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        spent[name] += time.perf_counter() - t0
        return out
    return call


kmod.ragged_consult_t = timed("consult", kmod.ragged_consult_t)
if hasattr(kmod, "to_host"):
    kmod.to_host = timed("to_host", kmod.to_host)
made = []
init = tr.TpuDepsResolver.__init__


def track(self, *args, **kwargs):
    init(self, *args, **kwargs)
    made.append(self)


tr.TpuDepsResolver.__init__ = track


def windows():
    svcs = [r._service_obj for r in made
            if getattr(r, "_service_obj", None) is not None]
    n = sum(s.dispatch_count for s in svcs)
    sec = sum(s.dispatch_seconds for s in svcs)
    made.clear()
    out = {"windows": n, "dispatch_s": sec,
           "mean_dispatch_us": sec / n * 1e6 if n else None}
    for name in spent:
        out[f"mean_{name}_us"] = spent[name] / n * 1e6 if n else None
        spent[name] = 0.0
    return out


out = {"checkout": sys.argv[1], "thresholds": []}
for _ in range(int(sys.argv[2])):
    tr._CALIBRATED.clear()
    out["thresholds"].append(tr._calibrate_threshold(torch.device("cuda")))
for name in spent:
    spent[name] = 0.0
cfg = LocalConfig.from_env(resolver_kind="tpu", tpu_tier="device",
                           tpu_walk_max=0, tpu_walk_width=0, device="cuda",
                           tpu_service="on", tpu_service_backend="torch")
made.clear()
t0 = time.perf_counter()
res = run_burn(node_config=cfg, **cs.BURN_KW)
out["burn"] = dict(windows(), ops_ok=res.ops_ok,
                   wall_s=time.perf_counter() - t0)
rec = record_burn(key_count=6, **cs.REPLAY["record"])
made.clear()
r = scaled_replay(rec, 4096, ["device"], parity_sample=5,
                  walk_sample_target=300,
                  tier_max_seconds={"device": float(sys.argv[3])})
dev = r["tiers"]["device"]
out["replay6_T4096_device"] = dict(
    windows(), queries=dev.get("queries"),
    truncated_at_event=dev.get("truncated_at_event"))
print("TURN " + json.dumps(out), flush=True)
"""


def turn(checkout: Path, env: dict) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", TURN, str(checkout), str(CALIBRATIONS),
         str(VALVE_S)], cwd=checkout, env=env, capture_output=True,
        text=True, timeout=900)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("TURN ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"turn in {checkout} exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][5:])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(argv[0]).resolve()
    if not (parent / "cassandra_accord_tpu_torch").is_dir():
        print(f"window_compare: no checkout at {parent}", file=sys.stderr)
        return 2
    # the replay's walk threshold as chip_smoke.py's replay phase sets it
    env = dict(os.environ, ACCORD_DEVICE="cuda",
               ACCORD_TPU_WALK_MAX=cs.REPLAY["walk_max"])
    for checkout in (parent, ROOT, ROOT, parent):
        print(json.dumps(turn(checkout, env)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
