"""One run of one cell of the benchmark of cassandra_accord_tpu_torch.

    python3 accord_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up in ``BENCHMARK.json`` (``--bench``; by default the
one at the root of the checkout).  Everything else is found by name in
``accord_bench/`` beside that file: the configuration
``configs/<config>.json`` and its key distribution ``keys/<dist>.py``, the
traffic mix ``traffic/<traffic>.json`` and the code that drives the port
for it, ``drivers/<driver>.py``, and each per-layer metric's reader
``metrics/<name>.py``.

The run makes the store and the traffic from the seed, warms up (that and
everything before it is ``setup_s``), measures for ``--seconds``, reads the
device's peak memory, frees the program's state, and replays every event
through the plain reference (``reference.py``) to decide ``correct``.  The
last line of standard output is the result; the last lines of standard error
are the numbers compared, each beside its limit.  ``--trace 1`` profiles a
window of at most ``TRACE_SECONDS`` and reports the per-layer metrics
instead of the end-to-end ones.

The card is the only device a run takes unless ``--device cpu`` asks for
the CPU (tests, at the tiny sizes of their own configurations): with no card
a run exits non-zero and prints no result.  ``--control stale`` judges the
reference's one-step-stale answers in place of the program's (the check's
control; never part of a measured run).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cassandra_accord_tpu")
# a traced run profiles at most this much of the window: the profile of a
# longer one takes minutes to write out and read back
TRACE_SECONDS = 10.0


def _environment() -> None:
    """Few host threads, and every build or kernel cache at a fixed path
    inside the checkout."""
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "4"
    cache = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--bench", default=str(ROOT / "BENCHMARK.json"))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--control", choices=("stale",), default=None)
    return p.parse_args(argv)


def load_cell(bench_path: str, workload: str) -> SimpleNamespace:
    """The cell, its configuration, its traffic and its metrics, found by
    name in the files beside ``bench_path``."""
    bench_path = Path(bench_path).resolve()
    spec = json.loads(bench_path.read_text())
    base = bench_path.parent / "accord_bench"
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_path}")
    cell = cells[workload]
    cfg = json.loads((base / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text())

    def here(metric):
        return workload in metric.get("workloads", [workload])
    return SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic,
        keys=base / "keys" / f"{cfg['keys']['dist']}.py",
        driver=base / "drivers" / f"{traffic['driver']}.py",
        end_to_end=[m for m in spec["end_to_end"] if here(m)],
        per_layer=[dict(m, path=base / "metrics" / f"{m['name']}.py")
                   for m in spec["per_layer"] if here(m)])


def _device(name: str, chips: int):
    import torch
    if name == "cpu":
        return torch.device("cpu"), {"platform": "cpu", "kind": "cpu", "count": 1}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise SystemExit(f"this cell needs {chips} CUDA device(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                         " (ask for --device cpu to run on the CPU)")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev, {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                 "count": chips}


def _report_build() -> None:
    """The kernel library's build, when this run made it (the first run in
    a checkout): its seconds count in that run's set-up only."""
    from cassandra_accord_tpu_torch.ops import _kernels
    if _kernels.BUILD_INFO.get("seconds"):
        print(f"kernel library built in {_kernels.BUILD_INFO['seconds']} s",
              file=sys.stderr)


def _forbidden_loaded():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> dict:
    _environment()
    args = _args(argv)
    c = load_cell(args.bench, args.workload)
    dev, device = _device(args.device, int(c.cell["chips"]))
    import torch
    from accord_bench import named
    from accord_bench.trace import Tracer
    tracer = Tracer(bool(args.trace), dev.type)
    keys = named.load(c.keys).Keys(c.cfg, args.seed)
    driver = named.load(c.driver).Driver(c.cfg, c.traffic, args.seed, dev, tracer,
                                         keys)
    seconds = min(args.seconds, TRACE_SECONDS) if args.trace else args.seconds
    with torch.inference_mode():
        driver.setup(seconds)
        # the set-up's objects leave the collector's passes; the window's own
        # garbage (the service's windows hold their futures in cycles, and
        # their index snapshots with them) is collected as the program makes it
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - T_START
        _report_build()
        t_window = time.perf_counter()
        try:
            with tracer.window():
                driver.run(seconds)
        finally:
            gc.unfreeze()
        t_check = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            device["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        else:
            device["memory_peak_bytes"] = 0
        e2e = dict(driver.end_to_end(), setup_s=setup_s)
        driver.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks = driver.check(stale=args.control == "stale")
    print(f"setup {setup_s} s, window {t_check - t_window} s, "
          f"check {time.perf_counter() - t_check} s", file=sys.stderr)
    ctx = SimpleNamespace(cfg=c.cfg, traffic=c.traffic, records=driver.records,
                          counters=driver.counters(), trace=None)
    metrics = {}
    if args.trace:
        trace = ctx.trace = tracer.read()
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        for m in c.per_layer:
            value = named.load(m["path"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in c.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    failed = checks.get("unanswered", {}).get("value", 0)
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    result = {"correct": correct, "attempted": driver.attempted(),
              "failed": failed, "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = trace.breakdown()
    result["checks"] = checks
    # last, after every reader and the breakdown: what the whole run loaded
    bad = _forbidden_loaded()
    if bad:
        print(f"modules loaded that the benchmark may not load: {bad}",
              file=sys.stderr)
        raise SystemExit(3)
    for name, v in checks.items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
