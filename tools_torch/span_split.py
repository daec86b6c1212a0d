"""A traced window of a benchmark cell, split by the port's own spans.

    python3 tools_torch/span_split.py --workload zipf-point.windows --seed 7 \\
        [--seconds 10] [--device cuda|cpu] [--out build/split.json]

Runs the cell as ``accord_bench/run.py --trace 1`` does up to the end of
its profiled window (the same driver, set-up and ``Tracer``; no check of
the answers), keeps the profile's Chrome trace and reads the port's
``accord.*`` ranges (``observe/profiler.span``) beside the benchmark's
``bench.*`` ones, on the window's thread:

- ``spans``: each name's count, seconds and mean microseconds;
- ``readings``: per dispatch, the host time in ``build_batch``, the four
  uploads, the consult's wrapper and launch, the read-back and the unpack;
  per refresh, ``apply_rows`` and the rest (the host's transposes and row
  uploads); per step, the host syncs, the time waited at them, the time
  in ``txn_step`` and ``gc_step`` outside them, and the join's time on
  the [T, K] route (``accord.kernel.join_tk``);
- ``checks``: the mean ``accord.service.dispatch`` against the service's
  own ``dispatch_seconds / dispatch_count`` over the same window; the share
  of the dispatch that its four parts cover; the synchronising CUDA runtime
  calls (stream, device and event synchronises, device-to-host copies to
  pageable memory) inside ``accord.step`` and ``accord.gc``, and how many
  of them lie outside every ``accord.sync.*`` span; the join's route
  (``join_route``: ``accord.kernel.join_tk`` and ``accord.sync.query_csr``
  spans a step); the share of the device's idle time inside
  ``bench.step``, ``bench.demand`` and ``bench.refresh`` that falls inside
  an ``accord.*`` span;
- ``rows``, in a cell that runs the consult service: per dispatch in the
  window, the real rows, the padding rows of their buckets, and the
  service's own ``pad_rows_skipped`` where the checkout has it;
- ``idle_gaps``: the device's idle time summed by the innermost span open
  on the host as each gap began (``bench.*`` or ``accord.*``) and the
  outermost host op there, as ``accord_bench/trace.py``'s breakdown names
  them with ``bench.*`` spans alone.

Prints one JSON line (and writes it to ``--out``), with the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
IDLE_SPANS = ("bench.step", "bench.demand", "bench.refresh")


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _meet(xs, ys):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(iv):
    return sum(b - a for a, b in iv)


def _within(iv, t):
    """Whether ``t`` lies in one of the sorted disjoint intervals ``iv``."""
    i = bisect.bisect_right(iv, (t, float("inf"))) - 1
    return i >= 0 and iv[i][0] <= t <= iv[i][1]


class _Open:
    """Which of a set of nested host ranges is innermost at a time."""

    def __init__(self, ranges):
        # (start, end, name), an outer range before an inner one that
        # starts with it
        self.r = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [a for a, _, _ in self.r]
        self.reach, far = [], float("-inf")   # latest end up to each range
        for _, b, _ in self.r:
            far = max(far, b)
            self.reach.append(far)

    def innermost(self, t):
        """The open range that started last, or None."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.reach[i] < t:
                return None
            if self.r[i][1] >= t:
                return self.r[i][2]
        return None


def split(events, counters):
    """The readings, checks and idle gaps of one profiled window."""
    from accord_bench.trace import Trace
    trace = Trace(events)
    t0, t1, tid = trace.t0, trace.t1, trace.tid
    spans = defaultdict(list)
    runtime, cpu, dev_names = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and e.get("tid") == tid \
                and name.startswith(("accord.", "bench.")) \
                and name != "bench.window":
            spans[name].append((ts, ts + dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            runtime.append((ts, ts + dur, name, corr, e.get("tid")))
        elif cat in ("gpu_memcpy", "kernel", "gpu_memset"):
            dev_names[corr] = name
        elif cat == "cpu_op" and e.get("tid") == tid:
            cpu.append((ts, ts + dur, name))

    def secs(prefix):
        """Seconds of the spans whose names start with ``prefix``."""
        return sum(b - a for n, iv in spans.items() if n.startswith(prefix)
                   for a, b in iv) * 1e-6

    def exact(name):
        return sum(b - a for a, b in spans.get(name, ())) * 1e-6

    def count(prefix):
        return sum(len(iv) for n, iv in spans.items() if n.startswith(prefix))

    def union(prefixes):
        return _union([x for n, iv in spans.items()
                       if n.startswith(prefixes) for x in iv])

    def inside(inner, outer):
        return _length(_meet(union(inner), union(outer))) * 1e-6

    out = {"window_s": trace.window_s, "busy_s": trace.busy_s,
           "spans": {n: {"count": len(iv),
                         "seconds": sum(b - a for a, b in iv) * 1e-6,
                         "mean_us": sum(b - a for a, b in iv) / len(iv)}
                     for n, iv in sorted(spans.items())}}
    readings, checks = {}, {}
    opened = _Open([(a, b, n) for n, iv in spans.items() for a, b in iv])
    dispatches = count("accord.service.dispatch")
    if dispatches:
        parts = {"service.batch_us": "accord.service.build_batch",
                 "service.upload_us": "accord.service.upload",
                 "service.launch_us": "accord.kernel.consult",
                 "service.readback_us": "accord.kernel.to_host",
                 "service.unpack_us": "accord.service.unpack"}
        for metric, name in parts.items():
            readings[metric] = exact(name) / dispatches * 1e6
        dispatch = exact("accord.service.dispatch")
        checks["dispatch_span_us"] = dispatch / dispatches * 1e6
        if counters.get("dispatch_count"):
            checks["service.dispatch_us"] = (counters["dispatch_seconds"]
                                             / counters["dispatch_count"] * 1e6)
            checks["dispatch_span_over_counter"] = (
                checks["dispatch_span_us"] / checks["service.dispatch_us"])
        checks["dispatch_covered"] = sum(
            readings[m] for m in ("service.upload_us", "service.launch_us",
                                  "service.readback_us", "service.unpack_us")
        ) / checks["dispatch_span_us"]
    refreshes = count("accord.index.refresh")
    if refreshes:
        apply = inside("accord.index.apply_rows", "accord.index.refresh")
        readings["index.apply_us"] = apply / refreshes * 1e6
        readings["index.stage_us"] = (exact("accord.index.refresh") - apply) \
            / refreshes * 1e6
        readings["index.full_upload_us"] = exact("accord.index.full_upload") \
            / refreshes * 1e6
    steps = count("bench.step")
    if steps and spans.get("accord.step"):
        readings["step.syncs"] = count("accord.sync.") / steps
        readings["step.sync_wait_us"] = secs("accord.sync.") / steps * 1e6
        readings["step.host_us"] = (
            exact("accord.step") + exact("accord.gc")
            - inside("accord.sync.", ("accord.step", "accord.gc"))) \
            / steps * 1e6
        for phase in ("accord.step.witness", "accord.step.join",
                      "accord.step.lex_max", "accord.step.stabilise",
                      "accord.step.execute", "accord.gc"):
            readings[phase + "_us"] = exact(phase) / steps * 1e6
        readings["step.join_tk_us"] = exact("accord.kernel.join_tk") \
            / steps * 1e6
        checks["join_route"] = {
            "tk": count("accord.kernel.join_tk") / steps,
            "csr": count("accord.sync.query_csr") / steps}
        host_tid = tid if any(r[4] == tid for r in runtime) else None
        step_iv = union(("accord.step", "accord.gc"))
        sync_iv = union("accord.sync.")
        # a sync point: the innermost host op holding synchronising calls
        # (``.item()`` is a pageable copy and a stream synchronise)
        op_at = _Open([(a, b, (i, n)) for i, (a, b, n) in enumerate(cpu)])
        points, by_call = {}, defaultdict(int)
        for a, b, name, corr, rtid in runtime:
            if host_tid is not None and rtid != host_tid:
                continue
            dev = dev_names.get(corr, "")
            if not (name in SYNC_CALLS or (name.startswith("cudaMemcpy")
                                           and "DtoH" in dev
                                           and "Pageable" in dev)):
                continue
            if not _within(step_iv, a):
                continue
            by_call[name] += 1
            op = op_at.innermost(a)
            points.setdefault(op if op is not None else ("call", a),
                              (a, op[1] if op else name))
        sites = defaultdict(int)
        for a, op in points.values():
            if not _within(sync_iv, a):
                sites[f"{opened.innermost(a)} > {op}"] += 1
        checks["sync_spans"] = count("accord.sync.")
        checks["sync_points_in_step_gc"] = len(points)
        checks["sync_points_outside_sync_spans"] = sum(sites.values())
        checks["sync_sites_outside"] = dict(sites)
        checks["sync_calls_by_name"] = dict(by_call)
    busy = _union([(max(a, t0), min(b, t1)) for a, b, _, _ in trace.ops
                   if b > t0 and a < t1])
    idle, edge = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            idle.append((edge, a))
        edge = max(edge, b)
    in_bench = _meet(idle, union(IDLE_SPANS))
    checks["idle_s"] = _length(idle) * 1e-6
    checks["idle_in_bench_spans_s"] = _length(in_bench) * 1e-6
    if in_bench:
        checks["idle_in_accord_share"] = (
            _length(_meet(in_bench, union("accord."))) / _length(in_bench))
    # idle gaps by the innermost span and the outermost host op
    cpu.sort(key=lambda x: (x[0], -x[1]))
    top = []
    for a, b, name in cpu:
        if not top or a >= top[-1][1]:
            top.append((a, b, name))
    host_ops = _Open(top)
    gaps = defaultdict(float)
    for a, b in idle:
        t = a + 1e-3
        gaps[f"{opened.innermost(t) or '(between spans)'} > "
             f"{host_ops.innermost(t) or '(python)'}"] += (b - a) * 1e-6
    out["idle_gaps"] = sorted(([k, v] for k, v in gaps.items()),
                              key=lambda kv: -kv[1])[:16]
    out["readings"], out["checks"] = readings, checks
    return out


def _service_rows(svc):
    """(rows histogram, ``pad_rows_skipped`` or None) of a consult service
    now, or None without one."""
    if svc is None:
        return None
    return (dict(svc.batch_size_hist),
            getattr(svc, "pad_rows_skipped", None))


def _rows(svc, before, after):
    """Real and padding rows per dispatch between two ``_service_rows``."""
    from cassandra_accord_tpu_torch.device_service.batch import (
        ROW_BUCKET_FLOOR, pow2_bucket)
    hist = {r: n - before[0].get(r, 0) for r, n in after[0].items()}
    dispatches = sum(hist.values())
    if not dispatches:
        return None
    out = {"dispatches": dispatches,
           "real_rows": sum(r * n for r, n in hist.items()) / dispatches,
           "pad_rows": sum((pow2_bucket(r, ROW_BUCKET_FLOOR, svc.max_window)
                            - r) * n for r, n in hist.items()) / dispatches}
    if after[1] is not None:
        out["pad_rows_skipped"] = (after[1] - before[1]) / dispatches
    return out


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--bench", default=str(ROOT / "BENCHMARK.json"))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from accord_bench import named, run
    run._environment()
    c = run.load_cell(args.bench, args.workload)
    dev, device = run._device(args.device, int(c.cell["chips"]))
    import torch
    from accord_bench.trace import Tracer
    tracer = Tracer(True, dev.type)
    keys = named.load(c.keys).Keys(c.cfg, args.seed)
    driver = named.load(c.driver).Driver(c.cfg, c.traffic, args.seed, dev,
                                         tracer, keys)
    with torch.inference_mode():
        driver.setup(args.seconds)
        gc.collect()
        gc.freeze()
        svc = getattr(driver, "svc", None)
        rows0 = _service_rows(svc)
        try:
            with tracer.window():
                driver.run(args.seconds)
        finally:
            gc.unfreeze()
        rows1 = _service_rows(svc)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        tracer._prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    t = time.perf_counter()
    res = split(events, driver.counters())
    if rows0 is not None:
        res["rows"] = _rows(svc, rows0, rows1)
    res.update(workload=args.workload, seed=args.seed,
               device=dict(device, card=_card() if dev.type == "cuda"
                           else None),
               read_s=time.perf_counter() - t)
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return res


if __name__ == "__main__":
    main()
