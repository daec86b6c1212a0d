"""perfgate — the commit-latency regression gate, run on the PyTorch port.

The twin of ``tools/perfgate.py`` with its imports pointed at
``cassandra_accord_tpu_torch``; the code is the same (a test holds the two
equal, imports aside).  It measures the same small FIXED-SEED smoke
workload through the port's simulated cluster with the flight recorder +
critical-path extractor attached, then compares the result against the
repository's ``BASELINE.json`` ``gate`` block and, informationally, against
the latest ``BENCH_r0*.json`` headline.  The gate block is the reference's
(``tools/perfgate.py --write-baseline`` records it); the port's sim
numbers equal it, so the twin's ``--write-baseline`` would write the same
block.  Prints per-metric deltas; in ``--gate`` mode exits nonzero
(``EXIT_REGRESSION``) when any GATED metric regresses past its threshold.

What is gated vs merely printed:

- **Gated: sim-time metrics.**  Simulated commit latency (mean/p95), total
  sim duration, the message volume and the execute-wait share of the
  fixed-seed workload are deterministic; the port's host plane is the
  reference's code, so they equal the reference's numbers, also with the
  device tier forced (``ACCORD_RESOLVER=tpu ACCORD_TPU_TIER=device ...``):
  the device answers what the host would.
- **Printed only: wall-clock metrics.**  commits/s, handler CPU, event-loop
  occupancy differ per machine and are never gated.

Self-test hook: ``ACCORD_PERFGATE_INJECT_LATENCY=<float>`` multiplies the
measured sim latencies before comparison (``tests/test_torch_tools.py``
uses 2.0 to prove the gate trips on a 2x regression).  A measurement is
appended to the trend ledger (``tools/trend.py``); point
``ACCORD_BENCH_HISTORY`` at another file to keep the repository's
``BENCH_HISTORY.jsonl`` as it is.

Usage:
    python tools_torch/perfgate.py --smoke      # measure + print deltas, rc 0
    python tools_torch/perfgate.py --gate       # ... rc 3 past thresholds
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

BASELINE_PATH = os.path.join(_REPO_ROOT, "BASELINE.json")

EXIT_REGRESSION = 3

# the fixed smoke workload: deterministic, seconds-class, contended enough
# that commit latency moves when the protocol's round structure changes
SMOKE_SEED = 7
SMOKE_KW = dict(ops=120, concurrency=16, nodes=3, rf=3, key_count=6,
                durability=True, journal=True)

# gated sim-time metrics: (key in summary["sim"], regression threshold as a
# current/baseline ratio).  Latency thresholds are deliberately loose (1.5x)
# — the gate is for "someone made commits take another round trip", not for
# one-bucket jitter; sim metrics have NO run-to-run noise, so anything past
# the threshold is a real behavior change.
GATED_METRICS = (
    ("commit_latency_mean_us", 1.5),
    ("commit_latency_p95_us", 1.5),
    ("sim_ms", 1.5),
    ("messages", 1.5),
    # round 12: the phase share the frontier/CSR work batters down — gated
    # so the deps_execute_wait win is HELD, not just measured once.  A sim
    # share (deterministic, dimensionless): 1.5x means "the execute-wait
    # share grew by half", i.e. someone re-serialized the execution plane.
    ("deps_execute_wait_share", 1.5),
)


def inject_factor() -> float:
    """The ``ACCORD_PERFGATE_INJECT_LATENCY`` self-test multiplier (1.0 =
    off; a malformed value raises — a doctored run must never pass for
    clean).  Single source of truth for every consumer of the hook: the
    measurement rescale below, the ledger-append guards here and in
    bench.py, and ``write_baseline``'s refusal."""
    return float(os.environ.get("ACCORD_PERFGATE_INJECT_LATENCY", "1.0"))


def inject_active() -> bool:
    """True when the self-test hook is doctoring measured latencies — such
    runs must never reach the trend ledger or the baseline."""
    return inject_factor() != 1.0


def measure_smoke(seed: int = SMOKE_SEED) -> dict:
    """Run the smoke workload; returns the gate summary (sim plane + wall
    plane + the latency budget's class shares).  ``seed`` parameterizes the
    multi-seed mode — same workload shape, different trajectory."""
    from cassandra_accord_tpu_torch.harness.burn import run_burn
    from cassandra_accord_tpu_torch.observe import FlightRecorder, WallProfiler
    rec = FlightRecorder()
    prof = WallProfiler()
    t0 = time.perf_counter()
    res = run_burn(seed, observer=rec, profiler=prof, **SMOKE_KW)
    wall_s = time.perf_counter() - t0
    budget = rec.latency_budget()
    cluster_metrics = rec.metrics_snapshot()["cluster"]
    messages = sum(v for k, v in cluster_metrics.items()
                   if k.startswith("link.") and isinstance(v, int))
    wall = prof.report()
    inject = inject_factor()
    return {
        "workload": dict(seed=seed, **SMOKE_KW),
        "sim": {
            "commit_latency_mean_us":
                round(budget["mean_commit_latency_us"] * inject, 1),
            "commit_latency_p95_us": round(budget["p95_us"] * inject, 1),
            "sim_ms": res.sim_micros // 1000,
            "messages": messages,
            "commits": res.ops_ok,
            # the round-12 gated phase share (deps_execute_wait /
            # deps_commit_wait split the old deps wait by pending plane)
            "deps_execute_wait_share": round(
                (budget.get("phases", {}).get("deps_execute_wait") or {})
                .get("share", 0.0), 4),
        },
        "budget_shares": {c: v["share"] for c, v in budget["classes"].items()},
        "dominating_class": budget["dominating_class"],
        "dominating_share": budget["dominating_share"],
        "attributed_share": budget["attributed_share"],
        "wall": {
            "wall_s": round(wall_s, 3),
            "commits_per_sec": round(res.ops_ok / wall_s, 1) if wall_s else None,
            "handler_cpu_s": wall["handler_total_s"],
            "loop_occupancy": wall["scheduler"]["occupancy"],
        },
    }


def load_baseline(path: str = BASELINE_PATH) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f).get("gate")
    except (OSError, ValueError):
        return None


def latest_bench(root: str = _REPO_ROOT) -> Optional[Tuple[str, dict]]:
    """The newest BENCH_r0*.json artifact's parsed content, if any parses."""
    names = sorted(n for n in os.listdir(root)
                   if n.startswith("BENCH_r") and n.endswith(".json"))
    for name in reversed(names):
        try:
            with open(os.path.join(root, name)) as f:
                doc = json.load(f)
            if doc:
                return name, doc
        except (OSError, ValueError):
            continue
    return None


def compare(current: dict, baseline: Optional[dict]) \
        -> Tuple[List[str], List[str]]:
    """Per-metric delta lines + the list of gated failures."""
    lines: List[str] = []
    failures: List[str] = []
    if baseline is None:
        lines.append("perfgate: no baseline recorded (BASELINE.json has no "
                     "'gate' block) — deltas unavailable, nothing gated")
        cur = current["sim"]
        for key, _thresh in GATED_METRICS:
            lines.append(f"  {key:<26} {cur.get(key)}")
        return lines, failures
    base_sim = baseline.get("sim", {})
    cur_sim = current["sim"]
    lines.append(f"perfgate deltas vs baseline "
                 f"(recorded {baseline.get('recorded', '?')}, sim plane is "
                 f"deterministic):")
    for key, thresh in GATED_METRICS:
        cur, base = cur_sim.get(key), base_sim.get(key)
        if cur is None or base is None:
            lines.append(f"  {key:<26} {cur} (baseline {base}: not comparable)")
            continue
        if base == 0:
            # a zero baseline cannot ratio: any nonzero current is a loud
            # regression rather than a silent skip
            if cur > 0:
                failures.append(f"{key}: 0 -> {cur} (baseline is zero)")
                lines.append(f"  {key:<26} 0 -> {cur}  ** REGRESSION "
                             f"(zero baseline)")
            else:
                lines.append(f"  {key:<26} 0 -> 0  (1.000x)")
            continue
        ratio = cur / base
        mark = ""
        if ratio > thresh:
            mark = f"  ** REGRESSION (> {thresh:.2f}x)"
            failures.append(f"{key}: {base} -> {cur} ({ratio:.2f}x, "
                            f"threshold {thresh:.2f}x)")
        elif ratio < 1.0 / thresh:
            mark = "  (improvement)"
        lines.append(f"  {key:<26} {base} -> {cur}  ({ratio:.3f}x){mark}")
    dom = current.get("dominating_class")
    if dom:
        lines.append(f"  commit budget: {dom} dominates at "
                     f"{100.0 * current['dominating_share']:.1f}% "
                     f"({100.0 * current['attributed_share']:.1f}% attributed)"
                     + (f"; baseline {baseline.get('dominating_class')} at "
                        f"{100.0 * baseline.get('dominating_share', 0):.1f}%"
                        if baseline.get("dominating_class") else ""))
    base_wall = baseline.get("wall", {})
    cur_wall = current.get("wall", {})
    if cur_wall.get("commits_per_sec"):
        line = f"  wall (printed, never gated): " \
               f"{cur_wall['commits_per_sec']} commits/s, " \
               f"{cur_wall['handler_cpu_s']}s handler CPU, " \
               f"occupancy {cur_wall['loop_occupancy']}"
        if base_wall.get("commits_per_sec"):
            line += f"  (baseline {base_wall['commits_per_sec']} commits/s)"
        lines.append(line)
    bench = latest_bench()
    if bench is not None:
        name, doc = bench
        value = doc.get("value") or (doc.get("detail") or {}).get("value")
        if value:
            lines.append(f"  latest bench artifact {name}: "
                         f"{doc.get('metric')} = {value}")
    return lines, failures


def baseline_sim_for(baseline: Optional[dict], seed: int) -> Optional[dict]:
    """The baseline's sim block for one seed: the per-seed ``seeds`` table
    when recorded (``--write-baseline --seeds``), else the default block for
    the default smoke seed."""
    if baseline is None:
        return None
    per_seed = baseline.get("seeds") or {}
    if str(seed) in per_seed:
        return per_seed[str(seed)].get("sim")
    base_seed = (baseline.get("workload") or {}).get("seed", SMOKE_SEED)
    if seed == base_seed:
        return baseline.get("sim")
    return None


def compare_multi(per_seed: Dict[int, dict], baseline: Optional[dict]) \
        -> Tuple[List[str], List[str]]:
    """Multi-seed gating, per the KNOWN_ISSUES "trajectory sensitivity"
    note: single-seed hostile trajectories are knife-edge chaotic, so the
    gate judges the MEDIAN of the per-seed current/baseline ratios — one
    chaotic seed cannot trip (or mask) a regression alone."""
    import statistics
    lines: List[str] = []
    failures: List[str] = []
    seeds = sorted(per_seed)
    lines.append(f"perfgate multi-seed deltas (seeds {seeds}, gating on the "
                 f"MEDIAN per-metric ratio):")
    if baseline is None:
        lines.append("  no baseline recorded — nothing gated")
        return lines, failures
    for key, thresh in GATED_METRICS:
        ratios = []
        per_seed_bits = []
        for seed in seeds:
            cur = per_seed[seed]["sim"].get(key)
            base_sim = baseline_sim_for(baseline, seed) or {}
            base = base_sim.get(key)
            if cur is None or base is None or base == 0:
                per_seed_bits.append(f"s{seed}:{cur}/{base}?")
                continue
            ratios.append(cur / base)
            per_seed_bits.append(f"s{seed}:{cur / base:.3f}x")
        if not ratios:
            lines.append(f"  {key:<26} not comparable "
                         f"({' '.join(per_seed_bits)}) — record per-seed "
                         f"baselines with --write-baseline --seeds")
            continue
        med = statistics.median(ratios)
        mark = ""
        if med > thresh:
            mark = f"  ** REGRESSION (median > {thresh:.2f}x)"
            failures.append(f"{key}: median {med:.2f}x over "
                            f"{len(ratios)} seeds (threshold {thresh:.2f}x)")
        elif med < 1.0 / thresh:
            mark = "  (improvement)"
        lines.append(f"  {key:<26} median {med:.3f}x "
                     f"({' '.join(per_seed_bits)}){mark}")
    return lines, failures


def _median_sim(per_seed: Dict[int, dict]) -> dict:
    """Per-metric median of the sim planes (the trend-ledger record for a
    multi-seed run)."""
    import statistics
    out = {}
    for key, _thresh in GATED_METRICS:
        vals = [s["sim"][key] for s in per_seed.values()
                if s["sim"].get(key) is not None]
        if vals:
            out[key] = statistics.median(vals)
    return out


def _print_trend(out) -> None:
    """The cross-run ledger context (tools/trend.py): the last-K recorded
    runs' sim-metric trajectory, printed next to the baseline delta."""
    try:
        from tools.trend import load_history, trend_lines
        entries = load_history()
        for line in trend_lines(entries, last_k=5):
            print(line, file=out, flush=True)
    except Exception as e:  # noqa: BLE001 — trend context must not fail the gate
        print(f"trend: <unavailable: {e!r}>", file=out, flush=True)


def run(gate: bool, baseline_path: str = BASELINE_PATH,
        current: Optional[dict] = None, out=None,
        seeds: Optional[List[int]] = None) -> int:
    """Measure (unless ``current`` given), print deltas + the cross-run
    trend, return the exit code (0, or EXIT_REGRESSION when ``gate`` and a
    threshold tripped).  ``seeds`` switches to per-seed measurement with
    median gating (a single listed seed is measured AS THAT SEED — never
    silently replaced by the default smoke seed) and is mutually exclusive
    with ``current`` (an artifact carries one seed's measurement; re-running
    live would gate the wrong tree state).  A measurement taken here is
    appended to the trend ledger (BENCH_HISTORY.jsonl)."""
    out = out or sys.stdout
    if seeds and current is not None:
        raise ValueError("--current and --seeds are mutually exclusive: a "
                         "saved artifact holds one seed's measurement; "
                         "gate it with plain --current")
    measured_here = current is None
    history_record = None
    if seeds:
        per_seed = {}
        for seed in seeds:
            per_seed[seed] = measure_smoke(seed)
            sim = per_seed[seed]["sim"]
            print(f"perfgate seed {seed}: " + " ".join(
                f"{k}={sim.get(k)}" for k, _t in GATED_METRICS),
                file=out, flush=True)
        lines, failures = compare_multi(per_seed, load_baseline(baseline_path))
        history_record = {"kind": "perfgate", "seeds": sorted(per_seed),
                          "sim": _median_sim(per_seed)}
    else:
        if current is None:
            current = measure_smoke()
        lines, failures = compare(current, load_baseline(baseline_path))
        if measured_here:
            history_record = {"kind": "perfgate",
                              "seeds": [current["workload"]["seed"]],
                              "sim": dict(current["sim"])}
    for line in lines:
        print(line, file=out, flush=True)
    if inject_active():
        # the documented self-test hook doctors the measured latencies — a
        # ledger record of it would read as a real 2x regression in every
        # later trend report
        history_record = None
    if history_record is not None:
        # the ledger grows as a side effect of runs that already happen
        try:
            from tools.trend import append_entry
            append_entry(history_record)
        except Exception:  # noqa: BLE001 — the ledger must not fail the gate
            pass
    _print_trend(out)
    if failures:
        verdict = "perfgate: " + ("FAIL — " if gate else "regressions "
                                  "detected (print-only mode) — ") \
            + "; ".join(failures)
        print(verdict, file=out, flush=True)
        return EXIT_REGRESSION if gate else 0
    print("perfgate: PASS (no gated metric past threshold)", file=out,
          flush=True)
    return 0


def write_baseline(path: str = BASELINE_PATH,
                   seeds: Optional[List[int]] = None) -> dict:
    """Measure and record the gate baseline into BASELINE.json['gate'];
    ``seeds`` additionally records a per-seed ``seeds`` table (the sim
    planes the multi-seed median gate compares against)."""
    import datetime
    if inject_active():
        # a doctored baseline would make every future REAL regression gate
        # clean — refuse loudly rather than record it
        raise RuntimeError(
            "refusing --write-baseline with ACCORD_PERFGATE_INJECT_LATENCY "
            "set: the doctored latencies would become the baseline and "
            "silently defeat the gate")
    summary = measure_smoke()
    summary["recorded"] = datetime.date.today().isoformat()
    if seeds:
        summary["seeds"] = {
            str(seed): {"sim": (summary["sim"] if seed == SMOKE_SEED
                                else measure_smoke(seed)["sim"])}
            for seed in seeds}
    with open(path) as f:
        doc = json.load(f)
    doc["gate"] = summary
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return summary


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--smoke", action="store_true",
                      help="measure + print deltas vs baseline; ALWAYS exit "
                           "0 (the tier-1 budget guard's per-verify report)")
    mode.add_argument("--gate", action="store_true",
                      help=f"measure + compare; exit {EXIT_REGRESSION} when "
                           f"a gated sim metric regresses past threshold")
    mode.add_argument("--write-baseline", action="store_true",
                      help="measure and record the result as the new "
                           "BASELINE.json gate block")
    p.add_argument("--baseline", default=BASELINE_PATH,
                   help="baseline JSON path (default: repo BASELINE.json)")
    p.add_argument("--current", default=None, metavar="PATH",
                   help="compare a saved measure_smoke() summary instead of "
                        "measuring (offline gating of an artifact)")
    p.add_argument("--seeds", default=None, metavar="A,B,C",
                   help="multi-seed mode: measure every listed seed and "
                        "gate on the MEDIAN per-metric ratio (per the "
                        "KNOWN_ISSUES trajectory-sensitivity note that "
                        "single-seed regressions are knife-edge chaotic); "
                        "with --write-baseline, records the per-seed "
                        "baseline table")
    args = p.parse_args(argv)
    seeds = None
    if args.seeds:
        seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    if args.write_baseline:
        summary = write_baseline(args.baseline, seeds=seeds)
        print(json.dumps(summary["sim"], sort_keys=True))
        print(f"perfgate: baseline written to {args.baseline}"
              + (f" (per-seed table for {seeds})" if seeds else ""))
        return 0
    current = None
    if args.current:
        if seeds:
            p.error("--current and --seeds are mutually exclusive (a saved "
                    "artifact is one seed's measurement)")
        with open(args.current) as f:
            current = json.load(f)
    return run(gate=args.gate, baseline_path=args.baseline, current=current,
               seeds=seeds)


if __name__ == "__main__":
    raise SystemExit(main())
