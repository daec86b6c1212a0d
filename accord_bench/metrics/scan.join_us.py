"""scan.join_us: device time of the step's join per traced step: the join
kernels (``scan.join_roofline_pct``'s) launched inside the benchmark's span
around each step, over the traced steps."""
from pathlib import Path

from accord_bench import named

roofline = named.load(Path(__file__).resolve().parent / "scan.join_roofline_pct.py")


def read(run):
    t = run.trace
    if t is None or not t.span_count("bench.step"):
        return None
    device = roofline.join_seconds(t)
    return device / t.span_count("bench.step") * 1e6 if device > 0 else None
