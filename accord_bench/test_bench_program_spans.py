"""The program's own ranges (``accord.*``, the port's ``observe.profiler.span``)
nested in the benchmark's ``bench.*`` spans leave every reading of ``Trace``
as it was: the window, the busy time, the device time launched in each
span, each span's count and the breakdown."""
import pytest

from accord_bench.trace import Trace

TID = 7
BENCH = ("bench.step", "bench.refresh", "bench.demand", "bench.submit")


def _x(cat, name, ts, dur, tid=TID, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _events(layout):
    """A 1,000-us window of two bench spans, each with host ops, launches
    and the device work they launched (one launch the profiler missed)."""
    ev = [_x("user_annotation", "bench.window", 0, 1000)]
    corr = 0
    for name, a, b in layout:
        ev.append(_x("user_annotation", name, a, b - a))
        ev.append(_x("cpu_op", "aten::to", a + 5, 40))
        ev.append(_x("cpu_op", "aten::nonzero", a + 60, 30))
        for at in (a + 10, a + 70):
            corr += 1
            ev.append(_x("cuda_runtime", "cudaLaunchKernel", at, 4,
                         correlation=corr))
            ev.append(_x("kernel", f"k{corr}", at + 20, 25, tid=99,
                         correlation=corr))
        ev.append(_x("kernel", "ctypes_launch", a + 130, 10, tid=99,
                     correlation=10_000 + corr))
    return ev


def _program(layout):
    """``accord.*`` ranges inside each bench span, nested two deep, as the
    port records them."""
    ev = []
    for name, a, b in layout:
        outer = "accord.step" if name == "bench.step" else \
            "accord.service.dispatch"
        ev.append(_x("user_annotation", outer, a + 2, b - a - 4))
        ev.append(_x("user_annotation", "accord.sync.frontier", a + 58, 35))
        ev.append(_x("user_annotation", "accord.kernel.to_host", a + 8, 45))
    return ev


LAYOUTS = {
    "step": [("bench.step", 10, 400), ("bench.step", 500, 900)],
    "windows": [("bench.refresh", 10, 300), ("bench.submit", 320, 340),
                ("bench.demand", 350, 700), ("bench.demand", 710, 990)],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_program_spans_change_no_reading(layout):
    base = _events(LAYOUTS[layout])
    plain = Trace(base)
    mixed = Trace(base + _program(LAYOUTS[layout]))
    assert plain.window_s == mixed.window_s
    assert plain.busy_s == mixed.busy_s > 0
    for name in BENCH:
        assert plain.span_count(name) == mixed.span_count(name)
        assert plain.launched_in(name) == mixed.launched_in(name)
    assert sorted(mixed.spans) == sorted({n for n, _, _ in LAYOUTS[layout]})
    assert plain.breakdown() == mixed.breakdown()
