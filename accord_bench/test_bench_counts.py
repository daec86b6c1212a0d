"""Each roofline metric's byte and operation counts, worked by hand for one
small shape, and the least time they give."""
from pathlib import Path

import pytest

from accord_bench import named, peaks

METRICS = Path(__file__).resolve().parent / "metrics"


def metric(name):
    return named.load(METRICS / f"{name}.py")


def test_window_counts():
    m = metric("consult.roofline_pct")
    # T = 64, K = 16, 2 consults naming 4 columns, 3 distinct, 10 live slots:
    # index 2 * 3 * 64 / 8 = 48; slots 10 * (40 + 7/8) = 408.75;
    # query 4 * 4 / 8 + 2 * (20 + 3/8) = 42.75; answers 2 * 8 + 2 * 20 = 56
    assert m.window_bytes(64, 16, 2, 4, 3, 10) == pytest.approx(555.5)
    assert m.window_ops(2, 10) == 280


def test_step_counts():
    m = metric("step.roofline_pct")
    # T = 64, K = 16, B = 2, 3 keys named, 10 live slots sharing one, a wave
    # that tests 5 stable slots:
    # read 24 + 408.75 + 2 * (2 + 20 + 3/8 + 6/8) + 32 + 5 * 8 = 551;
    # written 32 + 2 * (2 + 40 + 7/8) + 40 + 8 = 165.75
    assert m.step_bytes(64, 16, 2, 3, 10, 5) == pytest.approx(716.75)
    # a GC of 4 slots adds 64 * 20.5 = 1,312 read, (512 - 16) / 8 = 62 and
    # 4 * (2 + 40 + 7/8) = 171.5 written
    assert m.step_bytes(64, 16, 2, 3, 10, 5, evicted=4) == pytest.approx(2262.25)
    assert m.step_ops(64, 2, 10) == 280
    assert m.step_ops(64, 2, 10, evicted=4) == 280 + 384


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 1.979e15) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e9, 1.979e15) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["step.roofline_pct", "consult.roofline_pct",
                                  "step.device_ms"])
def test_nothing_to_read_reads_none(name):
    class Run:
        trace = None
    assert metric(name).read(Run()) is None
