"""The traced run: the benchmark's host spans and the device's operations.

``Tracer`` wraps the measured window in ``torch.profiler`` (CPU and CUDA
activities) when a run asks for it, and opens a ``record_function`` range
for every span the drivers name (``bench.window`` around the whole window,
then ``bench.step``, ``bench.refresh``, ``bench.submit``, ``bench.demand``,
``bench.mutate``, ``bench.traffic``).  Without tracing a span costs a
no-op context.  After the window the profile is written as a Chrome trace
to a temporary file, read back into a ``Trace`` and the file removed.

A device operation (kernel, copy or fill) belongs to the span that was open
on the host when it was launched: the runtime call with the same
correlation id.  An operation whose launch the profiler did not record (a
launch through a library the profiler does not see) takes the launch time
of the operation before it on its stream, which ran before it in launch
order.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


class Tracer:
    """Spans for the drivers; a profile of the window when ``on``."""

    def __init__(self, on: bool, device_type: str):
        self.on = on
        self.device_type = device_type
        self._prof = None
        self.trace: Optional["Trace"] = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts, record_shapes=False,
                     with_stack=False, profile_memory=False) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
        self._prof = prof

    def read(self) -> "Trace":
        """Parse the profile of the window (once)."""
        if self.trace is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self.trace = Trace(json.load(f)["traceEvents"])
            finally:
                os.unlink(path)
            self._prof = None
        return self.trace


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Spans:
    """Non-overlapping host intervals of one name, for point lookups."""

    def __init__(self, intervals):
        self.iv = sorted(intervals)
        self.starts = [a for a, _ in self.iv]

    def find(self, t: float) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        return i if i >= 0 and t <= self.iv[i][1] else -1

    def __len__(self) -> int:
        return len(self.iv)


class Trace:
    """The window's device operations, each with its launching span."""

    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW} range")
        w = win[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.tid = w.get("tid")
        launch: Dict[int, float] = {}
        ops = []
        spans: Dict[str, list] = defaultdict(list)
        cpu_ops = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                ops.append((ts, ts + dur, e.get("name", "?"),
                            (e.get("args") or {}).get("correlation"),
                            (e.get("pid"), e.get("tid"))))
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = ts
            elif cat == "user_annotation" and e.get("tid") == self.tid:
                name = e.get("name", "")
                if name.startswith("bench.") and name != WINDOW:
                    spans[name].append((ts, ts + dur))
            elif cat == "cpu_op" and e.get("tid") == self.tid:
                cpu_ops.append((ts, ts + dur, e.get("name", "?")))
        ops.sort()
        last_launch: Dict[tuple, float] = {}
        self.ops = []          # (start, end, name, launch time or None)
        for a, b, name, corr, stream in ops:
            at = launch.get(corr)
            if at is None:
                at = last_launch.get(stream)
            else:
                last_launch[stream] = at
            self.ops.append((a, b, name, at))
        self.spans = {n: _Spans(iv) for n, iv in spans.items()}
        # the outermost cpu ops, for naming what the host did in a gap
        cpu_ops.sort(key=lambda x: (x[0], -x[1]))
        top = []
        for a, b, name in cpu_ops:
            if not top or a >= top[-1][1]:
                top.append((a, b, name))
        self._cpu = _Spans([(a, b) for a, b, _ in top])
        self._cpu_names = [n for _, _, n in sorted(top)]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self) -> List[Tuple[float, float]]:
        clipped = [(max(a, self.t0), min(b, self.t1)) for a, b, _, _ in self.ops
                   if b > self.t0 and a < self.t1]
        return _union(clipped)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def span_count(self, name: str) -> int:
        s = self.spans.get(name)
        return len(s) if s is not None else 0

    def launched_in(self, name: str) -> float:
        """Seconds of device time of every operation launched inside a
        span called ``name``."""
        s = self.spans.get(name)
        if s is None:
            return 0.0
        return sum(b - a for a, b, _, at in self.ops
                   if at is not None and s.find(at) >= 0) * 1e-6

    def _host_doing(self, t: float) -> str:
        inner = None
        for name, s in self.spans.items():
            i = s.find(t)
            if i >= 0 and (inner is None or s.iv[i][0] > inner[1]):
                inner = (name, s.iv[i][0])
        label = inner[0] if inner else "(between spans)"
        i = self._cpu.find(t)
        return f"{label} > {self._cpu_names[i] if i >= 0 else '(python)'}"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time inside the window, and
        the idle gaps summed by what the host was doing as each began."""
        by_op: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in self.ops:
            lo, hi = max(a, self.t0), min(b, self.t1)
            if hi > lo:
                by_op[name[:160]] += (hi - lo) * 1e-6
        gaps: Dict[str, float] = defaultdict(float)
        edge = self.t0
        for a, b in self._busy() + [(self.t1, self.t1)]:
            if a > edge:
                gaps[self._host_doing(edge + 1e-3)] += (a - edge) * 1e-6
            edge = max(edge, b)

        def first(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": first(by_op), "idle_gaps": first(gaps)}
