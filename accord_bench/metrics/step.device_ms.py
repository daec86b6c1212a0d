"""step.device_ms: device time per step: the kernels, copies and fills
launched inside the benchmark's span around each step, over the traced
steps."""


def read(run):
    t = run.trace
    if t is None or not t.span_count("bench.step"):
        return None
    busy = t.launched_in("bench.step")
    return busy / t.span_count("bench.step") * 1e3 if busy > 0 else None
