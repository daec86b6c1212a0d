"""device.idle_pct.step: share of the traced window of the step cells in
which no kernel, copy or fill runs on the card (torch.profiler)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
