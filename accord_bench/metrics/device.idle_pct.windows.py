"""device.idle_pct.windows: share of the traced window of the consult-window
cells in which no kernel, copy or fill runs on the card (torch.profiler)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
