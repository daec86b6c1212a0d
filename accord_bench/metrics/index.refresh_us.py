"""index.refresh_us: host time of ``begin_window`` per window (the service
refreshes the index rows changed since the last window), from the
benchmark's own span around each call."""


def read(run):
    times = [r["refresh_s"] for r in run.records if r["window"] and "refresh_s" in r]
    return sum(times) / len(times) * 1e6 if times else None
