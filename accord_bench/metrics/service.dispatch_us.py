"""service.dispatch_us: the consult service's host time per dispatch in the
window, from its own counters (``DeviceConsultService.dispatch_seconds`` /
``dispatch_count``): the uploads, the launch and the read-back of a window."""


def read(run):
    d = run.counters
    if not d.get("dispatch_count"):
        return None
    return d["dispatch_seconds"] / d["dispatch_count"] * 1e6
