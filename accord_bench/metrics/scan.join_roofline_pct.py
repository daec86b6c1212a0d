"""scan.join_roofline_pct: the step's join, its least time over the device
time of the join kernels launched inside the benchmark's span around each
step (K1d_tk ``tk_kernel`` on the [T, K] route, K1 ``deps_join_kernel`` on
the CSR route), summed over the traced steps.

The least time of a join is the larger of its bytes over the card's
bandwidth and its operations over its int8 rate (``peaks``).  Bytes count
each input once and each output once, each at its densest form (0/1
matrices as bits): the index rows of the keys the batch names, the TxnId
lanes and the kind, status and active codes of the live slots sharing one
of them, the batch's query bits, started-before bounds and kinds, and the
deps out.  So no form of the join can read past 100%.
"""
from accord_bench.peaks import least_seconds

LANES = 5 * 4          # a timestamp: five int32 lanes
SLOT_BITS = 3 + 3 + 1  # kind, status, active
JOIN_KERNELS = ("tk_kernel", "deps_join_kernel")


def join_bytes(t: int, k: int, b: int, distinct: int, union: int) -> float:
    """Bytes a join of ``b`` transactions naming ``distinct`` keys must move
    over an index of ``t`` slots and ``k`` keys, ``union`` of whose live
    slots share a key with the batch."""
    return (distinct * t / 8                        # index rows of the named keys
            + union * (LANES + SLOT_BITS / 8)       # their slots' TxnIds and codes
            + b * (k / 8 + LANES + 3 / 8)           # query bits, bounds, kinds
            + b * t / 8)                            # the deps


def join_ops(b: int, union: int) -> float:
    """Per transaction and candidate slot: the started-before compare over
    five lanes, the witness, live and status tests."""
    return b * union * 8


def join_seconds(trace) -> float:
    """Device seconds of the join kernels launched inside ``bench.step``."""
    steps = trace.spans.get("bench.step")
    if steps is None:
        return 0.0
    return sum(b - a for a, b, name, at in trace.ops
               if at is not None and any(n in name for n in JOIN_KERNELS)
               and steps.find(at) >= 0) * 1e-6


def read(run):
    t = run.trace
    if t is None:
        return None
    device = join_seconds(t)
    if device <= 0:
        return None
    T, K = int(run.cfg["txn_slots"]), int(run.cfg["key_slots"])
    b = int(run.traffic["batch"])
    least = sum(least_seconds(join_bytes(T, K, b, r["distinct"], r["union"]),
                              join_ops(b, r["union"]))
                for r in run.records if r["window"])
    return 100.0 * least / device
