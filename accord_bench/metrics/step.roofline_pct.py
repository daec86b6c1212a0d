"""step.roofline_pct: the step's least time over the device time of every
kernel, copy and fill launched inside the benchmark's span around each step
(the GC included where it follows), summed over the traced steps.

The least time of a step is the larger of its bytes over the card's
bandwidth and its operations over its int8 rate (``peaks``).  Bytes count
each input once and each output once, each at its densest form (0/1
matrices as bits): the index rows of the keys the batch names, the per-slot
data of the live slots sharing one of them, the batch, its adjacency rows
written, the adjacency rows of every stable slot the wave tests (the
batch's and the backlog's), its deps, executeAt and the applied set read
back; a GC adds the watermark test over every slot and the evicted rows and
columns of the adjacency.  So no layout can read past 100%.
"""
import math

from accord_bench.peaks import least_seconds

LANES = 5 * 4          # a timestamp: five int32 lanes
SLOT_BITS = 3 + 3 + 1  # kind, status, active


def step_bytes(t: int, k: int, b: int, distinct: int, union: int,
               tested: int, evicted: int = 0) -> float:
    """Bytes a step of ``b`` transactions naming ``distinct`` keys must move
    over a state of ``t`` slots and ``k`` keys, ``union`` of whose live slots
    share a key with the batch, whose wave tests ``tested`` stable slots;
    ``evicted`` slots when a GC follows."""
    row = b * t / 8                                    # b adjacency or deps rows
    read = (distinct * t / 8                           # index rows of the named keys
            + union * (2 * LANES + SLOT_BITS / 8)      # their slots' lanes and codes
            + b * (k / 8 + LANES + 3 / 8 + math.log2(t) / 8)   # the batch
            + t * 4 / 8                                # status, active: the wave
            + tested * t / 8)                          # the tested rows: the wave
    written = (2 * row                                 # adjacency rows, deps
               + b * (k / 8 + 2 * LANES + SLOT_BITS / 8)   # the batch's state rows
               + b * LANES + t / 8)                    # executeAt, applied set
    if evicted:
        read += t * (LANES + 4 / 8)                    # the watermark test
        written += ((2 * evicted * t - evicted ** 2) / 8
                    + evicted * (k / 8 + 2 * LANES + SLOT_BITS / 8))
    return read + written


def step_ops(t: int, b: int, union: int, evicted: int = 0) -> float:
    """Per transaction and candidate slot: the deps tests (8) and the lex
    max (6); a GC's watermark test over five lanes per slot."""
    return b * union * 14 + (t * 6 if evicted else 0)


def read(run):
    t = run.trace
    if t is None:
        return None
    device = t.launched_in("bench.step")
    if device <= 0:
        return None
    T, K = int(run.cfg["txn_slots"]), int(run.cfg["key_slots"])
    b, free = int(run.traffic["batch"]), int(run.traffic["gc_free"])
    least = sum(least_seconds(step_bytes(T, K, b, r["distinct"], r["union"],
                                         r["tested"], free if r["gc"] else 0),
                              step_ops(T, b, r["union"], free if r["gc"] else 0))
                for r in run.records if r["window"])
    return 100.0 * least / device
