"""consult.roofline_pct: the consult's least time over the device time of
every kernel, copy and fill launched inside the benchmark's span around a
window's demand and read-back, summed over the traced windows.

The least time of a window is the larger of its bytes over the card's
bandwidth and its operations over its int8 rate (``peaks``).  Bytes count
each input once and each output once, each at its densest form: the
incidence rows of the keys the window names (0/1, as bits) in both the live
and the full index, and the per-slot data only of the live slots those rows
name (a sparse consult reads no other).  So no layout can read past 100%.
"""
import math

from accord_bench.peaks import least_seconds

LANES = 5 * 4          # a timestamp: five int32 lanes
SLOT_BITS = 3 + 3 + 1  # kind, status, active


def window_bytes(t: int, k: int, rows: int, cols: int, distinct: int,
                 union: int) -> float:
    """Bytes a window of ``rows`` consults naming ``cols`` key slots
    (``distinct`` of them different) must move over an index of ``t`` slots
    and ``k`` keys, ``union`` of whose live slots share a key with it."""
    index = 2 * distinct * t / 8                  # live and full incidence rows
    slots = union * (2 * LANES + SLOT_BITS / 8)   # TxnId, executeAt, codes
    query = cols * math.log2(k) / 8 + rows * (LANES + 3 / 8)   # keys, bound, kind
    answers = rows * t / 8 + rows * LANES         # deps bits, max conflict
    return index + slots + query + answers


def window_ops(rows: int, union: int) -> float:
    """Per consult and candidate slot: the started-before compare over five
    lanes, the witness, live and status tests (8), and the max's (6)."""
    return rows * union * 14


def read(run):
    t = run.trace
    if t is None:
        return None
    device = t.launched_in("bench.demand")
    if device <= 0:
        return None
    T, K = int(run.cfg["txn_slots"]), int(run.cfg["key_slots"])
    least = sum(least_seconds(window_bytes(T, K, r["n"], r["cols"], r["distinct"],
                                           r["union"]),
                              window_ops(r["n"], r["union"]))
                for r in run.records if r["window"])
    return 100.0 * least / device
