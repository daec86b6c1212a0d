"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the denominators of every roofline share here."""

HBM_BYTES_PER_S = 3.35e12
# int8 tensor-core rate, the highest dense rate the card has: no
# implementation of these integer tests can beat it
OPS_PER_S = 1.979e15


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S)
