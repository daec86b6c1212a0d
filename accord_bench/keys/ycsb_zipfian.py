"""ycsb_zipfian: YCSB's ``requestdistribution=zipfian`` key chooser.

As YCSB's ``ScrambledZipfianGenerator`` draws a record (core's
``generator/ScrambledZipfianGenerator.java``, ``ZipfianGenerator.java``,
``Utils.fnvhash64``): a rank from a zipfian over ``keys.items`` ranks with
constant ``keys.theta`` (Gray et al.'s closed form, with the precomputed
``keys.zetan``), hashed by 64-bit FNV-1 onto one of the ``key_slots``
records.  Each transaction names one record, as each of YCSB's reads and
updates does.
"""
import numpy as np

from accord_bench.gen import KeySets

FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(1099511628211)


def fnvhash64(val: np.ndarray) -> np.ndarray:
    """YCSB's ``Utils.fnvhash64`` of non-negative longs, as int64."""
    val = val.astype(np.uint64)
    h = np.full(val.shape, FNV_OFFSET, dtype=np.uint64)
    for _ in range(8):
        h = (h ^ (val & np.uint64(0xFF))) * FNV_PRIME
        val = val >> np.uint64(8)
    return np.abs(h.view(np.int64))


class Keys:
    def __init__(self, cfg: dict, seed: int):
        self.k = int(cfg["key_slots"])
        spec = cfg["keys"]
        self.items = float(spec["items"])
        self.theta = float(spec["theta"])
        self.zetan = float(spec["zetan"])
        self.alpha = 1.0 / (1.0 - self.theta)
        zeta2 = 1.0 + 0.5 ** self.theta
        self.eta = ((1.0 - (2.0 / self.items) ** (1.0 - self.theta))
                    / (1.0 - zeta2 / self.zetan))

    def draw(self, r: np.random.Generator, n: int) -> KeySets:
        u = r.random(n)
        uz = u * self.zetan
        rank = (self.items * (self.eta * u - self.eta + 1.0) ** self.alpha).astype(np.int64)
        rank[uz < 1.0 + 0.5 ** self.theta] = 1
        rank[uz < 1.0] = 0
        return KeySets(self.k, (fnvhash64(rank) % self.k).astype(np.int32)[:, None])
