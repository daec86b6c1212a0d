"""ycsb_scan: YCSB core workload E's transactions, short scans and inserts.

As CoreWorkload draws them (core's ``workloads/CoreWorkload.java``,
``doTransactionScan`` and ``doTransactionInsert``, ``insertorder=hashed``):

- a transaction is an insert with probability ``write_share`` (YCSB's
  ``insertproportion``), else a scan;
- a scan's start is the keynum YCSB's ``ScrambledZipfianGenerator(0,
  chooser_items - 1)`` draws (``keys/ycsb_zipfian.py``'s rank, FNV-hashed
  modulo ``chooser_items``), drawn again while it lies past the table's last
  keynum, as ``nextKeynum`` does; the scan names ``U{scan_min..scan_max}``
  records from there in key-name order (``"user" + fnvhash64(keynum)``
  compared as strings), clipped at the table's end;
- an insert writes one keynum of ``records .. chooser_items - 2``, drawn
  uniformly: an upsert, as Cassandra's INSERT is, so the table holds the
  chooser's ``chooser_items - 1`` records throughout.

A scan is a read and an insert a write, so the shape follows the kind that
``gen._new_txns`` draws (a write with probability ``write_share``) before it
hands its generator to ``draw``: ``draw`` reads those kinds back by making
the same draws from a fresh generator of the same seed, and refuses a
generator whose state that does not reproduce.

Key slot i is the i-th record in key-name order; a store of fewer slots
than records (the tests' tiny stores) folds that order evenly onto them.
Rows are ``scan_max`` columns wide, a short scan's padded with its first
key.
"""
from pathlib import Path

import numpy as np

from accord_bench import named
from accord_bench.gen import KeySets

zipfian = named.load(Path(__file__).resolve().parent / "ycsb_zipfian.py")


class ScanKeySets(KeySets):
    """``KeySets`` of rows padded with a repeated key."""

    def key_lists(self) -> list:
        """Each row's distinct key slots, in the row's order."""
        return [tuple(dict.fromkeys(r)) for r in self.cols.tolist()]


class Keys:
    def __init__(self, cfg: dict, seed: int):
        self.k = int(cfg["key_slots"])
        spec = cfg["keys"]
        self.records = int(spec["records"])
        self.items = int(spec["chooser_items"])
        self.table = self.items - 1
        self.scan_min, self.scan_max = int(spec["scan_min"]), int(spec["scan_max"])
        self.write_share, self.nodes = float(cfg["write_share"]), int(cfg["nodes"])
        self.chooser = zipfian.Keys(dict(cfg, key_slots=self.items), seed)
        keynums = np.arange(self.table, dtype=np.int64)
        names = np.array(["user" + str(h) for h in zipfian.fnvhash64(keynums).tolist()])
        self.pos = np.empty(self.table, dtype=np.int64)   # keynum -> its place
        self.pos[np.argsort(names, kind="stable")] = keynums
        self.slot = (keynums * min(self.k, self.table) // self.table).astype(np.int32)

    def starts(self, r: np.random.Generator, n: int) -> np.ndarray:
        """``n`` scan starts as keynums: the scrambled zipfian's, each one
        past the table's last keynum drawn again."""
        out = self.chooser.draw(r, n).cols[:, 0].astype(np.int64)
        again = np.flatnonzero(out >= self.table)
        while again.size:
            out[again] = self.chooser.draw(r, again.size).cols[:, 0]
            again = again[out[again] >= self.table]
        return out

    def writes_drawn_before(self, r: np.random.Generator, n: int) -> np.ndarray:
        """Which of the ``n`` transactions ``gen._new_txns`` drew as writes
        from ``r`` before handing it here (each kind, then each
        coordinator), drawn again from ``r``'s seed."""
        again = np.random.default_rng(r.bit_generator.seed_seq)
        writes = again.random(n) < self.write_share
        again.integers(1, self.nodes + 1, n)
        if again.bit_generator.state != r.bit_generator.state:
            raise ValueError("ycsb_scan draws the rows of gen.StepTraffic's "
                             "transactions, after their kinds and nodes")
        return writes

    def draw(self, r: np.random.Generator, n: int) -> ScanKeySets:
        insert = self.writes_drawn_before(r, n)
        first = self.pos[self.starts(r, n)]
        length = r.integers(self.scan_min, self.scan_max + 1, n)
        new = r.integers(self.records, self.table, n)
        step = np.arange(self.scan_max)
        place = first[:, None] + step[None, :]
        inside = (step[None, :] < length[:, None]) & (place < self.table)
        place = np.where(inside, place, first[:, None])
        place[insert] = self.pos[new[insert]][:, None]
        return ScanKeySets(self.k, self.slot[place])
