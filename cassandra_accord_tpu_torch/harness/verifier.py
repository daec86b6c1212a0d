"""Strict-serializability verification for the list-append workload.

Capability parity with ``accord.verify.StrictSerializabilityVerifier``
(verify/StrictSerializabilityVerifier.java:40-894): client-visible observations
(what each txn read per key, what it appended, and its real-time submit/complete
window) are checked for the three properties that pin down strict serializability in
the unique-value list-append model:

1. **per-key linearizability**: every observed list for a key must be a prefix of a
   single total per-key order (the applied order);
2. **real-time order**: a txn that completed before another was submitted must be
   visible to it (reads include its writes; writes precede its writes);
3. **atomicity (no fractured reads)**: if any of txn W's writes is visible to reader
   R, every W write on a key R read must be visible to R.

Any violation raises ``HistoryViolation`` naming the offending txns, like the
reference's seed-stamped failures.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..primitives.keys import Key


class HistoryViolation(AssertionError):
    pass


class Observation:
    """One client txn's visible behavior.

    Outcomes mirror the reference burn's client accounting
    (BurnTest.java:426-447, ListRequest Outcome.Kind):

    - ``ok``: acknowledged with its reads/writes — fully constrained;
    - ``lost``: resolved, but unknown whether it applied (response lost and no
      replica evidence) — unconstrained, its writes MAY appear;
    - ``invalidated``: durably invalidated — its writes must NEVER appear;
    - ``failed``: unexpected failure (burns treat any as fatal).
    """

    __slots__ = ("op_id", "submit_time", "complete_time", "reads", "writes",
                 "outcome")

    def __init__(self, op_id: int, submit_time: int):
        self.op_id = op_id
        self.submit_time = submit_time
        self.complete_time: Optional[int] = None
        self.reads: Dict[Key, Tuple] = {}       # key -> observed list
        self.writes: Dict[Key, object] = {}     # key -> unique appended value
        self.outcome: Optional[str] = None

    def complete(self, complete_time: int, reads: Dict[Key, Tuple],
                 writes: Dict[Key, object]) -> None:
        self.complete_time = complete_time
        self.reads = reads
        self.writes = writes
        self.outcome = "ok"

    def fail(self, complete_time: int) -> None:
        self.complete_time = complete_time
        self.outcome = "failed"

    def lost(self, complete_time: int) -> None:
        self.complete_time = complete_time
        self.outcome = "lost"

    def invalidated(self, complete_time: int, writes: Dict[Key, object]) -> None:
        self.complete_time = complete_time
        self.writes = writes
        self.outcome = "invalidated"

    @property
    def failed(self) -> bool:
        return self.outcome == "failed"


class StrictSerializabilityVerifier:
    def __init__(self):
        self.observations: List[Observation] = []
        self._next_op = 0

    def begin(self, submit_time: int) -> Observation:
        obs = Observation(self._next_op, submit_time)
        self._next_op += 1
        self.observations.append(obs)
        return obs

    # ------------------------------------------------------------------
    def verify(self, final_state: Optional[Dict[Key, Tuple]] = None) -> None:
        done = [o for o in self.observations if o.outcome == "ok"]
        self._check_response_accounting()
        orders = self._check_prefix_consistency(done, final_state)
        # value -> position inverse index, shared by the three order-sensitive
        # checks so position semantics live in exactly one place
        pos = {key: {v: i for i, v in enumerate(order)}
               for key, order in orders.items()}
        self._check_real_time(done, pos)
        self._check_atomicity(done, pos)
        self._check_invalidated_never_applied(done, final_state)
        self._check_serialization_graph(done, pos)

    # -- 5: serialization-graph acyclicity (the Elle core) --------------------
    def _check_serialization_graph(self, done: List["Observation"],
                                   pos: Dict[Key, Dict[object, int]]) -> None:
        """Build the full dependency graph over acked ops and reject cycles
        (the reference pairs its verifier with Elle, verify/ElleVerifier.java;
        this is Elle's list-append core):

        - ww: per-key version order (the unique-value list positions);
        - wr: a read observing version v depends on v's writer;
        - rw (anti-dependency): a read observing length L precedes the writer
          of position L (it did not see that write);
        - rt: A completed before B was submitted => A precedes B.

        A cycle = the acked outcomes admit NO strict-serializable order, even
        when every per-key/per-pair check above passes."""
        writer_of: Dict[Tuple[Key, int], int] = {}
        op_index: Dict[int, Observation] = {o.op_id: o for o in done}
        for o in done:
            for key, value in o.writes.items():
                p = pos.get(key, {}).get(value)
                if p is not None:
                    writer_of[(key, p)] = o.op_id
        edges: Dict[int, set] = {o.op_id: set() for o in done}

        def add(a: int, b: int) -> None:
            if a != b and a in edges and b in op_index:
                edges[a].add(b)

        # ww: successive versions of a key
        for (key, p), writer in writer_of.items():
            nxt = writer_of.get((key, p + 1))
            if nxt is not None:
                add(writer, nxt)
        for o in done:
            for key, lst in o.reads.items():
                # wr: the last version this read observed precedes it
                if lst:
                    w = writer_of.get((key, len(lst) - 1))
                    if w is not None:
                        add(w, o.op_id)
                # rw: the first version it did NOT observe follows it
                w = writer_of.get((key, len(lst)))
                if w is not None:
                    add(o.op_id, w)
        # rt: real-time precedence in O(n) edges via a virtual submit chain:
        # v_j precedes op_j and v_{j+1}; a -> v_j for the first j submitted
        # after a's completion.  Paths a -> v_j -> ... -> op_k encode exactly
        # 'a completed before op_k was submitted' with no spurious op-op
        # constraints (the dense O(n^2) pair relation blew up verify time)
        from bisect import bisect_right
        ordered = sorted(done, key=lambda o: o.submit_time)
        submits = [o.submit_time for o in ordered]
        for j, o in enumerate(ordered):
            vj = ("rt", j)
            edges[vj] = set()
            edges[vj].add(o.op_id)
            if j + 1 < len(ordered):
                edges[vj].add(("rt", j + 1))
        for a in done:
            if a.complete_time is None:
                continue
            j = bisect_right(submits, a.complete_time)
            if j < len(ordered):
                edges[a.op_id].add(("rt", j))
        # cycle detection (iterative three-color DFS)
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {op: WHITE for op in edges}
        for root in edges:
            if color[root] != WHITE:
                continue
            stack = [(root, iter(edges[root]))]
            color[root] = GRAY
            path = [root]
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    if color[nxt] == GRAY:
                        i = path.index(nxt)
                        raise HistoryViolation(
                            f"serialization-graph cycle: {path[i:] + [nxt]} — "
                            f"acked outcomes admit no strict-serializable order")
                    if color[nxt] == WHITE:
                        color[nxt] = GRAY
                        stack.append((nxt, iter(edges[nxt])))
                        path.append(nxt)
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
                    path.pop()

    # -- 0: every op resolved ------------------------------------------------
    def _check_response_accounting(self) -> None:
        unresolved = [o.op_id for o in self.observations if o.outcome is None]
        if unresolved:
            raise HistoryViolation(f"ops never resolved: {unresolved}")

    # -- 4: invalidated writes never visible ---------------------------------
    def _check_invalidated_never_applied(self, done: List["Observation"],
                                         final_state: Optional[Dict[Key, Tuple]]) -> None:
        visible = set()
        for o in done:
            for lst in o.reads.values():
                visible.update(lst)
        if final_state:
            for lst in final_state.values():
                visible.update(lst)
        for o in self.observations:
            if o.outcome != "invalidated":
                continue
            for key, value in o.writes.items():
                if value in visible:
                    raise HistoryViolation(
                        f"op {o.op_id} was durably invalidated but its write "
                        f"{value!r} to {key} is visible")

    # -- 1: per-key prefix order --------------------------------------------
    def _check_prefix_consistency(self, done: List[Observation],
                                  final_state: Optional[Dict[Key, Tuple]]
                                  ) -> Dict[Key, Tuple]:
        by_key: Dict[Key, List[Tuple[int, Tuple]]] = {}
        for o in done:
            for key, lst in o.reads.items():
                by_key.setdefault(key, []).append((o.op_id, lst))
        if final_state:
            for key, lst in final_state.items():
                by_key.setdefault(key, []).append((-1, lst))
        orders: Dict[Key, Tuple] = {}
        for key, views in by_key.items():
            views.sort(key=lambda v: len(v[1]))
            for (op_a, a), (op_b, b) in zip(views, views[1:]):
                if a != b[:len(a)]:
                    raise HistoryViolation(
                        f"key {key}: op {op_a} observed {a} which is not a prefix of "
                        f"op {op_b}'s {b}")
            orders[key] = views[-1][1] if views else ()
        return orders

    # -- 2: real-time --------------------------------------------------------
    def _check_real_time(self, done: List[Observation],
                         pos: Dict[Key, Dict[object, int]]) -> None:
        """O(n log n) sweep replacing the dense pair relation (the nested loop
        bounded burn scale before the protocol did).

        Ops are processed in submit order; ops completed at-or-before the
        current submit time are folded into per-key aggregates first.  Because
        prefix consistency has already been verified, ``b.reads[key]`` IS
        ``orders[key][:L]``, so "a's write visible to b" reduces to
        ``pos[a's value] < L`` — the aggregate only needs, per key, the max
        write position among completed ops (with its writer, for the error
        message) plus any completed writes never observed in the order at all
        (visible to no one — any later reader of the key violates)."""
        # per-key aggregates over completed ops:
        #   top2: the two highest-ordered completed writes BY DISTINCT OPS as
        #         (position, writer_op, value, complete_time) — two entries so
        #         a check for op b can exclude b itself (an op's own write may
        #         already be absorbed when submit/complete times tie), and the
        #         max over all OTHER ops is still exactly available;
        #   unordered: [(writer_op, value, complete_time)] completed writes
        #              absent from the observed order (visible to nobody).
        top2: Dict[Key, List[Tuple[int, int, object, int]]] = {}
        unordered: Dict[Key, List[Tuple[int, object, int]]] = {}

        def absorb(a: Observation) -> None:
            for key, value in a.writes.items():
                p = pos.get(key, {}).get(value)
                if p is None:
                    unordered.setdefault(key, []).append(
                        (a.op_id, value, a.complete_time))
                else:
                    entry = (p, a.op_id, value, a.complete_time)
                    best = top2.setdefault(key, [])
                    best.append(entry)
                    best.sort(reverse=True)
                    del best[2:]

        def max_excluding(key: Key, op_id: int):
            for entry in top2.get(key, ()):
                if entry[1] != op_id:
                    return entry
            return None

        by_submit = sorted(done, key=lambda o: o.submit_time)
        by_complete = sorted((o for o in done if o.complete_time is not None),
                             key=lambda o: o.complete_time)
        i = 0
        for b in by_submit:
            while i < len(by_complete) and \
                    by_complete[i].complete_time <= b.submit_time:
                absorb(by_complete[i])
                i += 1
            for key, lst in b.reads.items():
                ln = len(lst)
                agg = max_excluding(key, b.op_id)
                if agg is not None and agg[0] >= ln:
                    p, writer, value, ct = agg
                    raise HistoryViolation(
                        f"real-time violation: op {writer} wrote {value!r} to "
                        f"{key} and completed at {ct}, but op "
                        f"{b.op_id} (submitted {b.submit_time}) read {lst}")
                for writer, value, ct in unordered.get(key, ()):
                    if writer != b.op_id:
                        raise HistoryViolation(
                            f"real-time violation: op {writer} wrote {value!r} "
                            f"to {key} and completed at {ct}, but op "
                            f"{b.op_id} (submitted {b.submit_time}) read {lst}")
            for key, value in b.writes.items():
                pb = pos.get(key, {}).get(value)
                agg = max_excluding(key, b.op_id)
                if pb is not None and agg is not None and agg[0] > pb:
                    p, writer, wvalue, ct = agg
                    raise HistoryViolation(
                        f"real-time violation: op {writer}'s write {wvalue!r} "
                        f"ordered after op {b.op_id}'s {value!r} on {key} "
                        f"despite completing before it was submitted")

    # -- 3: atomicity --------------------------------------------------------
    def _check_atomicity(self, done: List[Observation],
                         pos: Dict[Key, Dict[object, int]]) -> None:
        """A fractured read needs a reader observing ≥2 of one writer's keys
        with mixed visibility, so only (key, key) pairs matter.  With prefix
        consistency already established, W's write at position p on key k is
        visible to a reader iff its read length on k exceeds p (never-ordered
        writes get an infinite position: visible to nobody).  Index every
        writer's key pairs as (p_i, p_j) points sorted by p_i with a running
        max of p_j; a reader pair (L_i, L_j) fractures iff some point has
        p_i < L_i (visible on k_i) and p_j >= L_j (invisible on k_j) — i.e.
        the prefix-max of p_j over p_i < L_i reaches L_j.  Replaces the
        reader×writers scan that went quadratic under contention."""
        INF = float("inf")
        # (k_i, k_j) -> [(p_i, p_j, writer_op)], both directions
        pairs: Dict[Tuple[Key, Key], List[Tuple[float, float, int]]] = {}
        for o in done:
            if len(o.writes) < 2:
                continue
            wkeys = sorted(o.writes, key=repr)
            wpos = {k: pos.get(k, {}).get(o.writes[k], INF) for k in wkeys}
            for idx, ki in enumerate(wkeys):
                for kj in wkeys[idx + 1:]:
                    pairs.setdefault((ki, kj), []).append(
                        (wpos[ki], wpos[kj], o.op_id))
                    pairs.setdefault((kj, ki), []).append(
                        (wpos[kj], wpos[ki], o.op_id))
        index: Dict[Tuple[Key, Key], Tuple[List[float], List[float]]] = {}
        for pk, pts in pairs.items():
            pts.sort()
            prefix_max: List[float] = []
            best = -1.0
            for _, pj, _ in pts:
                best = max(best, pj)
                prefix_max.append(best)
            index[pk] = ([pi for pi, _, _ in pts], prefix_max)
        from bisect import bisect_left
        for reader in done:
            if len(reader.reads) < 2:
                continue
            rkeys = list(reader.reads)
            for idx, ki in enumerate(rkeys):
                li = len(reader.reads[ki])
                for kj in rkeys[idx + 1:]:
                    lj = len(reader.reads[kj])
                    for (ka, la), (kb, lb) in (((ki, li), (kj, lj)),
                                               ((kj, lj), (ki, li))):
                        entry = index.get((ka, kb))
                        if entry is None:
                            continue
                        pis, pmax = entry
                        n = bisect_left(pis, la)  # points with p_i < L_a
                        if n == 0 or pmax[n - 1] < lb:
                            continue
                        # aggregate hit: enumerate culprits, excluding self
                        for pi, pj, writer in pairs[(ka, kb)]:
                            if writer != reader.op_id and pi < la and pj >= lb:
                                raise HistoryViolation(
                                    f"fractured read: op {reader.op_id} sees op "
                                    f"{writer}'s write on {ka} (read len {la} > "
                                    f"pos {pi}) but not on {kb} (read len {lb} "
                                    f"<= pos {pj})")
