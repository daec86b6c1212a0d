"""The plain reference (accord_bench/reference.py) against cases worked by
hand: both witness directions, the started-before bound, an invalidated
transaction, an empty slot, the slow path, the wave, the GC and an empty
window."""
import numpy as np
import torch

from accord_bench import reference as ref
from accord_bench.gen import KeySets

CFG = {"txn_slots": 4, "key_slots": 4}
READ, WRITE = 0, 1


def lanes(*rows):
    return np.array(rows, dtype=np.int32).reshape(-1, 5)


def keys(*sets):
    return KeySets(4, cols=np.array([list(s) * (2 // len(s)) for s in sets]))


def window_index():
    """Slot 0: a write on key 0; slot 1: a read on key 1 whose executeAt
    is later than its TxnId; slot 2: an invalidated read on keys 0 and 1;
    slot 3 empty."""
    return {"slot": np.array([0, 1, 2]), "keys": keys({0}, {1}, {0, 1}),
            "txn_id": lanes((1, 0, 10, 0, 1), (1, 0, 20, 0, 1), (1, 0, 30, 4, 1)),
            "ts": lanes((1, 0, 10, 0, 1), (1, 0, 50, 0, 2), (1, 0, 30, 4, 1)),
            "kind": np.array([WRITE, READ, READ], dtype=np.int8),
            "status": np.array([1, 2, 6], dtype=np.int8)}


def consults(ks, txn, kind):
    return ks.incidence(), lanes(*txn), np.array(kind, dtype=np.int8)


def join(r, slot, ks, txn, kind):
    """Transactions join the store in ``slot``; no status moves."""
    none = np.zeros(0, np.int32)
    r.apply(np.array(slot), *consults(ks, txn, kind), none, none.astype(np.int8),
            none.astype(bool), np.zeros((0, 5), np.int32))


def test_window_answers():
    r = ref.WindowReference(CFG, window_index(), "cpu")
    deps, mx, union = r.answer(*consults(
        keys({0, 1}, {1}, {0}, {3}),
        [(1, 0, 25, 0, 3), (1, 0, 15, 4, 2), (1, 0, 35, 4, 1), (1, 0, 70, 4, 1)],
        [READ, WRITE, WRITE, WRITE]))
    assert deps.tolist() == [
        [True, False, False, False],    # a read witnesses the write, not the read
        [False, False, False, False],   # the read on key 1 started after it
        [True, False, False, False],    # a write witnesses the write; slot 2 invalid
        [False, False, False, False]]   # no key shared
    assert mx.tolist() == [[1, 0, 50, 0, 2], [1, 0, 50, 0, 2], [1, 0, 30, 4, 1],
                           [0, 0, 0, 0, 0]]
    assert int(union) == 3


def test_window_apply_then_write_witnesses_reads():
    r = ref.WindowReference(CFG, window_index(), "cpu")
    join(r, [3], keys({0, 1}), [(1, 0, 25, 0, 3)], [READ])
    deps, mx, _ = r.answer(*consults(keys({1}), [(1, 0, 60, 4, 1)], [WRITE]))
    assert deps.tolist() == [[False, True, False, True]]
    assert mx.tolist() == [[1, 0, 50, 0, 2]]


def test_empty_window():
    r = ref.WindowReference(CFG, window_index(), "cpu")
    deps, mx, union = r.answer(np.zeros((0, 4), np.int8), np.zeros((0, 5), np.int32),
                               np.zeros(0, np.int8))
    assert tuple(deps.shape) == (0, 4) and tuple(mx.shape) == (0, 5) and int(union) == 0


def test_stale_step_control_answers_one_batch_late():
    r = ref.StepReference(CFG, step_initial(), 1, "cpu", stale=True)
    r.step(np.array([0]), *consults(keys({0}), [(1, 0, 30, 0, 2)], [WRITE]))
    deps, exec_at, applied, _, _ = r.step(
        np.array([3]), *consults(keys({0}), [(1, 0, 40, 4, 3)], [WRITE]))
    assert deps.tolist() == [[False, True, False, False]]    # misses slot 0
    assert applied.tolist() == [False, False, False, True]   # the state moved on


def test_stale_control_answers_one_window_late():
    r = ref.WindowReference(CFG, window_index(), "cpu", stale=True)
    join(r, [3], keys({0, 1}), [(1, 0, 25, 0, 3)], [READ])
    deps, _, _ = r.answer(*consults(keys({1}), [(1, 0, 60, 4, 1)], [WRITE]))
    assert deps.tolist() == [[False, True, False, False]]   # misses slot 3


def step_initial():
    return {"slot": np.array([1, 2]), "keys": keys({0}, {1}),
            "txn_id": lanes((1, 0, 10, 0, 1), (1, 0, 20, 0, 1)),
            "ts": lanes((1, 0, 100, 0, 0), (1, 0, 20, 0, 1)),
            "kind": np.array([WRITE, READ], dtype=np.int8),
            "status": np.array([ref.APPLIED, ref.APPLIED], dtype=np.int8)}


def test_step_slow_path_wave_and_gc():
    r = ref.StepReference(CFG, step_initial(), 1, "cpu")
    deps, exec_at, applied, union, tested = r.step(
        np.array([0, 3]), *consults(keys({0}, {1}), [(1, 0, 30, 0, 2), (1, 0, 40, 4, 3)],
                                    [READ, WRITE]),
        gc=np.array([1, 0, 25, 0, 0], dtype=np.int32))
    assert deps.tolist() == [[False, True, False, False], [False, False, True, False]]
    assert exec_at.tolist() == [[1, 0, 101, 0, 0], [1, 0, 40, 4, 3]]
    assert applied.tolist() == [True, False, False, True]
    assert int(union) == 2 and int(tested) == 2
    assert r.ix.active.tolist() == [True, False, False, True]   # 10 and 20 evicted
    deps, exec_at, applied, _, _ = r.step(
        np.array([1]), *consults(keys({0}), [(1, 0, 50, 4, 1)], [WRITE]))
    assert deps.tolist() == [[True, False, False, False]]
    assert exec_at.tolist() == [[1, 0, 102, 0, 0]]
    assert applied.tolist() == [False, True, False, False]


def test_step_backlog_chain():
    """A backlog of two stable batches of one: a write on key 0 (slot 2) on
    an applied write (slot 1), then a read on key 0 (slot 3) that waits on
    both writes.  One wave applies one link of the chain."""
    cfg = {"txn_slots": 8, "key_slots": 4}
    initial = {"slot": np.array([1, 2, 3]), "keys": keys({0}, {0}, {0}),
               "txn_id": lanes((1, 0, 10, 4, 1), (1, 0, 20, 4, 1), (1, 0, 30, 0, 1)),
               "ts": lanes((1, 0, 10, 4, 1), (1, 0, 20, 4, 1), (1, 0, 30, 0, 1)),
               "kind": np.array([WRITE, WRITE, READ], dtype=np.int8),
               "status": np.array([ref.APPLIED, ref.STABLE, ref.STABLE], dtype=np.int8)}
    r = ref.StepReference(cfg, initial, 1, "cpu")
    assert [w[1].tolist() for w in r.waiting] == [
        [[False, True] + [False] * 6], [[False, True, True] + [False] * 5]]
    deps, _, applied, _, tested = r.step(
        np.array([0]), *consults(keys({0}), [(1, 0, 40, 4, 2)], [WRITE]))
    assert deps.tolist() == [[False, True, True, True] + [False] * 4]
    assert int(tested) == 3                  # slots 0, 2 and 3 are stable
    assert applied.tolist() == [False, False, True] + [False] * 5
    _, _, applied, _, tested = r.step(
        np.array([4]), *consults(keys({1}), [(1, 0, 50, 0, 2)], [READ]))
    assert int(tested) == 3                  # slots 0, 3 and 4
    assert applied.tolist() == [False, False, False, True, True] + [False] * 3
    _, _, applied, _, tested = r.step(
        np.array([5]), *consults(keys({2}), [(1, 0, 60, 0, 2)], [READ]))
    assert int(tested) == 2 and applied.tolist() == [True] + [False] * 4 + [True, False, False]


def test_lex_helpers():
    a = torch.tensor([[1, 0, 5, 0, 2], [1, 0, 5, 4, 1], [0, 9, 9, 9, 9]], dtype=torch.int32)
    assert ref.lex_less(a[0], a[1]).item() and not ref.lex_less(a[1], a[0]).item()
    assert ref.lex_max(a, torch.tensor([[True, True, True]])).tolist() == [[1, 0, 5, 4, 1]]
    assert ref.next_ts(torch.tensor([[1, 3, 2 ** 31 - 1, 4, 7]])).tolist() == [[1, 4, 0, 0, 0]]
