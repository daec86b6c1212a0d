"""The hand-written CUDA consult kernels against their plain versions.

These need an NVIDIA card (sm_90a) and nvcc: without CUDA every test here
skips with that reason.  Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q

The whole port is also driven on the card by ``python3 chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from cassandra_accord_tpu_torch.ops import _kernels
from cassandra_accord_tpu_torch.ops import deps_kernels as dk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(rng, t, k, b, device, width=3):
    inc = (rng.random((k, t)) < 0.05).astype(np.uint8)
    lanes = rng.integers(0, 50, (t, 5)).astype(np.int32)
    ts = lanes + rng.integers(0, 3, (t, 5)).astype(np.int32)
    kind = rng.integers(0, 6, t).astype(np.int8)
    status = rng.integers(0, 7, t).astype(np.int8)
    active = rng.random(t) < 0.9
    lens = rng.integers(0, width + 1, b)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = rng.integers(0, k, int(offsets[-1]) + 5).astype(np.int32)
    before = rng.integers(0, 50, (b, 5)).astype(np.int32)
    qkind = rng.integers(0, 6, b).astype(np.int8)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dict(inc=up(inc), txn_id=up(lanes), ts=up(ts), kind=up(kind),
                status=up(status), active=up(active), offsets=up(offsets),
                cols=up(cols), before=up(before), qkind=up(qkind))


@pytest.mark.parametrize("t,k,b", [(64, 16, 8), (1003, 64, 13),
                                   (4104, 128, 33)])
def test_deps_join_and_max_conflict_equal_plain(cuda, t, k, b):
    g = _inputs(np.random.default_rng(t), t, k, b, cuda)
    args = (g["inc"], g["txn_id"], g["kind"], g["status"], g["active"],
            g["offsets"], g["cols"], g["before"], g["qkind"])
    before = dict(_kernels.LAUNCHES)
    assert torch.equal(_kernels.deps_join(*args),
                       _kernels.deps_join_plain(*args))
    if t % 8 == 0:
        assert torch.equal(_kernels.deps_join(*args, packed=True),
                           _kernels.deps_join_plain(*args, packed=True))
    margs = (g["inc"], g["ts"], g["txn_id"], g["active"], g["offsets"],
             g["cols"])
    assert torch.equal(_kernels.max_conflict(*margs),
                       _kernels.max_conflict_plain(*margs))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["deps_join"] > before["deps_join"]
    assert _kernels.LAUNCHES["max_conflict"] > before["max_conflict"]


def test_dense_entry_points_on_card_equal_cpu(cuda):
    rng = np.random.default_rng(5)
    t, k, b = 256, 32, 16
    arrays = ((rng.random((t, k)) < 0.1).astype(np.int8),
              (rng.random((t, k)) < 0.1).astype(np.int8),
              rng.integers(0, 99, (t, 5)).astype(np.int32),
              rng.integers(0, 99, (t, 5)).astype(np.int32),
              rng.integers(0, 6, t).astype(np.int8),
              rng.integers(0, 7, t).astype(np.int8), rng.random(t) < 0.9,
              (rng.random((b, k)) < 0.1).astype(np.int8),
              rng.integers(0, 99, (b, 5)).astype(np.int32),
              rng.integers(0, 6, b).astype(np.int8))
    cpu = [torch.from_numpy(a) for a in arrays]
    gpu = [x.to(cuda) for x in cpu]
    for fn in (dk.consult, dk.consult_packed):
        for a, c in zip(fn(*gpu), fn(*cpu)):
            assert torch.equal(a.cpu(), c)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g = _inputs(np.random.default_rng(1), 64, 16, 4, cuda)
    args = [g["inc"], g["txn_id"], g["kind"], g["status"], g["active"],
            g["offsets"], g["cols"], g["before"], g["qkind"]]
    bad_dtype = list(args)
    bad_dtype[1] = bad_dtype[1].to(torch.int64)
    with pytest.raises(TypeError):
        _kernels.deps_join(*bad_dtype)
    strided = list(args)
    strided[0] = torch.zeros((64, 16), dtype=torch.uint8, device=cuda).t()
    with pytest.raises(ValueError):
        _kernels.deps_join(*strided)
    mixed = list(args)
    mixed[2] = mixed[2].cpu()
    with pytest.raises(ValueError):
        _kernels.deps_join(*mixed)
    odd = _inputs(np.random.default_rng(2), 61, 16, 4, cuda)
    with pytest.raises(ValueError):
        _kernels.deps_join(odd["inc"], odd["txn_id"], odd["kind"],
                           odd["status"], odd["active"], odd["offsets"],
                           odd["cols"], odd["before"], odd["qkind"],
                           packed=True)
