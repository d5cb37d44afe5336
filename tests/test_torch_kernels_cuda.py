"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Each test skips without a CUDA device (the kernels build with nvcc
and have no CPU mode). This file imports no JAX, so it also runs on a
machine that has none:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Integer-valued inputs make every dot product exact, so outputs must be
EQUAL to the plain versions, ties included.
"""
import pytest
import torch

from cldrd_tpu_torch.ops import extract_topk as k1
from cldrd_tpu_torch.ops import fused_binmax as k2
from cldrd_tpu_torch.search import mips


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc and "
                    "run only on the card")
    return torch.device("cuda")


def _inputs(dev, bz, n, d, c_dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-4, 5, (bz, d), generator=g, device=dev,
                      dtype=torch.int8).to(torch.bfloat16)
    if c_dtype == torch.int8:
        c = torch.randint(-127, 128, (n, d), generator=g, device=dev,
                          dtype=torch.int8)
        scales = torch.rand(n, generator=g, device=dev) + 0.5
    else:
        c = torch.randint(-4, 5, (n, d), generator=g, device=dev,
                          dtype=torch.int8).to(c_dtype)
        scales = None
    if c_dtype == torch.float32:
        q = q.float()
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ids[-500:] = -1
    return q, c, ids, scales


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype", [torch.bfloat16, torch.int8,
                                     torch.float32])
@pytest.mark.parametrize("rounds,rounds2", [(None, 16), (5, 8)])
def test_extract_topk_equals_plain(c_dtype, rounds, rounds2):
    """Full mode (16 emitted rounds) and reduced mode (8, as the
    full-corpus store gives it: R=5, R2=8)."""
    dev = _device()
    bz, n = 256, 65_536
    q, c, ids, scales = _inputs(dev, bz, n, 768, c_dtype, 0)
    R = rounds or mips._extract_rounds(n, bz, 1000, 128)
    before = k1.LAUNCHES
    got = k1.extract_topk(q, c, ids, R, rounds2, 128, scales)
    ref = k1.extract_topk_plain(q, c, ids, R, rounds2, 128, scales)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bz,n,bin_rows", [(200, 64_512, 128),
                                           (64, 64_528, 16), (1, 64_520, 8)])
def test_fused_binmax_equals_plain(bz, n, bin_rows):
    """Ragged batches and a partial last row tile included."""
    dev = _device()
    q, c, ids, scales = _inputs(dev, bz, n, 768, torch.int8, 1)
    got = k2.fused_binmax(q, c, ids, bin_rows, scales)
    ref = k2.fused_binmax_plain(q, c, ids, bin_rows, scales)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrappers_raise_on_shapes_the_kernels_do_not_take():
    dev = _device()
    q, c, ids, _ = _inputs(dev, 128, 4096, 768, torch.bfloat16, 2)
    with pytest.raises(ValueError):
        k1.extract_topk(q[:100], c, ids, 5, 8)  # batch not a multiple of 64
    with pytest.raises(ValueError):
        k1.extract_topk(q, c, ids, 5, 8, bin_rows=64)
    with pytest.raises(ValueError):
        k2.fused_binmax(q, c, ids, 100)
    with pytest.raises(ValueError):
        k2.fused_binmax(q, c.cpu(), ids, 128)
