"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Each test skips without a CUDA device (the kernels build with nvcc
and have no CPU mode). This file imports no JAX, so it also runs on a
machine that has none:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Integer-valued inputs make every dot product exact, so the search
kernels' outputs must be EQUAL to the plain versions, ties included. The
attention kernels (K3/K4/K5) agree within 1e-5 of the largest magnitude
in fp32 (fp32 sums in other orders; one wrong dropout bit would show as
about |v|/L) and 2e-2 in bf16 (one bf16 ulp of a probability near 1).
"""
import pytest
import torch

from cldrd_tpu_torch.ops import attention as att
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
        k1.extract_topk(q, c, ids, 5, 8, bin_rows=100)
    with pytest.raises(ValueError):
        k2.fused_binmax(q, c, ids, 100)
    with pytest.raises(ValueError):
        k2.fused_binmax(q, c.cpu(), ids, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("bin_rows", [8, 32, 64, 256])
def test_extract_topk_other_bins_equal_plain(bin_rows):
    dev = _device()
    q, c, ids, scales = _inputs(dev, 128, 16_384, 768, torch.bfloat16, 3)
    for rounds, rounds2 in ((7, 16), (5, 8), (2, 8)):
        got = k1.extract_topk(q, c, ids, rounds, rounds2, bin_rows, scales)
        ref = k1.extract_topk_plain(q, c, ids, rounds, rounds2, bin_rows,
                                    scales)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def _attn_inputs(dev, b, length, h, d, dtype, segments, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, gr = (torch.randn(b, length, h, d, generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    mask = torch.ones(b, length, dtype=torch.int32, device=dev)
    mask[0, length // 2:] = 0
    seg = None
    if segments:
        seg = torch.zeros(b, length, dtype=torch.int32, device=dev)
        seg[:, :length // 3] = 1
        seg[:, length // 3:length - 3] = 2
        mask = (seg > 0).int()
    return q, k, v, gr, mask, seg


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,length,h,d,p,segments", [
    (3, 30, 12, 64, 0.1, False),    # the query tower: a ragged tile
    (2, 200, 12, 64, 0.1, False),
    (2, 256, 12, 64, 0.1, True),    # packed rows
    (2, 77, 4, 32, 0.0, False),
    (1, 512, 2, 64, 0.2, False),
])
def test_train_attention_equals_plain(dtype, b, length, h, d, p, segments):
    """K3 forward and K4 backward through flash_attention_train against
    the plain versions on the same seed."""
    dev = _device()
    q, k, v, gr, mask, seg = _attn_inputs(dev, b, length, h, d, dtype,
                                          segments)
    before = dict(att.LAUNCHES)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = att.flash_attention_train(qs, ks, vs, mask, 4321, p, seg)
    out.backward(gr)
    ref = att.train_fwd_plain(q, k, v, mask, 4321, p, seg)
    rq, rk, rv = att.train_bwd_plain(q, k, v, mask, 4321, p, seg, gr)
    torch.cuda.synchronize()
    assert att.LAUNCHES["train_fwd"] == before["train_fwd"] + 1
    assert att.LAUNCHES["train_bwd"] == before["train_bwd"] + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for got, want in ((out, ref), (qs.grad, rq), (ks.grad, rk),
                      (vs.grad, rv)):
        assert _rel(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_infer_attention_equals_plain(dtype):
    dev = _device()
    q, k, v, _, mask, _ = _attn_inputs(dev, 8, 30, 12, 64, dtype, False, 1)
    before = att.LAUNCHES["infer"]
    out = att.flash_attention(q, k, v, mask)
    ref = att.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert att.LAUNCHES["infer"] == before + 1
    assert _rel(out, ref) <= (1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
def test_attention_wrappers_raise_on_shapes_the_kernels_do_not_take():
    dev = _device()
    q, k, v, _, mask, _ = _attn_inputs(dev, 2, 32, 4, 64, torch.float32,
                                       False)
    with pytest.raises(ValueError):  # head_dim 48
        att.flash_attention(q[..., :48], k[..., :48], v[..., :48], mask)
    long = torch.zeros(1, 513, 2, 64, device=dev)
    with pytest.raises(ValueError):  # L > 512
        att.flash_attention(long, long, long,
                            torch.ones(1, 513, device=dev))
    with pytest.raises(TypeError):  # fp16
        att.flash_attention(q.half(), k.half(), v.half(), mask)
    with pytest.raises(ValueError):  # operands on two devices
        att.flash_attention(q, k.cpu(), v, mask)
