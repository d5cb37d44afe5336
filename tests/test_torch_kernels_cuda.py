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
bf16 training launches with head_dim 64 and L <= 256 take the Hopper
kernels (csrc/attention_sm90.cu); on inputs where every value is exact
in bf16 their out, dv, dq and dk must EQUAL the plain versions, so a
single wrong dropout bit or dS element fails; on normal data their dq
and dk lie
within a per-element bound of one bf16 ulp per dS term; and two
launches must give the same bits.
"""
import ctypes

import pytest
import torch

from cldrd_tpu_torch.ops import attention as att
from cldrd_tpu_torch.ops import extract_topk as k1
from cldrd_tpu_torch.ops import fused_binmax as k2
from cldrd_tpu_torch.ops import ivf_probe as k6
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


def _probe_inputs(dev, nb, slot, d, bz, p, c_dtype, scaled, seed,
                  integer=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    if c_dtype == torch.int8:
        rows = torch.randint(-127, 128, (nb * slot, d), generator=g,
                             device=dev, dtype=torch.int8)
    elif integer:
        rows = torch.randint(-8, 9, (nb * slot, d), generator=g, device=dev,
                             dtype=torch.int8).to(c_dtype)
    else:
        rows = torch.randn(nb * slot, d, generator=g, device=dev).to(c_dtype)
    q = (torch.randint(-4, 5, (bz, d), generator=g, device=dev,
                       dtype=torch.int8).float() if integer
         else torch.randn(bz, d, generator=g, device=dev))
    probe = torch.randint(0, nb, (bz, p), generator=g, device=dev,
                          dtype=torch.int32)
    scales = (torch.rand(nb, slot, generator=g, device=dev) + 0.5
              if scaled else None)
    return q, rows, probe, scales


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype,scaled", [(torch.int8, True),
                                            (torch.bfloat16, False),
                                            (torch.bfloat16, True)])
@pytest.mark.parametrize("bz,p,slot,d", [(8, 32, 256, 768), (3, 5, 128, 768),
                                         (1, 1, 200, 64)])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_ivf_probe_equals_plain(c_dtype, scaled, bz, p, slot, d, q_dtype):
    """K6: EQUAL on integer-valued inputs (every dot exact), within 1e-5
    of the largest score on normal data; a ragged last row block (slot
    200) included."""
    dev = _device()
    q, rows, probe, scales = _probe_inputs(dev, 40, slot, d, bz, p, c_dtype,
                                           scaled, 4)
    q = q.to(q_dtype)
    before = k6.LAUNCHES
    got = k6.probe_scores(q, rows, probe, scales, slot=slot)
    ref = k6.probe_scores_plain(q, rows, probe, scales, slot=slot)
    torch.cuda.synchronize()
    assert k6.LAUNCHES == before + 1
    assert got.shape == (bz, p * slot) and got.dtype == torch.float32
    assert torch.equal(got, ref)
    q, rows, probe, scales = _probe_inputs(dev, 40, slot, d, bz, p, c_dtype,
                                           scaled, 5, integer=False)
    got = k6.probe_scores(q.to(q_dtype), rows, probe, scales, slot=slot)
    ref = k6.probe_scores_plain(q.to(q_dtype), rows, probe, scales,
                                slot=slot)
    assert _rel(got, ref) <= 1e-5


@pytest.mark.cuda
def test_ivf_probe_duplicates_and_64bit_offsets():
    """Repeated probes in a row; rows past 2^31 elements of the store."""
    dev = _device()
    slot, d, nb = 2048, 768, 1400          # 2.2e9 elements > INT32_MAX
    rows = torch.zeros(nb * slot, d, dtype=torch.int8, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    for b in (0, 3, nb - 2, nb - 1):
        rows[b * slot:(b + 1) * slot] = torch.randint(
            -127, 128, (slot, d), generator=g, device=dev, dtype=torch.int8)
    scales = torch.rand(nb, slot, generator=g, device=dev) + 0.5
    q = torch.randint(-4, 5, (4, d), generator=g, device=dev,
                      dtype=torch.int8).to(torch.bfloat16)
    probe = torch.tensor([[nb - 1, nb - 1, 0, nb - 2, 3]] * 4,
                         dtype=torch.int32, device=dev)
    got = k6.probe_scores(q, rows, probe, scales, slot=slot)
    ref = k6.probe_scores_plain(q, rows, probe, scales, slot=slot)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(got[:, :slot], got[:, slot:2 * slot])
    assert bool((got[:, :slot] != 0).any())


@pytest.mark.cuda
def test_ivf_probe_raises_on_operands_the_kernel_does_not_take():
    dev = _device()
    q, rows, probe, scales = _probe_inputs(dev, 8, 128, 768, 2, 3,
                                           torch.int8, True, 7)
    q = q.bfloat16()
    for bad in (torch.float32, torch.float16):
        with pytest.raises(TypeError):
            k6.probe_scores(q, rows.to(bad), probe, None, slot=128)
    with pytest.raises(ValueError):     # D not a multiple of 16
        k6.probe_scores(q[:, :40].contiguous(), rows[:, :40].contiguous(),
                        probe, scales, slot=128)
    with pytest.raises(ValueError):     # operands on two devices
        k6.probe_scores(q, rows.cpu(), probe, scales, slot=128)
    with pytest.raises(ValueError):     # int64 probes
        k6.probe_scores(q, rows, probe.long(), scales, slot=128)


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
    (3, 30, 12, 64, 0.0, False),
    (3, 30, 12, 64, 0.1, True),
    (3, 30, 12, 64, 0.0, True),
    (2, 200, 12, 64, 0.1, False),
    (2, 200, 12, 64, 0.0, False),
    (2, 200, 12, 64, 0.1, True),
    (2, 200, 12, 64, 0.0, True),
    (2, 256, 12, 64, 0.1, True),    # packed rows
    (2, 256, 12, 64, 0.0, True),
    (2, 256, 12, 64, 0.1, False),   # passages
    (2, 256, 12, 64, 0.0, False),
    (2, 77, 4, 32, 0.0, False),
    (1, 512, 2, 64, 0.2, False),
])
def test_train_attention_equals_plain(dtype, b, length, h, d, p, segments):
    """K3 forward and K4 backward through flash_attention_train against
    the plain versions on the same seed, through the kernels their route
    names (bf16 with head_dim 64 and L <= 256: attention_sm90.cu)."""
    dev = _device()
    q, k, v, gr, mask, seg = _attn_inputs(dev, b, length, h, d, dtype,
                                          segments)
    before, entries = dict(att.LAUNCHES), dict(att.ENTRY_LAUNCHES)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = att.flash_attention_train(qs, ks, vs, mask, 4321, p, seg)
    out.backward(gr)
    ref = att.train_fwd_plain(q, k, v, mask, 4321, p, seg)
    rq, rk, rv = att.train_bwd_plain(q, k, v, mask, 4321, p, seg, gr)
    torch.cuda.synchronize()
    assert att.LAUNCHES["train_fwd"] == before["train_fwd"] + 1
    assert att.LAUNCHES["train_bwd"] == before["train_bwd"] + 1
    sm90 = att._kernel_route(dtype, length, d, "train_fwd") == "sm90"
    for entry in ("attn_fwd", "attn_bwd"):
        entry += "_sm90_launch" if sm90 else "_launch"
        assert att.ENTRY_LAUNCHES[entry] == entries[entry] + 1
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


# ------------------------------------------- the Hopper (sm90) attention


@pytest.mark.cuda
@pytest.mark.parametrize("form", [0, 1, 2, 3])
def test_sm90_wgmma_layouts_equal_matmul(form):
    """One 64x64x64 wgmma product in each operand form the sm90 kernels
    use, on small integers (exact in bf16 and in fp32 sums): EQUAL to the
    matmul it stands for."""
    dev = _device()
    from cldrd_tpu_torch.ops import _build

    g = torch.Generator(device=dev).manual_seed(form)
    a, b = (torch.randint(-3, 4, (64, 64), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    c = torch.empty(64, 64, dtype=torch.float32, device=dev)
    _build.launch("attention_sm90", "attn_sm90_mma_check",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int], a.data_ptr(),
                  b.data_ptr(), c.data_ptr(), form, device=dev)
    torch.cuda.synchronize()
    af, bf = a.float(), b.float()
    want = {0: af @ bf.T, 1: af.T @ bf, 2: af @ bf, 3: af @ bf}[form]
    assert torch.equal(c, want)


def _exact_inputs(dev, b, length, h):
    """q = 0, so every probability is 1/L (exact in bf16 for L a power
    of two); v and g one-hot over keys and queries: out and dv are sums
    of a few exact terms, so they must EQUAL the plain versions."""
    q = torch.zeros(b, length, h, 64, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    k = torch.randn(b, length, h, 64, generator=g, device=dev).to(
        torch.bfloat16)
    pos = torch.arange(length, device=dev)
    hot = (pos[:, None] % 64 == torch.arange(64, device=dev)[None, :])
    v = hot[None, :, None, :].expand(b, length, h, 64).to(torch.bfloat16)
    mask = torch.ones(b, length, dtype=torch.int32, device=dev)
    return q, k, v.contiguous(), (2 * v).contiguous(), mask


@pytest.mark.cuda
@pytest.mark.parametrize("length", [64, 256])
def test_sm90_dropout_is_bit_exact(length):
    """out and dv of the sm90 kernels EQUAL the plain versions where
    every value is exact in bf16: one wrong keep bit in either direction
    fails."""
    dev = _device()
    q, k, v, gr, mask = _exact_inputs(dev, 2, length, 4)
    out, res = att._launch_fwd(q, k, v, mask, 31, 0.1, None, True,
                               "train_fwd")
    _, _, dv = att._launch_bwd(q, k, v, mask, 31, 0.1, None, res, gr)
    ref = att.train_fwd_plain(q, k, v, mask, 31, 0.1)
    _, _, rv = att.train_bwd_plain(q, k, v, mask, 31, 0.1, None, gr)
    torch.cuda.synchronize()
    assert ref.abs().max() > 0 and rv.abs().max() > 0
    assert torch.equal(out, ref)
    assert torch.equal(dv, rv)


def _padded_mask(dev, b, length, g):
    """Keys padded as the main path's rows are: 1/8 to 1/3 of each row
    real (a query's ~8 tokens of 30, a passage's 32-86 of 256)."""
    n = torch.randint(max(2, length // 8), length // 3 + 2, (b, 1),
                      generator=g, device=dev)
    return (torch.arange(length, device=dev)[None] < n).int()


def _segments(dev, b, length):
    """Packed rows: three segments and a padded tail."""
    seg = torch.zeros(b, length, dtype=torch.int32, device=dev)
    seg[:, :length // 4] = 1
    seg[:, length // 4:length // 2] = 2
    seg[:, length // 2:length - 9] = 3
    return (seg > 0).int(), seg


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dq", "dk"])
@pytest.mark.parametrize("b,length,segments", [
    (8, 30, False), (3, 200, False), (2, 256, False), (2, 256, True)])
def test_sm90_grads_are_exact_on_exact_inputs(form, b, length, segments):
    """Every score of a row equal (form dq: q = 0, k one-hot over keys;
    form dk: q one-hot over queries, every key e_0), v one-hot over keys,
    g small integers, keys padded as on the main path, p = 0.5 (so inv
    and inv32 are 2, exact): every sum is exact, so out, dv, the
    residual ov and dq (or dk) EQUAL the plain versions. One wrong keep
    bit on probs or dp, row sum or dS element fails."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(11)
    shape = (b, length, 4, 64)
    pos = torch.arange(length, device=dev)
    hot = (pos[:, None] % 64 == torch.arange(64, device=dev)[None, :])
    hot = hot[None, :, None, :].expand(shape).to(torch.bfloat16)
    hot = hot.contiguous()
    zero = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    if form == "dq":
        q, k = zero, hot
    else:
        q, k = hot, zero.clone()
        k[..., 0] = 1
    gr = torch.randint(-2, 3, shape, generator=g, device=dev).to(
        torch.bfloat16)
    mask, seg = (_segments(dev, b, length) if segments
                 else (_padded_mask(dev, b, length, g), None))
    out, res = att._launch_fwd(q, k, hot, mask, 31, 0.5, seg, True,
                               "train_fwd")
    dq, dk, dv = att._launch_bwd(q, k, hot, mask, 31, 0.5, seg, res, gr)
    ref = att.train_fwd_plain(q, k, hot, mask, 31, 0.5, seg)
    rov = att.residual_ov_plain(q, k, hot, mask, 31, 0.5, seg)
    rq, rk, rv = att.train_bwd_plain(q, k, hot, mask, 31, 0.5, seg, gr)
    torch.cuda.synchronize()
    got, want = (dq, rq) if form == "dq" else (dk, rk)
    for x, y in ((out, ref), (res[1], rov), (dv, rv), (got, want)):
        assert y.abs().max() > 0
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("b,length,segments", [
    (8, 30, False), (2, 200, False), (2, 256, False), (2, 256, True)])
def test_sm90_grads_within_per_element_bound(b, length, segments):
    """On normal data with the main path's padding, each element of dq
    and dk lies within ``sm90_bwd_bound`` of the plain versions: one
    bf16 ulp of every dS term, fp32 dots in another order, one ulp of
    the output."""
    dev = _device()
    q, k, v, gr, _, _ = _attn_inputs(dev, b, length, 12, 64, torch.bfloat16,
                                     False, 9)
    g = torch.Generator(device=dev).manual_seed(9)
    mask, seg = (_segments(dev, b, length) if segments
                 else (_padded_mask(dev, b, length, g), None))
    _, res = att._launch_fwd(q, k, v, mask, 5, 0.1, seg, True, "train_fwd")
    dq, dk, _ = att._launch_bwd(q, k, v, mask, 5, 0.1, seg, res, gr)
    rq, rk, _ = att.train_bwd_plain(q, k, v, mask, 5, 0.1, seg, gr)
    bq, bk = att.sm90_bwd_bound(q, k, v, mask, 5, 0.1, seg, gr, rq, rk)
    torch.cuda.synchronize()
    for got, want, bound in ((dq, rq, bq), (dk, rk, bk)):
        assert ((got.float() - want.float()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [False, True])
def test_sm90_is_deterministic(segments):
    """Two launches of the sm90 kernels on the same inputs give the same
    bits for out, the residual (stats, ov), dq, dk and dv."""
    dev = _device()
    q, k, v, gr, mask, seg = _attn_inputs(dev, 2, 256, 4, 64,
                                          torch.bfloat16, segments, 3)
    runs = []
    for _ in range(2):
        out, res = att._launch_fwd(q, k, v, mask, 77, 0.1, seg, True,
                                   "train_fwd")
        runs.append((out, *res, *att._launch_bwd(q, k, v, mask, 77, 0.1,
                                                 seg, res, gr)))
    torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,length,d,route", [
    (torch.bfloat16, 256, 64, "sm90"),
    (torch.bfloat16, 257, 64, "tiled"),
    (torch.float32, 256, 64, "tiled"),
    (torch.bfloat16, 256, 32, "tiled"),
])
def test_route_boundary_by_launch_name(dtype, length, d, route):
    """L=256 bf16 takes the sm90 kernels; L=257, fp32 and head_dim 32
    take the tiled ones, each counted by its C entry point."""
    dev = _device()
    q, k, v, gr, mask, _ = _attn_inputs(dev, 1, length, 2, d, dtype, False)
    before = dict(att.ENTRY_LAUNCHES)
    qs = q.clone().requires_grad_()
    att.flash_attention_train(qs, k, v, mask, 3, 0.1).backward(gr)
    torch.cuda.synchronize()
    after = dict(att.ENTRY_LAUNCHES)
    suffix = "_sm90_launch" if route == "sm90" else "_launch"
    other = "_launch" if route == "sm90" else "_sm90_launch"
    for direction in ("attn_fwd", "attn_bwd"):
        assert after[direction + suffix] == before[direction + suffix] + 1
        assert after[direction + other] == before[direction + other]
    assert att._kernel_route(dtype, length, d, "train_fwd") == route
