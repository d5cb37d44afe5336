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


def _bits(x):
    """fp32 as int32 bits: +0 and -0 differ (``_top_k`` orders +0 above
    -0), as do NaN payloads."""
    return x.view(torch.int32)


def _k2_inputs(dev, bz, n, c_dtype, seed):
    """Integer-valued K2 inputs with a zero query (its scores are exactly
    zero sums, +0 in the plain version) and masked rows."""
    q, c, ids, scales = _inputs(dev, bz, n, 768, c_dtype, seed)
    if bz > 1:
        q[bz // 2] = 0
    ids[:8] = -1                   # a masked 8-row bin at the start
    return q, c, ids, scales


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("bz", [1, 8, 200, 2048])
@pytest.mark.parametrize("bin_rows", [8, 16, 32, 64, 128])
def test_fused_binmax_equals_plain(c_dtype, bz, bin_rows):
    """The sm90 route's scores and bin maxima EQUAL the plain version's,
    bit for bit, on integer inputs: ragged batches (1, 8, 200) and the
    wide batch (2048, several query blocks a row tile), every bin size,
    and a partial last row tile (N % 128 = bin_rows below 128: 8, 16, 32
    and 64 rows past the last full tile)."""
    dev = _device()
    n = 64 * 1024 + bin_rows % 128
    q, c, ids, scales = _k2_inputs(dev, bz, n, c_dtype, 1 + bin_rows)
    assert k2.kernel_route(q.dtype, c.dtype, 768, bin_rows) == "sm90"
    before = dict(k2.ENTRY_LAUNCHES)
    got = k2.fused_binmax(q, c, ids, bin_rows, scales)
    ref = k2.fused_binmax_plain(q, c, ids, bin_rows, scales)
    torch.cuda.synchronize()
    assert k2.ENTRY_LAUNCHES["fused_binmax_sm90_launch"] == \
        before["fused_binmax_sm90_launch"] + 1
    assert k2.ENTRY_LAUNCHES["fused_binmax_launch"] == \
        before["fused_binmax_launch"]
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("bz,n,bin_rows", [(200, 64_512, 128),
                                           (64, 64_528, 16), (1, 64_520, 8)])
def test_fused_binmax_generic_route_gives_the_sm90_bits(c_dtype, bz, n,
                                                        bin_rows, monkeypatch):
    """fused_binmax.cu forced on the sm90 route's inputs gives the same
    bits (integer inputs: every sum exact, zero sums +0)."""
    dev = _device()
    q, c, ids, scales = _k2_inputs(dev, bz, n, c_dtype, 2)
    before = dict(k2.ENTRY_LAUNCHES)
    new = k2.fused_binmax(q, c, ids, bin_rows, scales)
    monkeypatch.setattr(k2, "kernel_route", lambda *a: "generic")
    old = k2.fused_binmax(q, c, ids, bin_rows, scales)
    torch.cuda.synchronize()
    for name in before:
        assert k2.ENTRY_LAUNCHES[name] == before[name] + 1
    for a, b in zip(new, old):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_fused_binmax_sm90_agrees_on_normal_data_and_is_deterministic():
    """Normal data: within 1e-5 of the largest score of the plain
    version's (fp32 sums in another order); two launches, the same
    bits."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(8)
    n = 40_000
    q = torch.randn(300, 768, generator=g, device=dev).to(torch.bfloat16)
    c = torch.randint(-127, 128, (n, 768), generator=g, device=dev,
                      dtype=torch.int8)
    scales = torch.rand(n, generator=g, device=dev) / 127
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ids[::5] = -1
    runs = [k2.fused_binmax(q, c, ids, 32, scales) for _ in range(2)]
    ref = k2.fused_binmax_plain(q, c, ids, 32, scales)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(runs[0], ref):
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a))
        assert _rel(a[fin], b[fin]) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,c_dtype,d,entry", [
    (torch.bfloat16, torch.int8, 768, "fused_binmax_sm90_launch"),
    (torch.bfloat16, torch.bfloat16, 128, "fused_binmax_sm90_launch"),
    (torch.bfloat16, torch.int8, 320, "fused_binmax_sm90_launch"),
    (torch.bfloat16, torch.bfloat16, 832, "fused_binmax_launch"),
    (torch.bfloat16, torch.int8, 96, "fused_binmax_launch"),
    (torch.bfloat16, torch.bfloat16, 64, "fused_binmax_launch"),
    (torch.bfloat16, torch.float32, 768, "fused_binmax_launch"),
    (torch.float32, torch.float32, 768, "fused_binmax_launch"),
])
def test_fused_binmax_route_boundary_by_launch_name(q_dtype, c_dtype, d,
                                                    entry):
    """Each launch goes through the C entry point kernel_route names, and
    either route EQUALS the plain version on integer inputs (depths of
    two and five 64-deep chunks included)."""
    dev = _device()
    q, c, ids, scales = _inputs(dev, 130, 4104, d, c_dtype, 12)
    q = q.to(q_dtype)
    before = dict(k2.ENTRY_LAUNCHES)
    got = k2.fused_binmax(q, c, ids, 8, scales)
    ref = k2.fused_binmax_plain(q, c, ids, 8, scales)
    torch.cuda.synchronize()
    for name, count in k2.ENTRY_LAUNCHES.items():
        assert count == before[name] + (name == entry)
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))


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
    with pytest.raises(ValueError):             # bins past 128 rows
        k2.fused_binmax(q, c, ids, 256)
    with pytest.raises(ValueError):             # N not a multiple of the bin
        k2.fused_binmax(q, c[:4000], ids[:4000], 64)
    with pytest.raises(TypeError):              # fp16 queries
        k2.fused_binmax(q.half(), c, ids, 128)
    # the sm90 entry point itself refuses what its route never sends it:
    # fp32 queries or store, D outside 128-768 or not a multiple of 64,
    # bins outside 8-128, an empty batch
    from cldrd_tpu_torch.ops import _build

    out_s = torch.empty(128, 4096, device=dev)
    out_b = torch.empty(128, 4096 // 8, device=dev)
    types = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int]
    good = dict(qd=1, cd=1, b=128, d=768, bins=8)
    for bad in (dict(qd=0), dict(cd=0), dict(d=832), dict(d=736),
                dict(d=64),
                dict(bins=256), dict(bins=4), dict(b=0)):
        a = {**good, **bad}
        with pytest.raises(RuntimeError):
            _build.launch("fused_binmax_sm90", "fused_binmax_sm90_launch",
                          types, q.data_ptr(), a["qd"], c.data_ptr(),
                          a["cd"], ids.data_ptr(), None, out_s.data_ptr(),
                          out_b.data_ptr(), a["b"], 4096, a["d"], a["bins"],
                          device=dev)


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


# --------------------------------------------- K1 on Hopper (sm90 route)


def _adversarial_store(dev, n, c_dtype, seed):
    """Integer-valued rows with many equal scores: every code in {-1, 0,
    1}, whole runs of duplicated rows, one bin of padding (id -1, its
    rounds exhaust to -inf) and one bin with a single real row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = torch.randint(-1, 2, (n, 768), generator=g, device=dev,
                      dtype=torch.int8)
    c[256:384] = c[256]            # a bin of one row, 128 times
    c[1000:1100] = c[999]          # duplicates across two bins
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ids[2048:2176] = -1            # a padded bin
    ids[4096:4223] = -1            # a bin with one real row (4223)
    ids[-300:] = -1
    scales = None
    if c_dtype == torch.int8:      # scales in {1, 2}: products stay exact
        scales = torch.randint(1, 3, (n,), generator=g, device=dev).float()
    else:
        c = c.to(c_dtype)
    return c, ids, scales


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("bz", [64, 128, 512])
@pytest.mark.parametrize("rounds,rounds2", [(2, 1), (7, 16), (5, 8),
                                            (2, 16), (7, 1)])
def test_extract_topk_sm90_equals_plain(c_dtype, bz, rounds, rounds2):
    """The sm90 kernel EQUALS the plain version, values, positions and
    rem1, on integer inputs with adversarial ties and padding, at the
    edges of R (2, 7) and R2 (1, 16)."""
    dev = _device()
    n = 16 * 2048
    c, ids, scales = _adversarial_store(dev, n, c_dtype, bz + rounds)
    g = torch.Generator(device=dev).manual_seed(rounds2)
    q = torch.randint(-1, 2, (bz, 768), generator=g, device=dev,
                      dtype=torch.int8).to(torch.bfloat16)
    q[1] = q[0]                    # equal queries
    q[2] = 0                       # every score of a row equal
    assert k1.kernel_route(q.dtype, c.dtype, 768, 128) == "sm90"
    before = k1.ENTRY_LAUNCHES["extract_topk_sm90_launch"]
    got = k1.extract_topk(q, c, ids, rounds, rounds2, 128, scales)
    ref = k1.extract_topk_plain(q, c, ids, rounds, rounds2, 128, scales)
    torch.cuda.synchronize()
    assert k1.ENTRY_LAUNCHES["extract_topk_sm90_launch"] == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype", [torch.bfloat16, torch.int8])
def test_extract_topk_sm90_is_deterministic_and_agrees_on_normal_data(
        c_dtype):
    """Normal data: values within 1e-5 of the largest score of the plain
    version's (fp32 sums in another order); two launches give the same
    bits."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(7)
    n = 8 * 2048
    q = torch.randn(128, 768, generator=g, device=dev).to(torch.bfloat16)
    if c_dtype == torch.int8:
        c = torch.randint(-127, 128, (n, 768), generator=g, device=dev,
                          dtype=torch.int8)
        scales = torch.rand(n, generator=g, device=dev) / 127
    else:
        c = torch.randn(n, 768, generator=g, device=dev).to(c_dtype)
        scales = None
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    runs = [k1.extract_topk(q, c, ids, 5, 8, 128, scales) for _ in range(2)]
    ref = k1.extract_topk_plain(q, c, ids, 5, 8, 128, scales)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for a, b in ((runs[0][0], ref[0]), (runs[0][2], ref[2])):
        assert _rel(a, b) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,c_dtype,bz,d,bin_rows,entry", [
    (torch.bfloat16, torch.int8, 128, 768, 128, "extract_topk_sm90_launch"),
    (torch.bfloat16, torch.bfloat16, 64, 256, 128,
     "extract_topk_sm90_launch"),
    (torch.bfloat16, torch.int8, 128, 768, 64, "extract_topk_launch"),
    (torch.bfloat16, torch.bfloat16, 128, 768, 256, "extract_topk_launch"),
    (torch.float32, torch.float32, 128, 768, 128, "extract_topk_launch"),
    (torch.bfloat16, torch.bfloat16, 128, 64, 128, "extract_topk_launch"),
])
def test_extract_topk_route_boundary_by_launch_name(q_dtype, c_dtype, bz, d,
                                                   bin_rows, entry):
    """Each launch goes through the C entry point kernel_route names, and
    either route EQUALS the plain version on integer inputs."""
    dev = _device()
    q, c, ids, scales = _inputs(dev, bz, 4096, d, c_dtype, 11)
    q = q.to(q_dtype)
    before = dict(k1.ENTRY_LAUNCHES)
    got = k1.extract_topk(q, c, ids, 5, 8, bin_rows, scales)
    ref = k1.extract_topk_plain(q, c, ids, 5, 8, bin_rows, scales)
    torch.cuda.synchronize()
    for name, count in k1.ENTRY_LAUNCHES.items():
        assert count == before[name] + (name == entry)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# ------------------------------------------ K5 on Hopper (short and sm90)


def _query_tower_mask(dev, b, length, g):
    """Most keys padded, as the query tower's rows are (1 to L/3 + 1 real
    tokens), and row 1 fully masked (the reference then gives 1/L)."""
    n = torch.randint(1, length // 3 + 2, (b, 1), generator=g, device=dev)
    mask = (torch.arange(length, device=dev)[None] < n).int()
    mask[1] = 0
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 17, 30, 32, 64])
def test_infer_short_equals_plain(length):
    """bf16 K5 at L <= 64 takes the short-row kernel; out within 2e-2 of
    the largest magnitude (one bf16 ulp of a probability near 1)."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(length)
    q, k, v = (torch.randn(96, length, 12, 64, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    mask = _query_tower_mask(dev, 96, length, g)
    before = att.ENTRY_LAUNCHES["attn_infer_short_launch"]
    out = att.flash_attention(q, k, v, mask)
    ref = att.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert att.ENTRY_LAUNCHES["attn_infer_short_launch"] == before + 1
    assert _rel(out, ref) <= 2e-2
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["q0", "k0"])
@pytest.mark.parametrize("b,length", [(512, 30), (8, 64), (8, 17)])
def test_infer_short_is_exact_on_exact_inputs(form, b, length):
    """Every score of a row equal (q = 0 and k one-hot, or q one-hot and
    every key e_0), v one-hot over keys, the query tower's padding and a
    fully masked row: each probability is 1/l rounded once, so out must
    EQUAL the plain version."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(b + length)
    shape = (b, length, 12, 64)
    pos = torch.arange(length, device=dev)
    hot = (pos[:, None] % 64 == torch.arange(64, device=dev)[None, :])
    hot = hot[None, :, None, :].expand(shape).to(torch.bfloat16).contiguous()
    zero = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    if form == "q0":
        q, k = zero, hot
    else:
        q, k = hot, zero.clone()
        k[..., 0] = 1
    mask = _query_tower_mask(dev, b, length, g)
    out = att.flash_attention(q, k, hot, mask)
    ref = att.attention_plain(q, k, hot, mask)
    torch.cuda.synchronize()
    assert ref.abs().max() > 0
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [65, 100, 256])
def test_infer_sm90_route_equals_plain(length):
    """bf16 K5 at 64 < L <= 256 takes the sm90 forward at p = 0 (no
    segments, no residual): within 2e-2 of the plain version, EQUAL on
    exact inputs."""
    dev = _device()
    q, k, v, _, mask, _ = _attn_inputs(dev, 16, length, 12, 64,
                                       torch.bfloat16, False, 4)
    mask = _query_tower_mask(dev, 16, length,
                             torch.Generator(device=dev).manual_seed(3))
    before = att.ENTRY_LAUNCHES["attn_fwd_sm90_launch"]
    out = att.flash_attention(q, k, v, mask)
    ref = att.attention_plain(q, k, v, mask)
    zq = torch.zeros_like(q)
    pos = torch.arange(length, device=dev)
    hot = (pos[:, None] % 64 == torch.arange(64, device=dev)[None, :])
    hot = hot[None, :, None, :].expand(q.shape).to(q.dtype).contiguous()
    out_x = att.flash_attention(zq, k, hot, mask)
    ref_x = att.attention_plain(zq, k, hot, mask)
    torch.cuda.synchronize()
    assert att.ENTRY_LAUNCHES["attn_fwd_sm90_launch"] == before + 2
    assert _rel(out, ref) <= 2e-2
    assert torch.equal(out_x, ref_x)


def _pair_mask(dev, b, length, g):
    """Keys padded as the teacher's (query, passage) pairs are: 24-140
    real tokens of 256."""
    n = torch.randint(24, 141, (b, 1), generator=g, device=dev)
    return (torch.arange(length, device=dev)[None] < n).int()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["normal", "q0", "k0"])
def test_infer_tiled_route_at_the_teacher_shape(form):
    """The MiniLM teacher's K5 launches (bf16, B=128, L=256, H=12, D=32,
    pair padding) take attention.cu's tiled forward: within 2e-2 of the
    plain version on normal data; EQUAL to it on exact inputs (every
    score of a row equal, v one-hot over keys)."""
    dev = _device()
    b, length, h, d = 128, 256, 12, 32
    g = torch.Generator(device=dev).manual_seed(32)
    shape = (b, length, h, d)
    mask = _pair_mask(dev, b, length, g)
    if form == "normal":
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
    else:
        pos = torch.arange(length, device=dev)
        v = (pos[:, None] % d == torch.arange(d, device=dev)[None, :])
        v = v[None, :, None, :].expand(shape).to(torch.bfloat16).contiguous()
        zero = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        if form == "q0":
            q, k = zero, v
        else:
            q, k = v, zero.clone()
            k[..., 0] = 1
    assert att._kernel_route(torch.bfloat16, length, d, "infer") == "tiled"
    key = ("infer", "attn_fwd_launch")
    before = att.ENTRY_LAUNCHES["attn_fwd_launch"], att.ROUTE_LAUNCHES[key]
    out = att.flash_attention(q, k, v, mask)
    ref = att.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert (att.ENTRY_LAUNCHES["attn_fwd_launch"],
            att.ROUTE_LAUNCHES[key]) == (before[0] + 1, before[1] + 1)
    assert ref.abs().max() > 0
    if form == "normal":
        assert _rel(out, ref) <= 2e-2
    else:
        assert torch.equal(out, ref)


@pytest.mark.cuda
def test_route_launches_tell_k3_from_k5_on_a_shared_forward():
    """K3 and K5 at fp32, head_dim 32 both take attention.cu's tiled
    forward: ENTRY_LAUNCHES counts both under its entry point,
    ROUTE_LAUNCHES each under its own (name, entry point)."""
    dev = _device()
    q, k, v, _, mask, _ = _attn_inputs(dev, 4, 64, 2, 32, torch.float32,
                                       False, 5)
    assert att._kernel_route(torch.float32, 64, 32, "train_fwd") == "tiled"
    keys = [("train_fwd", "attn_fwd_launch"), ("infer", "attn_fwd_launch")]
    entry = att.ENTRY_LAUNCHES["attn_fwd_launch"]
    before = [att.ROUTE_LAUNCHES[key] for key in keys]
    att.flash_attention_train(q, k, v, mask, 7, 0.1)
    att.flash_attention(q, k, v, mask)
    att.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert att.ENTRY_LAUNCHES["attn_fwd_launch"] == entry + 3
    assert [att.ROUTE_LAUNCHES[key] for key in keys] == [before[0] + 1,
                                                        before[1] + 2]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,length,d,entry", [
    (torch.bfloat16, 64, 64, "attn_infer_short_launch"),
    (torch.bfloat16, 65, 64, "attn_fwd_sm90_launch"),
    (torch.bfloat16, 256, 64, "attn_fwd_sm90_launch"),
    (torch.bfloat16, 257, 64, "attn_fwd_launch"),
    (torch.float32, 30, 64, "attn_fwd_launch"),
    (torch.bfloat16, 30, 32, "attn_fwd_launch"),
])
def test_infer_route_boundary_by_launch_name(dtype, length, d, entry):
    """K5 launches go through the C entry point _kernel_route names."""
    dev = _device()
    q, k, v, _, mask, _ = _attn_inputs(dev, 2, length, 4, d, dtype, False)
    before = dict(att.ENTRY_LAUNCHES)
    out = att.flash_attention(q, k, v, mask)
    ref = att.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    for name, count in att.ENTRY_LAUNCHES.items():
        assert count == before[name] + (name == entry)
    assert _rel(out, ref) <= (1e-5 if dtype == torch.float32 else 2e-2)


# ------------------------------------------------ wgmma register hazards


@pytest.mark.cuda
def test_built_kernels_have_no_wgmma_register_hazards():
    """No instruction of a built kernel writes a wgmma's register-A
    operand or touches its accumulators before the wait that retires it
    (ops/_wgmma_check.py reads the SASS; cuobjdump comes with nvcc)."""
    _device()
    from cldrd_tpu_torch.ops import _build, _wgmma_check

    paths = _build.build_all()
    counts = _wgmma_check.check_libraries(paths.values())
    hgmma = {name.split("-")[0]: n for name, n in counts.items()}
    assert hgmma["extract_topk_sm90"] > 0 and hgmma["attention_sm90"] > 0
    assert hgmma["fused_binmax_sm90"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype,rounds,rounds2", [
    (torch.int8, 5, 8), (torch.bfloat16, 7, 16)])
def test_extract_topk_sm90_equals_plain_on_every_launch(c_dtype, rounds,
                                                        rounds2):
    """At the main path's batch (512) the sm90 kernel EQUALS the plain
    version on integer inputs ten launches running: a register hazard
    showed on some launches only."""
    dev = _device()
    q, c, ids, scales = _inputs(dev, 512, 64 * 2048, 768, c_dtype, 13)
    ref = k1.extract_topk_plain(q, c, ids, rounds, rounds2, 128, scales)
    for _ in range(10):
        got = k1.extract_topk(q, c, ids, rounds, rounds2, 128, scales)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
