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
launches must give the same bits. The fused dropout -> residual add ->
LayerNorm (ops/residual_norm.py) agrees with its plain version within
one ulp of the compute dtype plus what the order of its two fp32 row
sums can move, keeps exactly the elements ``torch.rand(...) >= p``
keeps, and gives the same bits twice.
"""
import ctypes

import pytest
import torch

from cldrd_tpu_torch.ops import attention as att
from cldrd_tpu_torch.ops import extract_topk as k1
from cldrd_tpu_torch.ops import fused_binmax as k2
from cldrd_tpu_torch.ops import int8_dot as k7
from cldrd_tpu_torch.ops import ivf_probe as k6
from cldrd_tpu_torch.ops import residual_norm as rn
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



# ------------------------------------------------ K7 (the int8 A/B)


def _k7_inputs(dev, bz, n, d, route, seed, normal=False):
    """Integer codes in [-127, 127] as each variant's operands (exact in
    every variant: |sum| <= 127 * 127 * 768 < 2^24); with ``normal`` the
    bf16 operands are a normal draw instead."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, dtype):
        if normal and dtype == torch.bfloat16:
            return torch.randn(shape, generator=g, device=dev).to(dtype)
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8).to(dtype)

    q_dtype, c_dtype = {v: k for k, v in k7.ROUTES.items()}[route]
    return draw((bz, d), q_dtype), draw((n, d), c_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["bf16", "int8_cast", "int8_native"])
@pytest.mark.parametrize("bz", [128, 256, 512])
@pytest.mark.parametrize("tile_rows", [128, 1024])
def test_int8_dot_equals_plain(route, bz, tile_rows):
    """Each variant's tile maxima EQUAL the plain version's on integer
    inputs; 65,536 rows give every block of the persistent grid several
    items at B=512."""
    dev = _device()
    q, c = _k7_inputs(dev, bz, 65_536, 768, route, bz + tile_rows)
    assert k7.kernel_route(q.dtype, c.dtype) == route
    before = k7.ENTRY_LAUNCHES["int8_dot_sm90_launch"]
    got = k7.tile_max_scores(q, c, tile_rows)
    ref = k7.tile_max_scores_plain(q, c, tile_rows)
    torch.cuda.synchronize()
    assert k7.ENTRY_LAUNCHES["int8_dot_sm90_launch"] == before + 1
    assert got.shape == ref.shape == (65_536 // tile_rows, bz)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["bf16", "int8_cast", "int8_native"])
@pytest.mark.parametrize("d", [128, 192, 448, 704])
def test_int8_dot_other_depths_equal_plain(route, d):
    """Depths the kernel takes besides 768; at D % 128 == 64 the native
    variant's last chunk is half past D (zero-filled by TMA)."""
    dev = _device()
    q, c = _k7_inputs(dev, 256, 8192, d, route, d)
    got = k7.tile_max_scores(q, c, 256)
    ref = k7.tile_max_scores_plain(q, c, 256)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["bf16", "int8_cast"])
def test_int8_dot_agrees_on_normal_data_and_is_deterministic(route):
    """Normal bf16 data: within 1e-5 relative of the plain version (only
    the order of the fp32 sums differs); two launches give the same
    bits."""
    dev = _device()
    q, c = _k7_inputs(dev, 512, 65_536, 768, route, 7, normal=True)
    runs = [k7.tile_max_scores(q, c, 1024) for _ in range(2)]
    ref = k7.tile_max_scores_plain(q, c, 1024)
    torch.cuda.synchronize()
    assert torch.equal(_bits(runs[0]), _bits(runs[1]))
    assert bool(((runs[0] - ref).abs() <= 1e-5 * ref.abs()).all())


@pytest.mark.cuda
def test_int8_dot_raises_on_operands_the_kernel_does_not_take():
    dev = _device()
    q, c = _k7_inputs(dev, 128, 4096, 768, "int8_cast", 1)
    for bad in (lambda: k7.tile_max_scores(q[:100], c, 128),   # B % 128
                lambda: k7.tile_max_scores(q, c, 100),         # tile % 128
                lambda: k7.tile_max_scores(q, c[:3840], 1024),  # N % tile
                lambda: k7.tile_max_scores(q, c.cpu(), 128),    # devices
                lambda: k7.tile_max_scores(q[:, :96].contiguous(),
                                           c[:, :96].contiguous(), 128)):
        with pytest.raises(ValueError):
            bad()
    for q_dtype, c_dtype in ((torch.float32, torch.int8),
                             (torch.int8, torch.bfloat16),
                             (torch.bfloat16, torch.float32)):
        with pytest.raises(TypeError):
            k7.tile_max_scores(q.to(q_dtype), c.to(c_dtype), 128)
    # the C entry point itself refuses what the wrapper never sends it
    from cldrd_tpu_torch.ops import _build

    out = torch.empty(4096 // 128, 128, device=dev)
    types = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int]
    good = dict(qd=1, cd=2, b=128, n=4096, d=768, tile=128)
    for bad in (dict(qd=0), dict(cd=0), dict(qd=2, cd=1), dict(b=100),
                dict(b=0), dict(d=832), dict(d=736), dict(d=64),
                dict(tile=100), dict(tile=384), dict(n=1 << 31)):
        a = {**good, **bad}
        with pytest.raises(RuntimeError):
            _build.launch("int8_dot_sm90", "int8_dot_sm90_launch", types,
                          q.data_ptr(), a["qd"], c.data_ptr(), a["cd"],
                          out.data_ptr(), a["b"], a["n"], a["d"], a["tile"],
                          device=dev)

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


# ------------------------------------------- K5 on Hopper (short and d64)


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
@pytest.mark.parametrize("length", [65, 100, 128, 256])
def test_infer_sm90_route_equals_plain(length):
    """bf16 K5 at 64 < L <= 256, the sm90 forward's route until
    attention_infer_d64.cu took it, launches the head_dim-64 kernel: within
    2e-2 of the plain version, EQUAL on exact inputs, each counted on
    attn_infer_d64_launch and none on the sm90 forward."""
    dev = _device()
    q, k, v, _, mask, _ = _attn_inputs(dev, 16, length, 12, 64,
                                       torch.bfloat16, False, 4)
    mask = _query_tower_mask(dev, 16, length,
                             torch.Generator(device=dev).manual_seed(3))
    before = dict(att.ENTRY_LAUNCHES)
    out = att.flash_attention(q, k, v, mask)
    ref = att.attention_plain(q, k, v, mask)
    zq = torch.zeros_like(q)
    pos = torch.arange(length, device=dev)
    hot = (pos[:, None] % 64 == torch.arange(64, device=dev)[None, :])
    hot = hot[None, :, None, :].expand(q.shape).to(q.dtype).contiguous()
    out_x = att.flash_attention(zq, k, hot, mask)
    ref_x = att.attention_plain(zq, k, hot, mask)
    torch.cuda.synchronize()
    assert att.ENTRY_LAUNCHES["attn_infer_d64_launch"] == \
        before["attn_infer_d64_launch"] + 2
    assert att.ENTRY_LAUNCHES["attn_fwd_sm90_launch"] == \
        before["attn_fwd_sm90_launch"]
    assert _rel(out, ref) <= 2e-2
    assert torch.equal(out_x, ref_x)


def _pair_mask(dev, b, length, g):
    """Keys padded as the teacher's (query, passage) pairs are: 24-140
    real tokens of 256."""
    n = torch.randint(24, 141, (b, 1), generator=g, device=dev)
    return (torch.arange(length, device=dev)[None] < n).int()


def _exact_forms(dev, shape, form):
    """q, k, v on which every score of a row is equal (q = 0 and k
    one-hot, or q one-hot and every key e_0) and v is one-hot over dims
    by key position: each probability is 1/l rounded once."""
    length, d = shape[1], shape[3]
    pos = torch.arange(length, device=dev)
    hot = (pos[:, None] % d == torch.arange(d, device=dev)[None, :])
    hot = hot[None, :, None, :].expand(shape).to(torch.bfloat16).contiguous()
    zero = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    if form == "q0":
        return zero, hot, hot
    e0 = zero.clone()
    e0[..., 0] = 1
    return hot, e0, hot


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["d32", "tiled"])
@pytest.mark.parametrize("form", ["normal", "q0", "k0"])
def test_infer_tiled_route_at_the_teacher_shape(form, route):
    """The MiniLM teacher's K5 launches (bf16, B=128, L=256, H=12, D=32,
    pair padding) take attention_infer_d32.cu; attention.cu's tiled
    forward, which they took before, stays held when forced. Both within
    2e-2 of the plain version on normal data and EQUAL to it on exact
    inputs."""
    dev = _device()
    b, length, h, d = 128, 256, 12, 32
    g = torch.Generator(device=dev).manual_seed(32)
    shape = (b, length, h, d)
    mask = _pair_mask(dev, b, length, g)
    if form == "normal":
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
    else:
        q, k, v = _exact_forms(dev, shape, form)
    assert att._kernel_route(torch.bfloat16, length, d, "infer") == "d32"
    entry = "attn_fwd_launch" if route == "tiled" else "attn_infer_d32_launch"
    saved = att._kernel_route
    if route == "tiled":
        att._kernel_route = lambda *a: "tiled"
    before = dict(att.ROUTE_LAUNCHES)
    try:
        out = att.flash_attention(q, k, v, mask)
    finally:
        att._kernel_route = saved
    ref = att.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    for key, count in att.ROUTE_LAUNCHES.items():
        assert count == before[key] + (key == ("infer", entry))
    assert ref.abs().max() > 0
    if form == "normal":
        assert _rel(out, ref) <= 2e-2
    else:
        assert torch.equal(out, ref)


def _d32_mask(dev, b, length, g, kind):
    """K5 masks for the head_dim-32 and -64 kernels: "pairs", a prefix of
    1..L real keys a row and row 1 with none; "holes", scattered real keys
    (values 1, 2, -1: the test is != 0) with whole 16-key tiles empty and
    the last of two or more rows with none; "none", no real key in any row
    (the reference gives 1/L over every key)."""
    if kind == "pairs":
        n = torch.randint(1, length + 1, (b, 1), generator=g, device=dev)
        mask = (torch.arange(length, device=dev)[None] < n).int()
        mask[1:2] = 0
    elif kind == "holes":
        val = torch.tensor([1, 2, -1], dtype=torch.int32, device=dev)
        pick = torch.randint(0, 3, (b, length), generator=g, device=dev)
        keep = torch.rand(b, length, generator=g, device=dev) < 0.15
        tile = torch.arange(length, device=dev) // 16
        keep &= (tile % 3 != 1)[None]
        mask = torch.where(keep, val[pick], torch.zeros_like(pick).int())
        if b > 1:
            mask[-1] = 0
    else:
        mask = torch.zeros(b, length, dtype=torch.int32, device=dev)
    return mask.int()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pairs", "holes", "none"])
@pytest.mark.parametrize("b", [1, 3, 128])
@pytest.mark.parametrize("length", [1, 17, 64, 100, 255, 256])
def test_infer_d32_equals_plain(length, b, kind):
    """bf16 K5 at head_dim 32 and L <= 256 takes attention_infer_d32.cu:
    within 2e-2 of the largest magnitude of the plain version on normal
    data (one bf16 ulp of a probability near 1), EQUAL to it on exact
    inputs, with all-masked rows and masks with holes."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(length * 7 + b)
    shape = (b, length, 12, 32)
    mask = _d32_mask(dev, b, length, g, kind)
    q, k, v = (torch.randn(shape, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    before = att.ENTRY_LAUNCHES["attn_infer_d32_launch"]
    out = att.flash_attention(q, k, v, mask)
    ref = att.attention_plain(q, k, v, mask)
    exact = [(att.flash_attention(*x, mask), att.attention_plain(*x, mask))
             for x in (_exact_forms(dev, shape, f) for f in ("q0", "k0"))]
    torch.cuda.synchronize()
    assert att.ENTRY_LAUNCHES["attn_infer_d32_launch"] == before + 3
    assert torch.isfinite(out.float()).all()
    assert _rel(out, ref) <= 2e-2
    for got, want in exact:
        assert want.abs().max() > 0
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [17, 100, 256])
def test_infer_d32_ignores_masked_key_rows(length):
    """Large finite garbage in the K and V rows of masked keys leaves every
    row with a real key EQUAL (its padded key tiles are skipped, its other
    masked keys weigh exactly 0); an all-masked row takes the garbage, as
    the plain version does."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(length)
    shape = (64, length, 12, 32)
    mask = _d32_mask(dev, 64, length, g, "holes")
    q, k, v = (torch.randn(shape, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    masked = (mask == 0)[:, :, None, None]
    kg, vg = (torch.where(masked, (torch.rand(shape, generator=g, device=dev)
                                   - 0.5).mul(6e4).to(torch.bfloat16), x)
              for x in (k, v))
    out = att.flash_attention(q, k, v, mask)
    out_g = att.flash_attention(q, kg, vg, mask)
    ref_g = att.attention_plain(q, kg, vg, mask)
    torch.cuda.synchronize()
    real = (mask != 0).any(1)
    assert real.any() and not real.all()
    assert torch.equal(out_g[real], out[real])
    assert _rel(out_g, ref_g) <= 2e-2
    assert not torch.equal(out_g[~real], out[~real])


@pytest.mark.cuda
def test_infer_d32_is_deterministic_and_checks_alignment():
    """Ten launches at the teacher's shape give the same bits; an operand
    off a 16-byte boundary raises before any launch."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(10)
    shape = (128, 256, 12, 32)
    q, k, v = (torch.randn(shape, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    mask = _pair_mask(dev, 128, 256, g)
    first = att.flash_attention(q, k, v, mask)
    for _ in range(9):
        assert torch.equal(att.flash_attention(q, k, v, mask), first)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    off = flat[1:].view(shape)
    off.copy_(q)
    before = att.ENTRY_LAUNCHES["attn_infer_d32_launch"]
    with pytest.raises(ValueError, match="aligned"):
        att.flash_attention(off, k, v, mask)
    assert att.ENTRY_LAUNCHES["attn_infer_d32_launch"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pairs", "holes", "none"])
@pytest.mark.parametrize("b", [1, 3, 128])
@pytest.mark.parametrize("length", [65, 100, 128, 129, 255, 256])
def test_infer_d64_equals_plain(length, b, kind):
    """bf16 K5 at head_dim 64 and 64 < L <= 256 takes
    attention_infer_d64.cu (its 8-tile build up to L=128, its 16-tile one
    past it): within 2e-2 of the largest magnitude of the plain version
    on normal data (one bf16 ulp of a probability near 1), EQUAL to it on
    exact inputs, with prefix masks, masks with holes and all-masked
    rows."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(length * 7 + b + 64)
    shape = (b, length, 12, 64)
    mask = _d32_mask(dev, b, length, g, kind)
    q, k, v = (torch.randn(shape, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    before = att.ENTRY_LAUNCHES["attn_infer_d64_launch"]
    out = att.flash_attention(q, k, v, mask)
    ref = att.attention_plain(q, k, v, mask)
    exact = [(att.flash_attention(*x, mask), att.attention_plain(*x, mask))
             for x in (_exact_forms(dev, shape, f) for f in ("q0", "k0"))]
    torch.cuda.synchronize()
    assert att.ENTRY_LAUNCHES["attn_infer_d64_launch"] == before + 3
    assert torch.isfinite(out.float()).all()
    assert _rel(out, ref) <= 2e-2
    for got, want in exact:
        assert want.abs().max() > 0
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [65, 128, 256])
def test_infer_d64_ignores_masked_key_rows(length):
    """Large finite garbage in the K and V rows of masked keys leaves every
    row with a real key EQUAL (its padded key tiles are skipped, its other
    masked keys weigh exactly 0); an all-masked row takes the garbage, as
    the plain version does."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(length + 64)
    shape = (64, length, 12, 64)
    mask = _d32_mask(dev, 64, length, g, "holes")
    q, k, v = (torch.randn(shape, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    masked = (mask == 0)[:, :, None, None]
    kg, vg = (torch.where(masked, (torch.rand(shape, generator=g, device=dev)
                                   - 0.5).mul(6e4).to(torch.bfloat16), x)
              for x in (k, v))
    out = att.flash_attention(q, k, v, mask)
    out_g = att.flash_attention(q, kg, vg, mask)
    ref_g = att.attention_plain(q, kg, vg, mask)
    torch.cuda.synchronize()
    real = (mask != 0).any(1)
    assert real.any() and not real.all()
    assert torch.equal(out_g[real], out[real])
    assert _rel(out_g, ref_g) <= 2e-2
    assert not torch.equal(out_g[~real], out[~real])


@pytest.mark.cuda
@pytest.mark.parametrize("length", [128, 256])
def test_infer_d64_is_deterministic_and_checks_alignment(length):
    """Ten launches at a passage bucket's shape give the same bits; an
    operand off a 16-byte boundary raises before any launch."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(length + 10)
    shape = (512 * 256 // length, length, 12, 64)
    q, k, v = (torch.randn(shape, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    mask = _d32_mask(dev, shape[0], length, g, "pairs")
    first = att.flash_attention(q, k, v, mask)
    for _ in range(9):
        assert torch.equal(att.flash_attention(q, k, v, mask), first)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    off = flat[1:].view(shape)
    off.copy_(q)
    before = att.ENTRY_LAUNCHES["attn_infer_d64_launch"]
    with pytest.raises(ValueError, match="aligned"):
        att.flash_attention(off, k, v, mask)
    assert att.ENTRY_LAUNCHES["attn_infer_d64_launch"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["normal", "holes"])
def test_infer_short_and_d64_agree_across_padding(form):
    """A passage whose real tokens fit in 64 gives the same bits in every
    length bucket: the short-row kernel at L=64 (its 32 first tokens at
    L=32) and attention_infer_d64.cu at L=128 and 256 share the K5
    softmax of attn_common.cuh, and padded keys weigh exactly 0, so the
    rows of the shorter launch EQUAL the same rows of the longer ones."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(2024)
    b, h = 64, 12
    q, k, v = (torch.randn(b, 256, h, 64, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    n = torch.randint(1, 65, (b, 1), generator=g, device=dev)
    mask = (torch.arange(256, device=dev)[None] < n).int()
    if form == "holes":
        mask = mask * (torch.rand(b, 256, generator=g, device=dev)
                       < 0.7).int()
        mask[:, 0] = 1
    short_n = (n <= 32).squeeze(1)
    outs = {}
    for length in (32, 64, 128, 256):
        sl = slice(0, length)
        outs[length] = att.flash_attention(
            q[:, sl].contiguous(), k[:, sl].contiguous(),
            v[:, sl].contiguous(), mask[:, sl].contiguous())
    torch.cuda.synchronize()
    for length in (128, 256):
        assert torch.equal(outs[length][:, :64], outs[64])
        assert torch.equal(outs[length][short_n, :32], outs[32][short_n])
    assert torch.equal(outs[256][:, :128], outs[128])


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
    (torch.bfloat16, 65, 64, "attn_infer_d64_launch"),
    (torch.bfloat16, 256, 64, "attn_infer_d64_launch"),
    (torch.bfloat16, 257, 64, "attn_fwd_launch"),
    (torch.float32, 30, 64, "attn_fwd_launch"),
    (torch.bfloat16, 30, 32, "attn_infer_d32_launch"),
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
    hgmma = {name.split("-")[0]: n["HGMMA"] for name, n in counts.items()}
    igmma = {name.split("-")[0]: n["IGMMA"] for name, n in counts.items()}
    assert hgmma["extract_topk_sm90"] > 0 and hgmma["attention_sm90"] > 0
    assert hgmma["fused_binmax_sm90"] > 0
    assert hgmma["attention_infer_d64"] > 0
    # K7: bf16 products (bf16, int8_cast) and s8 ones (int8_native)
    assert hgmma["int8_dot_sm90"] > 0 and igmma["int8_dot_sm90"] > 0


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


# the length buckets' shapes (data/bucketing.py's default ladder at batch
# 512, L 256 for the passage tower, head_dim 64, and batch 128, L 256 for
# the MiniLM teacher, head_dim 32): (B, L, head_dim, route)
_LADDER = ([(512 * 256 // n, n, 64, "short" if n <= 64 else "d64")
            for n in (32, 64, 128, 256)]
           + [(128 * 256 // n, n, 32, "d32") for n in (32, 64, 128, 256)])
_ROUTE_ENTRY = {"short": "attn_infer_short_launch",
                "d64": "attn_infer_d64_launch",
                "d32": "attn_infer_d32_launch"}


@pytest.mark.cuda
@pytest.mark.parametrize("b,length,d,route", _LADDER,
                         ids=[f"{b}x{n}_d{d}" for b, n, d, _ in _LADDER])
@pytest.mark.parametrize("form", ["normal", "q0", "k0"])
def test_infer_at_the_bucket_ladder_equals_plain(b, length, d, route, form):
    """K5 at every length bucket's shape, through the route
    _kernel_route gives it, with a bucket's padding: rows past the next
    shorter bucket, one row with no real key and the last eighth of the
    batch all padding (a bucket's partial last batch). Within 2e-2 of
    the plain version on normal data, EQUAL on the exact forms."""
    dev = _device()
    assert att._kernel_route(torch.bfloat16, length, d, "infer") == route
    g = torch.Generator(device=dev).manual_seed(length + d)
    shape = (b, length, 12, d)
    n = torch.randint(length // 2 + 1, length + 1, (b, 1), generator=g,
                      device=dev)
    mask = (torch.arange(length, device=dev)[None] < n).int()
    mask[1] = 0
    mask[b - b // 8:] = 0
    if form == "normal":
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
    else:
        q, k, v = _exact_forms(dev, shape, form)
    before = att.ROUTE_LAUNCHES[("infer", _ROUTE_ENTRY[route])]
    out = att.flash_attention(q, k, v, mask)
    ref = att.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert att.ROUTE_LAUNCHES[("infer", _ROUTE_ENTRY[route])] == before + 1
    assert torch.isfinite(out.float()).all()
    if form == "normal":
        assert _rel(out, ref) <= 2e-2
    else:
        assert ref.abs().max() > 0 and torch.equal(out, ref)


@pytest.mark.cuda
def test_token_ids_widen_on_the_card():
    """The encoder's host-to-card token copy: ids packed in two bytes
    (uint16 sent as int16) come back on the card as the same ids, those
    at and above 32,768 included; the mask in one byte."""
    import numpy as np

    from cldrd_tpu_torch.index.builder import _to_device, compact_tokens

    dev = _device()
    ids = np.array([[0, 1, 32_767, 32_768, 40_000, 65_535]], np.int32)
    mask = np.array([[1, 1, 1, 0, 1, 0]], np.int32)
    packed = compact_tokens({"input_ids": ids, "attention_mask": mask})
    assert packed["input_ids"].dtype == np.uint16
    got_ids = _to_device(packed["input_ids"], dev)
    got_mask = _to_device(packed["attention_mask"], dev)
    assert got_ids.device.type == "cuda" and got_ids.dtype == torch.int64
    assert got_ids.cpu().numpy().tolist() == ids.tolist()
    assert got_mask.cpu().numpy().tolist() == mask.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("ladder", [None, ()], ids=["flat", "bucketed"])
def test_build_index_on_device_int8_equals_build_quantized(ladder):
    """build_index_on_device quantizes each batch on the card: its rows,
    scales, ids and searches EQUAL FlatIPIndex.build_quantized over the
    same embeddings quantized on the host; rows never written keep id -1
    and a finite scale."""
    import numpy as np

    from cldrd_tpu_torch.data.sequence_dataset import SequenceBatch
    from cldrd_tpu_torch.index import (
        FlatIPIndex,
        build_index_on_device,
        quantize_rows,
    )

    dev = _device()
    rng = np.random.default_rng(0)
    n, d, width = 3000, 128, 64
    lens = rng.integers(1, width + 1, n)
    mask = (np.arange(width)[None] < lens[:, None]).astype(np.int32)
    tokens = rng.integers(1, 30_000, (n, width)).astype(np.int32) * mask
    table = torch.randn(30_000, d, generator=torch.Generator().manual_seed(1))

    class Corpus:
        max_length = width

        def __len__(self):
            return n

        def batches(self, bz):
            for s in range(0, n, bz):
                nv = min(bz, n - s)
                t = np.zeros((bz, width), np.int32)
                m = np.zeros((bz, width), np.int32)
                i = np.full((bz,), -1, np.int64)
                t[:nv], m[:nv] = tokens[s:s + nv], mask[s:s + nv]
                i[:nv] = np.arange(s, s + nv) * 3
                yield SequenceBatch({"input_ids": t, "attention_mask": m},
                                    i, nv)

    w = table.to(dev)

    def encode(tok):  # a mean of token rows; all-padding rows give zeros
        ids = torch.from_numpy(tok["input_ids"]).to(dev).long()
        m = torch.from_numpy(tok["attention_mask"]).to(dev).float()
        return (w[ids] * m[..., None]).sum(1) / m.sum(1, keepdim=True).clamp(
            min=1)

    index = build_index_on_device(encode, Corpus(), 256, d,
                                  dtype=torch.int8, block_rows=2048,
                                  bucket_lengths=ladder, device=dev)
    order, embs = [], []
    from cldrd_tpu_torch.index.builder import _batch_stream

    for batch in _batch_stream(Corpus(), 256, ladder)[0]:
        embs.append(encode(batch.tokens)[:batch.n_valid].cpu().numpy())
        order.append(batch.ids[:batch.n_valid])
    embs, order = np.concatenate(embs), np.concatenate(order)
    codes, scales = quantize_rows(embs)
    ref = FlatIPIndex.build_quantized(codes, scales, order, block_rows=2048,
                                      device=dev)
    assert torch.equal(index.row_ids[:n], ref.row_ids[:n])
    assert bool((index.row_ids[n:] == -1).all())
    assert torch.equal(index.embeddings[:n], ref.embeddings[:n])
    assert torch.equal(index.row_scales[:n], ref.row_scales[:n])
    assert bool(torch.isfinite(index.row_scales).all())
    q = torch.randn(128, d, generator=torch.Generator().manual_seed(2))
    got, want = index.search(q, 100), ref.search(q, 100)
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[0], want[0])


@pytest.mark.cuda
def test_quantize_rows_on_the_card_equals_numpy():
    """Per-row int8 quantization on the card gives the host's (numpy)
    codes and scales bit for bit: the scale is a true quotient (a
    Python-scalar divisor is applied on CUDA as a product with its
    reciprocal, which rounds some scales, and so codes, otherwise)."""
    import numpy as np

    from cldrd_tpu_torch.index import quantize_rows

    dev = _device()
    c = np.random.default_rng(3).standard_normal((65_536, 96)).astype(
        np.float32)
    c[7] = 0.0  # a zero row: scale 1
    codes, scales = quantize_rows(torch.from_numpy(c).to(dev))
    want_codes, want_scales = quantize_rows(c)
    assert np.array_equal(scales.cpu().numpy(), want_scales)
    assert np.array_equal(codes.cpu().numpy(), want_codes)


@pytest.mark.cuda
def test_trace_holds_one_k1_kernel_event_per_launch(tmp_path):
    """utils.profiling.trace around one K1 launch on the card writes one
    kernel event of the function the route names (KERNEL_NAMES), on the
    launching device, and none of the other route's."""
    import re

    from cldrd_tpu_torch.utils.profiling import read_trace, trace

    dev = _device()
    q, c, ids, scales = _inputs(dev, 512, 16 * 2048, 768, torch.int8, 4)
    route = k1.kernel_route(q.dtype, c.dtype, 768, 128)
    assert route == "sm90"
    k1.extract_topk(q, c, ids, 5, 8, 128, scales)  # build and load first
    torch.cuda.synchronize()
    before = k1.LAUNCHES
    with trace(str(tmp_path)):
        k1.extract_topk(q, c, ids, 5, 8, 128, scales)
    assert k1.LAUNCHES == before + 1
    kernels = [e for e in read_trace(str(tmp_path))
               if e.get("cat") == "kernel"]
    by_route = {r: [e for e in kernels
                    if re.search(rf"\b{name}\b", e["name"])]
                for r, name in k1.KERNEL_NAMES.items()}
    assert len(by_route[route]) == 1, [e["name"] for e in kernels]
    assert by_route["generic"] == []
    assert by_route[route][0]["args"]["device"] == torch.cuda.current_device()


@pytest.mark.cuda
def test_trace_holds_every_shards_search_kernels(tmp_path):
    """trace around a sharded search over every visible GPU (two shards
    of cuda:0 with one) holds one K1 kernel event a shard, each on its
    shard's device: the trace waits for every device before it stops."""
    import collections
    import re

    from cldrd_tpu_torch.parallel import CORPUS_AXIS, Mesh, make_mesh
    from cldrd_tpu_torch.parallel import shard_rows
    from cldrd_tpu_torch.utils.profiling import read_trace, trace

    _device()
    n_gpu = torch.cuda.device_count()
    mesh = (make_mesh(n_gpu, CORPUS_AXIS) if n_gpu > 1
            else Mesh((torch.device("cuda", 0),) * 2, CORPUS_AXIS))
    n = mesh.size * 16 * 2048
    g = torch.Generator().manual_seed(5)
    codes = torch.randint(-127, 128, (n, 768), generator=g,
                          dtype=torch.int8)
    scales = torch.rand(n, generator=g) + 0.5
    ids = torch.arange(n, dtype=torch.int32)
    q = torch.randint(-4, 5, (512, 768), generator=g).to(
        mesh.devices[0], torch.bfloat16)
    c, i, s = (shard_rows(x, mesh) for x in (codes, ids, scales))
    mips.sharded_topk(q, c, i, 100, mesh, row_scales=s)  # build and load
    for d in set(mesh.devices):
        torch.cuda.synchronize(d)
    before = k1.LAUNCHES, k2.LAUNCHES
    with trace(str(tmp_path)):
        mips.sharded_topk(q, c, i, 100, mesh, row_scales=s)
    assert (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1]) == (
        mesh.size, 0)  # K1's extract route, once a shard
    names = [*k1.KERNEL_NAMES.values(), *k2.KERNEL_NAMES.values()]
    search = re.compile(r"\b(?:%s)\b" % "|".join(names))
    by_dev = collections.Counter(
        int(e["args"]["device"]) for e in read_trace(str(tmp_path))
        if e.get("cat") == "kernel" and search.search(e["name"]))
    assert by_dev == collections.Counter(d.index for d in mesh.devices)


# ------------------------- dropout -> residual add -> LayerNorm (fused)

RN_EPS = 1e-12


def _rn_operands(dev, rows, d, dtype, residual, p, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, d, generator=g, device=dev).to(dtype)
    r = (torch.randn(rows, d, generator=g, device=dev).to(dtype)
         if residual else None)
    w = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    b = 0.1 * torch.randn(d, generator=g, device=dev)
    u = torch.rand(rows, d, generator=g, device=dev) if p > 0 else None
    dy = torch.randn(rows, d, generator=g, device=dev).to(dtype)
    return x, r, w, b, u, dy


def _rn_check(x, r, w, b, u, p, dy):
    """The kernels against the plain version on the same CUDA tensors,
    forward and backward, within ``residual_norm.compare_to_plain``'s
    bounds: one ulp of the compute dtype plus what the two fp32 row sums'
    order can move (y, dx, the residual's gradient); the sum over rows in
    another order (dw, db); dropped elements of dx exactly 0."""
    before = dict(rn.LAUNCHES)
    rn.compare_to_plain(x, r, w, b, RN_EPS, u, p, dy)
    torch.cuda.synchronize()
    assert rn.LAUNCHES["fwd"] == before["fwd"] + 1
    assert rn.LAUNCHES["bwd"] == before["bwd"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [384, 768])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("residual", [True, False])
def test_residual_norm_equals_plain(dtype, d, p, residual):
    """The encoder's widths (DistilBERT 768, MiniLM 384) at an odd number
    of rows, with and without dropout and residual."""
    dev = _device()
    x, r, w, b, u, dy = _rn_operands(dev, 1001, d, dtype, residual, p, d)
    _rn_check(x, r, w, b, u, p, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [384, 768])
def test_residual_norm_inference_equals_plain(dtype, d):
    """No gradient wanted (the teacher's sites, the query encode's): the
    forward alone, saving nothing, against the plain version."""
    dev = _device()
    x, r, w, b, _, _ = _rn_operands(dev, 1001, d, dtype, True, 0.0, d + 1)
    before = dict(rn.LAUNCHES)
    rn.compare_to_plain(x, r, w, b, RN_EPS)
    torch.cuda.synchronize()
    assert rn.LAUNCHES["fwd"] == before["fwd"] + 1
    assert rn.LAUNCHES["bwd"] == before["bwd"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 32, 264, 1024, 2056, 4096])
def test_residual_norm_generic_widths_equal_plain(dtype, d):
    """Widths without their own instantiation: any multiple of 8 up to
    4096, with dropout and residual."""
    dev = _device()
    x, r, w, b, u, dy = _rn_operands(dev, 67, d, dtype, True, 0.1, d)
    _rn_check(x, r, w, b, u, 0.1, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_residual_norm_masks_are_the_torch_rand_draws(dtype):
    """The saved mask EQUALS ``torch.rand(...) >= p`` drawn again from the
    same generator state, bit for bit."""
    dev = _device()
    rows, d, p = 2049, 768, 0.1
    x, r, w, b, _, _ = _rn_operands(dev, rows, d, dtype, True, 0.0, 5)
    gen = torch.Generator(device=dev).manual_seed(2 ** 40 + 7)
    state = gen.get_state()
    u = torch.rand((rows, d), generator=gen, device=dev)
    _, _, keep, _ = rn._launch_fwd(x, r, w, b, RN_EPS, u, p, True)
    gen.set_state(state)
    expected = torch.rand((rows, d), generator=gen, device=dev) >= p
    torch.cuda.synchronize()
    assert torch.equal(rn.keep_mask(keep, d, dtype), expected)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 768])
def test_residual_norm_is_deterministic(d):
    """Two launches, forward and backward, give the same bits."""
    dev = _device()
    x, r, w, b, u, dy = _rn_operands(dev, 4099, d, torch.bfloat16, True,
                                     0.1, 9)
    runs = [rn._outputs(rn.dropout_add_layer_norm, x, r, w, b, RN_EPS, u,
                        0.1, dy) for _ in range(2)]
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(a.view(bits), c.view(bits))


@pytest.mark.cuda
def test_residual_norm_raises_on_operands_the_kernels_do_not_take():
    dev = _device()
    rows, d = 8, 768
    x, r, w, b, u, _ = _rn_operands(dev, rows, d, torch.bfloat16, True,
                                    0.1, 1)
    fn = rn.dropout_add_layer_norm
    bad = [
        (torch.zeros(rows, 100, dtype=torch.bfloat16, device=dev), None,
         torch.ones(100, device=dev), torch.zeros(100, device=dev), None),
        (torch.zeros(rows, 4104, dtype=torch.bfloat16, device=dev), None,
         torch.ones(4104, device=dev), torch.zeros(4104, device=dev), None),
        (x.half(), None, w, b, None),
        (x.double(), None, w, b, None),
        (torch.zeros(d, rows, dtype=torch.bfloat16, device=dev).t(), None,
         w, b, None),
        (torch.zeros(rows * d + 1, dtype=torch.bfloat16,
                     device=dev)[1:].view(rows, d), None, w, b, None),
        (x, r.float(), w, b, None),
        (x, r, w.to(torch.bfloat16), b, None),
        (x, r, w.cpu(), b, None),
        (x, r, w, b, u.to(torch.bfloat16)),
    ]
    before = dict(rn.LAUNCHES)
    for xx, rr, ww, bb, uu in bad:
        with pytest.raises((TypeError, ValueError)):
            fn(xx, rr, ww, bb, RN_EPS, uu, 0.1)
    assert rn.LAUNCHES == before


@pytest.mark.cuda
def test_encoder_takes_the_kernel_at_every_layer_norm():
    """A DistilBERT-shaped encoder on the card: a training step launches
    the fused forward and backward once a site (the embeddings, two a
    block); an inference forward the forward alone."""
    from cldrd_tpu_torch.models.distilbert import (
        DistilBertConfig,
        DistilBertEncoder,
        DropoutRNG,
    )

    dev = _device()
    cfg = DistilBertConfig.tiny(dim=768, n_heads=12, hidden_dim=3072,
                                n_layers=2, attention_impl="pallas")
    enc = DistilBertEncoder(cfg, torch.bfloat16).to(dev)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (6, 64), device=dev)
    mask = torch.ones(6, 64, dtype=torch.int32, device=dev)
    mask[1, 30:] = 0
    sites = 1 + 2 * cfg.n_layers
    before = dict(rn.LAUNCHES)
    hidden = enc.train()(ids, mask, cls_only=True,
                         rng=DropoutRNG(3, 0, dev))
    hidden.float().square().sum().backward()
    torch.cuda.synchronize()
    assert rn.LAUNCHES["fwd"] == before["fwd"] + sites
    assert rn.LAUNCHES["bwd"] == before["bwd"] + sites
    assert all(torch.isfinite(prm.grad).all() for prm in enc.parameters())
    before = dict(rn.LAUNCHES)
    with torch.no_grad():
        out = enc.eval()(ids, mask)
    torch.cuda.synchronize()
    assert rn.LAUNCHES["fwd"] == before["fwd"] + sites
    assert rn.LAUNCHES["bwd"] == before["bwd"]
    assert torch.isfinite(out.float()).all()
