"""The fused dropout -> residual add -> LayerNorm (ops/residual_norm.py) on
the CPU: its plain route is the unfused chain the encoder ran before, to
the bit, forward and backward; the encoder draws its dropout uniforms in
the same order and shapes as that chain did, before the route splits;
CPU tensors never reach the kernels; and the wrapper's checks refuse
what the kernels do not take. The kernels themselves are held to the
plain route on the card (tests/test_torch_kernels_cuda.py)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cldrd_tpu_torch.models import distilbert
from cldrd_tpu_torch.models.distilbert import (
    DistilBertConfig,
    DistilBertEncoder,
    DropoutRNG,
)
from cldrd_tpu_torch.ops import residual_norm as rn

EPS = 1e-12


def _unfused_dropout(rng, x, p):
    """``DropoutRNG.dropout`` as the encoder had it."""
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng.generator,
                      device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _unfused_layer_norm(self, x):
    """``LayerNorm.forward`` as the encoder had it."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + self.eps)
    return (y * self.weight + self.bias).to(x.dtype)


def _unfused_block(self, hidden, attention_mask, segment_ids=None, rng=None,
                   cls_only=False):
    """``TransformerBlock.forward`` as the encoder had it."""
    sa_out = self.attention(hidden, attention_mask, segment_ids, rng,
                            cls_only)
    if rng is not None:
        sa_out = _unfused_dropout(rng, sa_out, self.p)
    residual = hidden[:, :1] if cls_only else hidden
    hidden = self.sa_layer_norm(sa_out + residual)
    ffn = self.ffn(hidden)
    if rng is not None:
        ffn = _unfused_dropout(rng, ffn, self.p)
    return self.output_layer_norm(ffn + hidden)


def _unfuse(monkeypatch):
    monkeypatch.setattr(distilbert.LayerNorm, "forward", _unfused_layer_norm)
    monkeypatch.setattr(distilbert.TransformerBlock, "forward",
                        _unfused_block)


def _operands(dtype, rows=37, d=48, residual=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, d, generator=g).to(dtype).requires_grad_()
    r = (torch.randn(rows, d, generator=g).to(dtype).requires_grad_()
         if residual else None)
    w = (1 + 0.1 * torch.randn(d, generator=g)).requires_grad_()
    b = (0.1 * torch.randn(d, generator=g)).requires_grad_()
    return x, r, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("residual", [True, False])
def test_plain_route_equals_the_unfused_chain(dtype, p, residual):
    """Output and the gradients of x, the residual, weight and bias EQUAL
    the unfused chain's, from the same generator state."""
    x, r, w, b = _operands(dtype, residual=residual)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)
                     ).to(dtype)
    leaves = [t for t in (x, r, w, b) if t is not None]

    rng = DropoutRNG(5, 2, "cpu")
    y = rn.dropout_add_layer_norm(x, r, w, b, EPS, rng.uniforms(x, p), p)
    got = [y, *torch.autograd.grad(y, leaves, dy)]

    rng = DropoutRNG(5, 2, "cpu")
    s = _unfused_dropout(rng, x, p)
    s = s if r is None else s + r
    y0 = _unfused_layer_norm(SimpleNamespace(eps=EPS, weight=w, bias=b), s)
    ref = [y0, *torch.autograd.grad(y0, leaves, dy)]
    for a, e in zip(got, ref):
        assert a.dtype == e.dtype and torch.equal(a, e)


def _tiny_encoder(dtype, impl):
    cfg = DistilBertConfig.tiny(attention_impl=impl)
    enc = DistilBertEncoder(cfg, dtype)
    enc.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():   # biases and norms off their init values
        for prm in enc.parameters():
            prm.add_(0.05 * torch.randn(
                prm.shape, generator=torch.Generator().manual_seed(
                    prm.numel())))
    return enc.train()


def _tiny_batch(cfg, bsz=3, length=11):
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(0, cfg.vocab_size, (bsz, length), generator=g)
    mask = torch.ones(bsz, length, dtype=torch.int32)
    mask[1, 7:] = 0
    mask[2, 4:] = 0
    return ids, mask


def _forward_backward(enc, cls_only, step=0):
    ids, mask = _tiny_batch(enc.config)
    hidden = enc(ids, mask, cls_only=cls_only, rng=DropoutRNG(9, step,
                                                              "cpu"))
    loss = hidden.float().square().sum() + hidden.float()[..., 0].sum()
    grads = torch.autograd.grad(loss, list(enc.parameters()))
    return [hidden.detach(), *grads]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cls_only", [False, True])
def test_tiny_encoder_equals_the_unfused_chain(dtype, cls_only,
                                               monkeypatch):
    """The tiny config's training forward and every parameter gradient
    EQUAL the unfused encoder's (dropout 0.1 on every site)."""
    enc = _tiny_encoder(dtype, "xla")
    got = _forward_backward(enc, cls_only)
    _unfuse(monkeypatch)
    ref = _forward_backward(enc, cls_only)
    for a, e in zip(got, ref):
        assert torch.equal(a, e)


def _record_draws(monkeypatch):
    """Wrap ``torch.rand``: each call's shape and generator, and its
    output."""
    calls = []
    real = torch.rand

    def rand(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((tuple(out.shape), kwargs.get("generator"), out))
        return out

    monkeypatch.setattr(torch, "rand", rand)
    return calls


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_draws_keep_the_unfused_order(impl, monkeypatch):
    """A training forward draws the same sequence of ``torch.rand``
    shapes from the step's generator as the unfused chain, in the order
    ``portbench/reference/dropout.py`` states (embeddings, then each
    block's attention probs where drawn, attention output, FFN output),
    and the fused op receives those very draws."""
    enc = _tiny_encoder(torch.float32, impl)
    cfg = enc.config
    ids, mask = _tiny_batch(cfg)
    bsz, length = ids.shape
    handed = []
    real_op = distilbert.dropout_add_layer_norm

    def op(x, residual, weight, bias, eps, uniforms=None, p=0.0):
        handed.append(uniforms)
        return real_op(x, residual, weight, bias, eps, uniforms, p)

    monkeypatch.setattr(distilbert, "dropout_add_layer_norm", op)
    calls = _record_draws(monkeypatch)
    rng = DropoutRNG(9, 0, "cpu")
    enc(ids, mask, cls_only=True, rng=rng)
    got = [(shape, gen) for shape, gen, _ in calls]

    hidden = (bsz, length, cfg.dim)
    expected = [hidden]
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        if impl == "xla" or last:
            expected.append((bsz, cfg.n_heads, 1 if last else length,
                             length))
        row = (bsz, 1, cfg.dim) if last else hidden
        expected += [row, row]
    assert [shape for shape, _ in got] == expected
    assert all(gen is rng.generator for _, gen in got)
    drawn = [out for shape, _, out in calls
             if len(shape) == 3 and shape[-1] == cfg.dim][1:]
    fused = [u for u in handed if u is not None]
    assert len(fused) == len(drawn) == 2 * cfg.n_layers
    assert all(a is b for a, b in zip(fused, drawn))

    calls.clear()
    monkeypatch.setattr(distilbert, "dropout_add_layer_norm", real_op)
    _unfuse(monkeypatch)
    rng = DropoutRNG(9, 0, "cpu")
    enc(ids, mask, cls_only=True, rng=rng)
    assert [(shape, gen is rng.generator) for shape, gen, _ in calls] == \
        [(shape, True) for shape, _ in got]


def test_cpu_takes_the_plain_route(monkeypatch):
    """CPU tensors never reach the kernels: a training step of the tiny
    encoder (forward, backward) and an inference forward leave the launch
    counters at 0 with the launchers made to raise."""

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel launch on the CPU route")

    monkeypatch.setattr(rn, "_launch_fwd", refuse)
    monkeypatch.setattr(rn, "_launch_bwd", refuse)
    before = dict(rn.LAUNCHES)
    enc = _tiny_encoder(torch.bfloat16, "pallas")
    _forward_backward(enc, cls_only=True)
    ids, mask = _tiny_batch(enc.config)
    with torch.no_grad():
        enc.eval()(ids, mask)
    assert rn.LAUNCHES == before


def test_other_devices_raise():
    x = torch.empty(4, 16, device="meta")
    w = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="no route"):
        rn.dropout_add_layer_norm(x, None, w, w, EPS)


def _misaligned(rows, d):
    return torch.zeros(rows * d + 1, dtype=torch.bfloat16)[1:].view(rows, d)


@pytest.mark.parametrize("case,error", [
    ("width_not_multiple_of_8", ValueError),
    ("width_over_max", ValueError),
    ("float16", TypeError),
    ("float64", TypeError),
    ("non_contiguous", ValueError),
    ("misaligned", ValueError),
    ("residual_shape", ValueError),
    ("residual_dtype", ValueError),
    ("uniforms_dtype", ValueError),
    ("weight_dtype", ValueError),
    ("weight_shape", ValueError),
])
def test_check_refuses_what_the_kernels_do_not_take(case, error):
    """The checks the wrapper runs before any pointer reaches a kernel
    (on CPU tensors: the checks alone)."""
    rows, d = 6, 64
    x = torch.zeros(rows, d, dtype=torch.bfloat16)
    r = torch.zeros_like(x)
    u = torch.rand(rows, d)
    w, b = torch.ones(d), torch.zeros(d)
    rn._check(x, r, w, b, u)    # what it takes
    if case == "width_not_multiple_of_8":
        x = r = torch.zeros(rows, 100, dtype=torch.bfloat16)
        u, w, b = torch.rand(rows, 100), torch.ones(100), torch.zeros(100)
    elif case == "width_over_max":
        d = rn.MAX_DIM + 8
        x = r = torch.zeros(1, d, dtype=torch.bfloat16)
        u, w, b = torch.rand(1, d), torch.ones(d), torch.zeros(d)
    elif case == "float16":
        x = r = x.half()
    elif case == "float64":
        x = r = x.double()
    elif case == "non_contiguous":
        x = torch.zeros(d, rows, dtype=torch.bfloat16).t()
    elif case == "misaligned":
        x = _misaligned(rows, d)
    elif case == "residual_shape":
        r = torch.zeros(rows + 1, d, dtype=torch.bfloat16)
    elif case == "residual_dtype":
        r = r.float()
    elif case == "uniforms_dtype":
        u = u.to(torch.bfloat16)
    elif case == "weight_dtype":
        w = w.to(torch.bfloat16)
    elif case == "weight_shape":
        w = torch.ones(d + 8)
    with pytest.raises(error):
        rn._check(x, r, w, b, u)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_keep_mask_unpacks_one_byte_a_vector(dtype):
    """The kernels' mask layout: byte j of a row holds the keep bits of
    its j-th 16-byte vector, element e in bit e."""
    rows, d = 5, 64
    n = rn.vector_width(dtype)
    keep = torch.rand(rows, d, generator=torch.Generator().manual_seed(2)
                      ) >= 0.3
    weights = 1 << np.arange(n)
    packed = (keep.numpy().reshape(rows, d // n, n) * weights).sum(-1)
    got = rn.keep_mask(torch.from_numpy(packed.astype(np.uint8)), d, dtype)
    assert torch.equal(got, keep)


def test_inv_is_the_fp32_reciprocal_of_fp32_one_minus_p():
    """1/(1-p) as the card's ``x / (1 - p)`` multiplies by it."""
    for p in (0.1, 0.25, 0.5, 1e-3):
        expected = np.float32(1.0) / np.float32(1.0 - p)
        assert np.float32(rn._inv(p)) == expected
    assert rn._inv(0.0) == 1.0


def _rows(rows, d, dtype, residual, p, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, d, generator=g).to(dtype)
    r = torch.randn(rows, d, generator=g).to(dtype) if residual else None
    w = 1 + 0.1 * torch.randn(d, generator=g)
    b = 0.1 * torch.randn(d, generator=g)
    u = torch.rand(rows, d, generator=g) if p > 0 else None
    dy = torch.randn(rows, d, generator=g).to(dtype)
    return x, r, w, b, u, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,residual,grad", [
    (0.1, True, True), (0.0, True, True), (0.1, False, True),
    (0.0, False, True), (0.0, True, False)])
def test_compare_to_plain_holds_the_plain_route_exactly(dtype, p, residual,
                                                        grad):
    """On CPU tensors both sides are the plain route: every output the
    check reads agrees to 0, and none is left out."""
    x, r, w, b, u, dy = _rows(37, 64, dtype, residual, p)
    errs = rn.compare_to_plain(x, r, w, b, EPS, u, p, dy if grad else None)
    want = {"y"} | ({"dx", "dw", "db"} if grad else set()) | (
        {"dresidual"} if grad and residual else set())
    assert set(errs) == want
    assert all(v == 0.0 for v in errs.values())


def _off_by(fault):
    """The plain route with one planted fault, for the check to find."""
    plain = rn.dropout_add_layer_norm_plain

    def fn(x, residual, weight, bias, eps, uniforms, p):
        if fault == "mask":  # another mask: p read as 1.5 p
            return plain(x, residual, weight, bias, eps, uniforms, 1.5 * p)
        y = plain(x, residual, weight, bias, eps, uniforms, p)
        if fault == "y":  # four ulps of bf16 in one element
            return y + (y.detach().abs() * 2.0 ** -5) * (
                torch.arange(y.numel()).view(y.shape) == 7)
        if fault == "dx":  # the forward's value, kept elements' dx off
            return y + (x - x.detach()) * (uniforms >= p) * 2.0 ** -4
        if fault == "dropped":  # the forward's value, dropped ones' dx off
            return y + (x - x.detach()) * 2.0 ** -4
        if fault == "dresidual":
            return y + (residual - residual.detach()) * 2.0 ** -4
        if fault == "dw":  # the forward's value, the weight's gradient off
            return y + (weight - weight.detach()) * 2.0 ** -4
        raise ValueError(fault)
    return fn


@pytest.mark.parametrize("fault,grad,output", [
    ("y", False, "y outside"), ("y", True, "y outside"),
    ("mask", True, "y outside"),
    ("dx", True, "dx outside"), ("dropped", True, "dropped"),
    ("dresidual", True, "dresidual"), ("dw", True, "dw")])
def test_compare_to_plain_finds_a_planted_fault(fault, grad, output,
                                                monkeypatch):
    """The check is not vacuous: a fault planted in the route it holds to
    the plain version is found, in the output that carries it."""
    x, r, w, b, u, dy = _rows(37, 64, torch.bfloat16, True, 0.1)
    monkeypatch.setattr(rn, "dropout_add_layer_norm", _off_by(fault))
    with pytest.raises(AssertionError, match=output):
        rn.compare_to_plain(x, r, w, b, EPS, u, 0.1, dy if grad else None)


def test_ulp_is_the_spacing_of_the_dtype():
    x = torch.tensor([1.0, 1.5, -2.0, 3.0e-3, 1000.0])
    assert torch.equal(rn.ulp(x, torch.bfloat16),
                       torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -6,
                                     2.0 ** -16, 2.0 ** 2],
                                    dtype=torch.float64))
    assert torch.equal(rn.ulp(x, torch.float32)[:3],
                       torch.tensor([2.0 ** -23, 2.0 ** -23, 2.0 ** -22],
                                    dtype=torch.float64))
