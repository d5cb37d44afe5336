"""The encoder's LayerNorm sites, fused: dropout of the branch -> residual
add -> LayerNorm, forward and backward.

``dropout_add_layer_norm(x, residual, weight, bias, eps, uniforms, p)``
is ``LayerNorm(where(uniforms >= p, x / (1 - p), 0) + residual)`` with
fp32 statistics and the output in x's dtype, as ``models/distilbert.py``
runs it after every attention and FFN branch (and, with neither residual
nor uniforms, at the embeddings). The uniforms are the caller's
``torch.rand`` draw of x's shape; the kernels only compare them with p,
so a mask is the same bits on every route.

Routes, by device alone: CPU tensors take ``dropout_add_layer_norm_plain``
(the chain as PyTorch operations, differentiated by autograd); CUDA
tensors take the kernels of ``csrc/residual_norm.cu``, the backward
through ``torch.autograd.Function`` when a gradient is wanted; any other
device raises. The kernels take bf16 or fp32 rows of any width that is a
multiple of 8 up to ``MAX_DIM``, contiguous and 16-byte aligned, fp32
``weight`` and ``bias``, and raise on anything else. Training saves the
pre-norm sum ``s``, a keep mask of one byte per 16-byte vector of x and
each row's (mean, rstd); the backward writes the residual's gradient
``ds``, the branch's ``keep ? ds / (1 - p) : 0`` and fp32 ``dw``, ``db``
without atomics.

``LAUNCHES`` counts the kernels' launches by their names' fragments:
``residual_norm_fwd``, ``residual_norm_bwd`` and ``residual_norm_dwb``
(the weight and bias gradients' second pass, one a backward).
``compare_to_plain`` holds the kernels to the plain version on card
tensors, element by element (the card tests and ``chip_smoke.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

MAX_DIM = 4096
LAUNCHES = {"fwd": 0, "bwd": 0, "dwb": 0}
# The backward's grid, and so its partial rows of dw and db, is at most
# this many blocks an SM: what an SM holds of the main path's
# instantiations (112 registers a thread, by ptxas). The kernel takes
# the cap as the partials' row count and owns no other.
BWD_BLOCKS_PER_SM = 2
_BWD_PARTS = {}  # device index -> the backward's partial rows


def dropout_add_layer_norm_plain(x, residual, weight, bias, eps: float,
                                 uniforms=None, p: float = 0.0):
    """The chain as PyTorch operations: flax ``Dropout`` of the branch
    from the given uniforms, the add, and LayerNorm with fp32 statistics
    (output in x's dtype)."""
    if uniforms is not None:
        x = torch.where(uniforms >= p, x / (1.0 - p), torch.zeros_like(x))
    s = x if residual is None else x + residual
    s32 = s.float()
    mean = s32.mean(-1, keepdim=True)
    var = (s32 - mean).square().mean(-1, keepdim=True)
    y = (s32 - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(s.dtype)


def vector_width(dtype) -> int:
    """Elements of a 16-byte vector: the bits of one byte of the mask."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def keep_mask(keep: torch.Tensor, dim: int, dtype) -> torch.Tensor:
    """The kernel's saved mask [rows, dim / vector] as bool [rows, dim]."""
    n = vector_width(dtype)
    bits = torch.arange(n, device=keep.device, dtype=torch.int32)
    out = (keep.to(torch.int32)[..., None] >> bits) & 1
    return out.reshape(keep.shape[0], dim).bool()


def _check(x, residual, weight, bias, uniforms):
    """What the kernels take: one device; x (and the residual) bf16 or
    fp32 [..., D] with D a multiple of 8 up to MAX_DIM; uniforms fp32 of
    x's shape; weight and bias fp32 [D]; every tensor contiguous and
    16-byte aligned."""
    name = "dropout_add_layer_norm"
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {x.dtype} (bf16 or fp32)")
    if x.dim() < 1:
        raise ValueError(f"{name}: x must have a row dimension")
    d = x.shape[-1]
    if d % 8 or not 8 <= d <= MAX_DIM:
        raise ValueError(f"{name}: width {d} (a multiple of 8 up to "
                         f"{MAX_DIM})")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"{name}: residual {tuple(residual.shape)} "
                         f"{residual.dtype} vs x {tuple(x.shape)} {x.dtype}")
    if uniforms is not None and (uniforms.shape != x.shape
                                 or uniforms.dtype != torch.float32):
        raise ValueError(f"{name}: uniforms must be fp32 of x's shape")
    for n, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (d,):
            raise ValueError(f"{name}: {n} must be fp32 [{d}]")
    for n, t in (("x", x), ("residual", residual), ("uniforms", uniforms),
                 ("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name}: {n} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be contiguous and 16-byte "
                             "aligned")


def _inv(p: float) -> float:
    """1/(1-p) as the card's ``x / (1 - p)`` takes it: the reciprocal of
    fp32(1 - p), in fp32."""
    return float(np.float32(1.0) / np.float32(1.0 - p))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(x, residual, weight, bias, eps: float, uniforms, p: float,
                save: bool):
    """y, and with ``save`` the backward's (s, keep, stats): s is x itself
    where nothing is added or dropped; keep is None without uniforms."""
    _check(x, residual, weight, bias, uniforms)
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    s = keep = stats = None
    if save:
        stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
        if residual is not None or uniforms is not None:
            s = torch.empty_like(x)
        if uniforms is not None:
            keep = torch.empty((rows, d // vector_width(x.dtype)),
                               dtype=torch.uint8, device=x.device)
    if rows:
        _build.launch(
            "residual_norm", "residual_norm_fwd_launch",
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
            + [ctypes.c_float] * 3,
            x.data_ptr(), _ptr(residual), _ptr(uniforms), weight.data_ptr(),
            bias.data_ptr(), y.data_ptr(), _ptr(s), _ptr(keep), _ptr(stats),
            _build.dtype_code(x.dtype), rows, d,
            float(p), _inv(p), float(eps), device=x.device)
        LAUNCHES["fwd"] += 1
    return y, (x if s is None else s), keep, stats


def _launch_bwd(dy, s, keep, stats, weight, p: float, want_ds: bool
                ) -> Tuple[Optional[torch.Tensor], ...]:
    """(dx, ds, dw, db): dx = keep ? ds / (1 - p) : 0 (None without a
    mask), ds the pre-norm sum's gradient (None unless ``want_ds``)."""
    if dy.shape != s.shape or dy.dtype != s.dtype:
        raise ValueError(f"dropout_add_layer_norm: gradient "
                         f"{tuple(dy.shape)} {dy.dtype} vs {tuple(s.shape)} "
                         f"{s.dtype}")
    dy = dy.contiguous()
    d = s.shape[-1]
    rows = stats.shape[0]
    dev = s.device
    ds = torch.empty_like(s) if want_ds else None
    dx = torch.empty_like(s) if keep is not None else None
    if not rows:
        dw = torch.zeros(d, dtype=torch.float32, device=dev)
        return dx, ds, dw, torch.zeros_like(dw)
    dw = torch.empty(d, dtype=torch.float32, device=dev)
    db = torch.empty_like(dw)
    parts = _BWD_PARTS.get(dev.index)
    if parts is None:
        parts = _BWD_PARTS[dev.index] = BWD_BLOCKS_PER_SM * \
            torch.cuda.get_device_properties(dev).multi_processor_count
    part_w = torch.empty((parts, d), dtype=torch.float32, device=dev)
    part_b = torch.empty_like(part_w)
    _build.launch(
        "residual_norm", "residual_norm_bwd_launch",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_float],
        dy.data_ptr(), s.data_ptr(), _ptr(keep), stats.data_ptr(),
        weight.data_ptr(), _ptr(ds), _ptr(dx), part_w.data_ptr(),
        part_b.data_ptr(), parts, dw.data_ptr(), db.data_ptr(),
        _build.dtype_code(s.dtype), rows, d, _inv(p), device=dev)
    LAUNCHES["bwd"] += 1
    LAUNCHES["dwb"] += 1
    return dx, ds, dw, db


class _DropoutAddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, weight, bias, uniforms, p, eps):
        y, s, keep, stats = _launch_fwd(x, residual, weight, bias, eps,
                                        uniforms, p, True)
        ctx.save_for_backward(s, keep, stats, weight)
        ctx.p, ctx.has_residual = p, residual is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        s, keep, stats, weight = ctx.saved_tensors
        dx, ds, dw, db = _launch_bwd(dy, s, keep, stats, weight, ctx.p,
                                     ctx.has_residual or keep is None)
        return (ds if keep is None else dx,
                ds if ctx.has_residual else None, dw, db, None, None, None)


def dropout_add_layer_norm(x, residual, weight, bias, eps: float,
                           uniforms: Optional[torch.Tensor] = None,
                           p: float = 0.0) -> torch.Tensor:
    """``LayerNorm(dropout(x) + residual)``: x [..., D], ``residual``
    (optional) x's shape and dtype, ``weight``/``bias`` [D], ``uniforms``
    (optional) fp32 of x's shape, kept where ``>= p``. The plain version
    on CPU tensors; on CUDA tensors the kernels, or a raise."""
    if uniforms is None:
        p = 0.0
    if x.device.type == "cpu":
        return dropout_add_layer_norm_plain(x, residual, weight, bias, eps,
                                            uniforms, p)
    if x.device.type != "cuda":
        raise ValueError(f"dropout_add_layer_norm: no route for {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, residual, weight, bias)):
        return _DropoutAddLayerNorm.apply(x, residual, weight, bias,
                                          uniforms, float(p), float(eps))
    return _launch_fwd(x, residual, weight, bias, eps, uniforms, p, False)[0]


def _outputs(fn, x, residual, weight, bias, eps: float, uniforms, p: float,
             dy=None):
    """[y], or with ``dy`` [y, then the gradients of x, the residual (None
    without one), weight and bias], of ``fn`` on fresh leaves."""
    if dy is None:
        with torch.no_grad():
            return [fn(x, residual, weight, bias, eps, uniforms, p)]
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, residual, weight, bias) if t is not None]
    rr = leaves[1] if residual is not None else None
    y = fn(leaves[0], rr, leaves[-2], leaves[-1], eps, uniforms, p)
    grads = list(torch.autograd.grad(y, leaves, dy))
    if residual is None:
        grads.insert(1, None)
    return [y.detach(), *grads]


def ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of ``dtype`` (bf16 or fp32) at |x|, in fp64 (normal
    range)."""
    mant = 7 if dtype == torch.bfloat16 else 23
    e = torch.floor(torch.log2(x.double().abs().clamp(min=2.0 ** -120)))
    return torch.exp2(e - mant)


def compare_to_plain(x, residual, weight, bias, eps: float, uniforms=None,
                     p: float = 0.0, dy=None):
    """The kernels (``dropout_add_layer_norm``; with ``dy`` forward and
    backward, through autograd) and the plain version on the same CUDA
    tensors, x [rows, D], held element by element. y and the gradients of
    x and of the residual lie within one ulp of the compute dtype plus
    what the order of the two fp32 row sums can move: ``tol`` = max(2^-14,
    D * 2^-24) of the row's largest term. Dropped elements of x's
    gradient are exactly 0 in both. dw and db lie within rows * 2^-24
    (the sum over rows in another order) plus ``tol`` of their terms'
    magnitudes. Returns each output's largest absolute error (``y``,
    ``dx``, ``dresidual``, ``dw``, ``db``); raises AssertionError naming
    an output outside its bound."""
    args = (x, residual, weight, bias, eps, uniforms, p, dy)
    got = _outputs(dropout_add_layer_norm, *args)
    ref = _outputs(dropout_add_layer_norm_plain, *args)
    dtype = x.dtype
    rows, d = x.shape
    tol = max(2.0 ** -14, d * 2.0 ** -24)
    # the statistics in fp64, for the terms' magnitudes
    s = x.double()
    if uniforms is not None:
        s = torch.where(uniforms >= p, x.float() * _inv(p), 0.).to(
            dtype).double()
    if residual is not None:
        s = (s + residual.double()).to(dtype).double()
    mean = s.mean(-1, keepdim=True)
    rstd = ((s - mean).square().mean(-1, keepdim=True) + eps).rsqrt()
    xh = (s - mean) * rstd
    del s
    w = weight.double()
    row_y = (xh.abs() * w.abs() + bias.double().abs()).amax(-1, keepdim=True)
    checks = [("y", got[0], ref[0], ulp(ref[0], dtype) + tol * row_y)]
    if dy is not None:
        _, dx, dr, dw, db = got
        _, dx0, dr0, dw0, db0 = ref
        g = dy.double() * w
        a, c = g.mean(-1, keepdim=True), (g * xh).mean(-1, keepdim=True)
        ds_bound = tol * (rstd * (g.abs() + a.abs() + (xh * c).abs())).amax(
            -1, keepdim=True)
        del g
        if residual is not None:
            checks.append(("dresidual", dr, dr0, ulp(dr0, dtype) + ds_bound))
        if uniforms is None:
            checks.append(("dx", dx, dx0, ulp(dx0, dtype) + ds_bound))
        else:
            inv = _inv(p)
            dropped = uniforms < p
            if not ((dx[dropped] == 0).all() and (dx0[dropped] == 0).all()):
                raise AssertionError("dropout_add_layer_norm: a dropped "
                                     "element's gradient is not 0")
            checks.append(("dx", dx, dx0, ulp(dx0, dtype) + inv * (
                ulp(dx0 / inv, dtype) + ds_bound)))
        dya = dy.double().abs()
        order = rows * 2.0 ** -24 + tol
        checks += [("dw", dw, dw0, order * (dya * (xh.abs() + 1)).sum(0)),
                   ("db", db, db0, order * dya.sum(0))]
    errs = {}
    for name, t, t0, bound in checks:
        err = (t.double() - t0.double()).abs()
        errs[name] = float(err.max()) if err.numel() else 0.0
        if not (err <= bound).all():
            raise AssertionError(
                f"dropout_add_layer_norm: {name} outside its bound (max "
                f"err {errs[name]:.3g}, {float((err / bound).max()):.3g} of "
                "the bound)")
    return errs
