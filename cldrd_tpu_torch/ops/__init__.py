"""Hand-written CUDA kernels, each beside its plain PyTorch version.

- ``ops.extract_topk``: fused scores + two-level top-m extraction (K1).
- ``ops.fused_binmax``: fused masked scores + per-bin maxima (K2).
- ``ops.attention``: fused train attention forward (K3) and backward (K4)
  with in-kernel dropout, and the inference attention (K5).
- ``ops.ivf_probe``: scores of the probed IVF buckets (K6).
- ``ops.int8_dot``: every store tile's maximum score, in bf16, int8
  widened or native int8 (K7, the int8 A/B; on no path of the port).
- ``ops.residual_norm``: the encoder's dropout -> residual add ->
  LayerNorm, forward and backward, at every LayerNorm site.

A wrapper takes its plain version only for CPU tensors; on a CUDA tensor
it launches its kernel or raises. ``LAUNCHES`` in each module counts the
kernels' launches.
"""
from . import (
    attention,
    extract_topk,
    fused_binmax,
    int8_dot,
    ivf_probe,
    residual_norm,
)

__all__ = ["attention", "extract_topk", "fused_binmax", "int8_dot",
           "ivf_probe", "residual_norm"]
