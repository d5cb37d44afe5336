"""Hand-written CUDA kernels, each beside its plain PyTorch version.

- ``ops.extract_topk``: fused scores + two-level top-m extraction (K1).
- ``ops.fused_binmax``: fused masked scores + per-bin maxima (K2).
- ``ops.attention``: fused train attention forward (K3) and backward (K4)
  with in-kernel dropout, and the inference attention (K5).

A wrapper takes its plain version only for CPU tensors; on a CUDA tensor
it launches its kernel or raises. ``LAUNCHES`` in each module counts the
kernels' launches.
"""
from . import attention, extract_topk, fused_binmax

__all__ = ["attention", "extract_topk", "fused_binmax"]
