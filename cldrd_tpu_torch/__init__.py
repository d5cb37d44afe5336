"""cldrd_tpu_torch: the PyTorch/CUDA port of cldrd_tpu for NVIDIA Hopper.

The JAX package ``cldrd_tpu`` is the reference this package is held to;
nothing here imports it or JAX. Two slices are ported:

- training: the CL-DRD curriculum (``train``, ``cli.train``,
  ``cli.curriculum``) over DistilBERT towers whose attention runs the
  hand-written CUDA kernels of ``ops.attention`` (K3/K4, and K5 for
  encoding);
- retrieval: CLS embeddings -> flat inner-product index -> exact top-k by
  bin-max selection (kernels ``extract_topk`` and ``fused_binmax``) ->
  run file -> MRR/Recall/nDCG/MAP.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
