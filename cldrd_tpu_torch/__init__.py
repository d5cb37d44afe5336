"""cldrd_tpu_torch: the PyTorch/CUDA port of cldrd_tpu for NVIDIA Hopper.

The JAX package ``cldrd_tpu`` is the reference this package is held to;
nothing here imports it or JAX. The first slice covers the exact
retrieval path: DistilBERT towers -> CLS embeddings -> flat inner-product
index -> exact top-k by bin-max selection (hand-written CUDA kernels
``extract_topk`` and ``fused_binmax``) -> run file -> MRR/Recall/nDCG/MAP.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
