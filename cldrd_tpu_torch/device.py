"""Device resolution and the numerics switches of the port.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``; CLIs: ``--device cpu``). When CUDA is absent and the CPU
was not asked for, they raise: nothing quietly runs on the CPU.

Numerics, stated once for the whole package: fp32 matrix products run in
true fp32 (no TF32, in cuBLAS or cuDNN), and bf16 products reduce in fp32.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and
    CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLIs: --device cpu) "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_host_async(*tensors: torch.Tensor):
    """Queue copies of device tensors into pinned host memory on their
    device's current stream; returns ``(host tensors, event)``.
    ``event.synchronize()`` waits for these copies only, not for work
    queued after them (``tensor.cpu()`` waits for the whole stream), so the
    host can use one batch's results while later batches still run. CPU
    tensors come back as they are, with event ``None``."""
    if not tensors or tensors[0].device.type != "cuda":
        return tensors, None
    dev = tensors[0].device
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    return tuple(host), done


def dtype_from_name(name: Optional[str]) -> Optional[torch.dtype]:
    """'bfloat16' | 'float32' | 'int8' -> torch dtype."""
    if name is None:
        return None
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "int8": torch.int8}[name]
