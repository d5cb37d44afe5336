"""Atomic checkpoint / resume / warm start (port of
``cldrd_tpu/train/checkpoint.py`` in the reference's torch format).

``checkpoint_<step>.pth.tar`` holds ``{"state_dict", "optimizer",
"scheduler", "step", "epoch"}``; ``state_dict`` is the reference's
``query_encoder.*`` / ``passage_encoder.*`` layout, so both packages read
its weights (``cldrd_tpu.train.checkpoint.load_warm_start_params`` and
the port's ``models.convert``). Writes go to a temporary file, are
synced, then renamed over the target, so a preempted run never leaves a
torn checkpoint. A flax ``.msgpack`` checkpoint is not read yet.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from cldrd_tpu_torch.models.convert import (
    dual_encoder_state_dict,
    load_checkpoint as load_weights,
)


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(blob: Dict[str, Any], directory: str, step: int,
                    prefix: str = "checkpoint") -> str:
    """Write ``blob`` (tensors moved to the host) atomically to
    ``<directory>/<prefix>_<step>.pth.tar``; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{prefix}_{step}.pth.tar")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(_to_cpu(blob), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A full training checkpoint written by ``save_checkpoint``."""
    if not path.endswith(".pth.tar"):
        raise NotImplementedError(
            f"{path}: the port resumes from its own .pth.tar checkpoints; "
            "reading flax .msgpack checkpoints is not yet ported")
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_checkpoint(directory: str,
                      prefix: str = "checkpoint") -> Optional[str]:
    """The highest-step ``<prefix>_<step>.pth.tar`` in ``directory``."""
    best: Tuple[int, Optional[str]] = (-1, None)
    for path in glob.glob(os.path.join(directory, f"{prefix}_*.pth.tar")):
        m = re.search(rf"{prefix}_(\d+)\.pth\.tar$", path)
        if m and int(m.group(1)) > best[0]:
            best = (int(m.group(1)), path)
    return best[1]


def load_warm_start_params(path: str, share_weights: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """Weights only (``--model-checkpoint``): a reference or port
    ``.pth.tar`` -> the port's state_dict. ``.msgpack`` raises."""
    return dual_encoder_state_dict(load_weights(path), share_weights)
