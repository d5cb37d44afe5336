"""Atomic checkpoint / resume / warm start (port of
``cldrd_tpu/train/checkpoint.py`` in the reference's torch format).

``checkpoint_<step>.pth.tar`` holds ``{"state_dict", "optimizer",
"scheduler", "step", "epoch"}``; ``state_dict`` is the reference's
``query_encoder.*`` / ``passage_encoder.*`` layout, so both packages read
its weights (``cldrd_tpu.train.checkpoint.load_warm_start_params`` and
the port's ``models.convert``). Writes go to a temporary file, are
synced, then renamed over the target, so a preempted run never leaves a
torn checkpoint. A JAX ``Trainer``'s ``checkpoint_<step>.msgpack``
(decoded by ``train/msgpack_io.py``) is read too: its ``params`` for a
warm start, and for a resume also its AdamW moments and count, and under
gradient accumulation (``optax.MultiSteps``) the accumulator.
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
    params_from_flax,
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


def _from_flax_train_state(tree: Dict[str, Any], path: str
                           ) -> Dict[str, Any]:
    """A JAX ``TrainState`` (``{params, opt_state, step, epoch}``) ->
    ``{"state_dict", "adam": {"count", "mu", "nu"}, "step", "epoch"}``,
    the moments by the port's parameter names. The opt_state is
    ``optax.chain(clip_by_global_norm, adamw)``, or that chain inside
    ``optax.MultiSteps`` (``grad_accum_steps > 1``: ``{mini_step,
    gradient_step, inner_opt_state, acc_grads, skip_state}``), whose
    accumulator comes back as ``"accum": {"mini_step", "acc"}``."""
    opt = tree["opt_state"]
    out = {"state_dict": params_from_flax(tree["params"]),
           "step": int(tree["step"]), "epoch": int(tree["epoch"])}
    if isinstance(opt, dict) and "inner_opt_state" in opt:
        out["accum"] = {"mini_step": int(opt["mini_step"]),
                        "acc": params_from_flax(opt["acc_grads"])}
        opt = opt["inner_opt_state"]
    try:
        adam = opt["1"]["0"]
        count, mu, nu = int(adam["count"]), adam["mu"], adam["nu"]
    except (KeyError, TypeError):
        raise ValueError(
            f"{path}: not the optimizer state of the JAX Trainer "
            "(optax.chain(clip_by_global_norm, adamw), optionally in "
            "optax.MultiSteps)")
    out["adam"] = {"count": count, "mu": params_from_flax(mu),
                   "nu": params_from_flax(nu)}
    return out


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A full training checkpoint: the port's (``save_checkpoint``), or a
    JAX ``Trainer``'s ``.msgpack`` (see ``_from_flax_train_state``)."""
    if path.endswith(".msgpack"):
        from .msgpack_io import load_flax_checkpoint

        return _from_flax_train_state(load_flax_checkpoint(path), path)
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
    ``.pth.tar``, or a JAX ``.msgpack`` -> the port's state_dict."""
    return dual_encoder_state_dict(load_weights(path), share_weights)
