"""Weights carried across: the JAX param tree and the reference's torch
checkpoints, both into the port's HF-named ``state_dict``.

- ``params_from_flax`` takes the JAX ``NwayDualEncoder`` param tree (nested
  dicts of numpy arrays) and returns the port's state_dict. A flax
  ``Dense.kernel [in, out]`` becomes ``Linear.weight [out, in]``; a
  LayerNorm ``scale`` becomes ``weight``; an ``Embed.embedding`` becomes
  ``weight``.
- ``load_checkpoint`` reads the reference's ``.pth.tar`` / ``.pt`` layout:
  ``query_encoder.*`` / ``passage_encoder.*`` keys, an optional ``module.``
  prefix and an optional ``{"state_dict": ...}`` wrapper, loaded with
  ``weights_only=True`` and ``argparse.Namespace`` allow-listed.
- A flax ``.msgpack`` checkpoint is not yet read by the port.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Mapping

import numpy as np
import torch

TOWERS = ("query_encoder", "passage_encoder")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def tower_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One ``DistilBertEncoder`` param tree -> HF ``DistilBertModel``
    state_dict (fp32 tensors)."""
    out: Dict[str, np.ndarray] = {}
    for key, arr in _flatten(params).items():
        parts = key.split(".")
        if key == "embeddings.word_embeddings.embedding":
            out["embeddings.word_embeddings.weight"] = arr
        elif key == "embeddings.position_embeddings":
            out["embeddings.position_embeddings.weight"] = arr
        elif key in ("embeddings.LayerNorm.scale", "embeddings.LayerNorm.bias"):
            kind = "weight" if parts[2] == "scale" else "bias"
            out[f"embeddings.LayerNorm.{kind}"] = arr
        elif parts[0].startswith("layer_"):
            base = f"transformer.layer.{int(parts[0][len('layer_'):])}"
            leaf = parts[-1]
            value = arr.T if leaf == "kernel" else arr
            kind = "weight" if leaf == "kernel" else "bias"
            if parts[1] == "attention":
                out[f"{base}.attention.{parts[2]}.{kind}"] = value
            elif parts[1] in ("lin1", "lin2"):
                out[f"{base}.ffn.{parts[1]}.{kind}"] = value
            elif parts[1] in ("sa_layer_norm", "output_layer_norm"):
                kind = "weight" if parts[2] == "scale" else "bias"
                out[f"{base}.{parts[1]}.{kind}"] = arr
            else:
                raise KeyError(f"unexpected flax param {key}")
        else:
            raise KeyError(f"unexpected flax param {key}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in out.items()}


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``NwayDualEncoder`` params (``{query_encoder, passage_encoder}``
    or, for shared weights, ``{encoder}``) -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for tower in TOWERS:
        src = tree["encoder"] if "encoder" in tree else tree[tower]
        out.update({f"{tower}.{k}": v
                    for k, v in tower_from_flax(src).items()})
    return out


def dual_encoder_state_dict(state_dict: Mapping[str, Any],
                            share_weights: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """A reference-layout state_dict -> the port's: ``module.`` stripped,
    non-tower keys dropped, values fp32. With ``share_weights`` the one
    tower comes from the query keys (or the passage keys if there are
    none) and fills both prefixes."""
    towers: Dict[str, Dict[str, Any]] = {t: {} for t in TOWERS}
    for key, val in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        for tower in TOWERS:
            if key.startswith(tower + "."):
                towers[tower][key[len(tower) + 1:]] = val
    if share_weights:
        src = towers["query_encoder"] or towers["passage_encoder"]
        towers = {t: src for t in TOWERS}
    out = {}
    for tower, sd in towers.items():
        for k, v in sd.items():
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            out[f"{tower}.{k}"] = t.detach().to(torch.float32)
    return out


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The raw state_dict of a reference ``.pth.tar`` / ``.pt`` checkpoint
    (unwrapped from ``{"state_dict": ...}``), read on the host."""
    if path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: reading flax .msgpack checkpoints is not yet ported; "
            "export the weights as a .pth.tar (both packages read it)")
    with torch.serialization.safe_globals([argparse.Namespace]):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return blob
