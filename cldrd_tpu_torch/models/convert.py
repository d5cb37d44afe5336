"""Weights carried across: the JAX param tree, flax ``.msgpack``
checkpoints and the reference's and HF's torch checkpoints, into the
port's state_dicts and back (port of ``cldrd_tpu/models/hf_loader.py``).

The port's towers keep HF ``DistilBertModel`` names
(``transformer.layer.{i}.attention.q_lin.weight``, ...); a BERT tower adds
``embeddings.token_type_embeddings.weight``. HF ``BertModel`` names
(``encoder.layer.{i}.attention.self.query.weight``, ...) map onto them.

- ``params_from_flax`` / ``cross_encoder_from_flax``: the JAX
  ``NwayDualEncoder`` / ``CrossEncoder`` param trees (nested dicts of
  numpy arrays). A flax ``Dense.kernel [in, out]`` becomes
  ``Linear.weight [out, in]``; a LayerNorm ``scale`` becomes ``weight``;
  an ``Embed.embedding`` becomes ``weight``.
- ``load_checkpoint`` reads a reference ``.pth.tar`` / ``.pt`` / HF
  ``.bin`` (``weights_only=True``, ``argparse.Namespace`` allow-listed,
  unwrapped from ``{"state_dict": ...}``) as it is, and a flax
  ``.msgpack`` (``train/msgpack_io.py``; ``params`` of a JAX ``Trainer``
  checkpoint, or the root) converted to the port's names.
- ``dual_encoder_state_dict`` / ``cross_encoder_state_dict``: any of
  those layouts -> the port's model; BERT towers are told from their key
  layout (``is_bert_state_dict``), as in the reference.
- ``dual_encoder_to_reference`` / ``tower_to_hf``: the port's state_dict
  -> the reference's ``query_encoder.*`` / ``passage_encoder.*`` layout
  with HF tower names (``cli/export.py``; the trainer's checkpoints).
"""
from __future__ import annotations

import argparse
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

TOWERS = ("query_encoder", "passage_encoder")
HEADS = ("pooler", "pre_classifier", "classifier")

# HF BertModel layer names -> the port's (DistilBERT's)
_BERT_NAMES = {
    "attention.self.query": "attention.q_lin",
    "attention.self.key": "attention.k_lin",
    "attention.self.value": "attention.v_lin",
    "attention.output.dense": "attention.out_lin",
    "attention.output.LayerNorm": "sa_layer_norm",
    "intermediate.dense": "ffn.lin1",
    "output.dense": "ffn.lin2",
    "output.LayerNorm": "output_layer_norm",
}
_PORT_NAMES = {v: k for k, v in _BERT_NAMES.items()}
_HF_LAYER = re.compile(r"^encoder\.layer\.(\d+)\.(.+)\.(weight|bias)$")
_PORT_LAYER = re.compile(r"^transformer\.layer\.(\d+)\.(.+)\.(weight|bias)$")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32, order="C"))


def _strip(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in sd.items()}


# ------------------------------------------------------- the JAX trees


def _dense(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    return {"weight": np.asarray(params["kernel"]).T,
            "bias": np.asarray(params["bias"])}


def tower_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One ``DistilBertEncoder`` / ``BertEncoder`` param tree -> the
    port's tower state_dict (fp32 tensors)."""
    out: Dict[str, np.ndarray] = {}
    for key, arr in _flatten(params).items():
        parts = key.split(".")
        if key in ("embeddings.word_embeddings.embedding",
                   "embeddings.token_type_embeddings.embedding"):
            out[f"embeddings.{parts[1]}.weight"] = arr
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
    return {k: _tensor(v) for k, v in out.items()}


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``NwayDualEncoder`` params (``{query_encoder, passage_encoder}``
    or, for shared weights, ``{encoder}``) -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for tower in TOWERS:
        src = tree["encoder"] if "encoder" in tree else tree[tower]
        out.update({f"{tower}.{k}": v
                    for k, v in tower_from_flax(src).items()})
    return out


def cross_encoder_from_flax(tree: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """JAX ``CrossEncoder`` params (``{encoder, pooler | pre_classifier,
    classifier}``) -> the port's ``CrossEncoder`` state_dict."""
    out = {f"encoder.{k}": v
           for k, v in tower_from_flax(tree["encoder"]).items()}
    for head in HEADS:
        if head in tree:
            out.update({f"{head}.{k}": _tensor(v)
                        for k, v in _dense(tree[head]).items()})
    return out


def state_dict_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A decoded flax checkpoint's params -> the port's state_dict: a
    cross-encoder's (it has a classifier) or a dual encoder's."""
    return (cross_encoder_from_flax(tree) if "classifier" in tree
            else params_from_flax(tree))


# ------------------------------------------------------- HF / reference


def is_bert_state_dict(sd: Mapping[str, Any]) -> bool:
    """HF BERT layouts carry token-type embeddings and the
    ``attention.self.query`` key shape; DistilBERT has neither (the
    reference's ``_is_bert_state_dict``)."""
    return any("token_type_embeddings" in k or ".attention.self." in k
               for k in sd)


def tower_from_hf(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One HF tower state_dict (``BertModel`` or ``DistilBertModel``
    names, or the port's) -> the port's names, fp32. Keys a tower does not
    hold (``position_ids``, a pooler, heads) are dropped."""
    bert = is_bert_state_dict(sd)
    out: Dict[str, torch.Tensor] = {}
    for key, val in sd.items():
        if key.startswith("embeddings."):
            if key != "embeddings.position_ids":
                out[key] = _tensor(val)
            continue
        m = _HF_LAYER.match(key) if bert else None
        if m and m.group(2) in _BERT_NAMES:
            out[f"transformer.layer.{m.group(1)}."
                f"{_BERT_NAMES[m.group(2)]}.{m.group(3)}"] = _tensor(val)
        elif _PORT_LAYER.match(key):
            out[key] = _tensor(val)
    return out


def tower_to_hf(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's tower state_dict -> HF names: ``BertModel``'s for a BERT
    tower (it holds a token-type table), else ``DistilBertModel``'s (the
    port's own)."""
    if not any("token_type_embeddings" in k for k in sd):
        return dict(sd)
    out = {}
    for key, val in sd.items():
        m = _PORT_LAYER.match(key)
        if m:
            key = (f"encoder.layer.{m.group(1)}."
                   f"{_PORT_NAMES[m.group(2)]}.{m.group(3)}")
        out[key] = val
    return out


def _towers(state_dict: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    towers: Dict[str, Dict[str, Any]] = {t: {} for t in TOWERS}
    for key, val in _strip(state_dict, "module.").items():
        for tower in TOWERS:
            if key.startswith(tower + "."):
                towers[tower][key[len(tower) + 1:]] = val
    return towers


def dual_encoder_state_dict(state_dict: Mapping[str, Any],
                            share_weights: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """A reference-layout state_dict (DistilBERT or HF BERT tower names,
    optional ``module.`` prefix) or the port's -> the port's: non-tower
    keys dropped, values fp32. With ``share_weights`` the one tower comes
    from the query keys (or the passage keys if there are none) and fills
    both prefixes."""
    towers = _towers(state_dict)
    if share_weights:
        src = towers["query_encoder"] or towers["passage_encoder"]
        towers = {t: src for t in TOWERS}
    out = {}
    for tower, sd in towers.items():
        out.update({f"{tower}.{k}": v for k, v in tower_from_hf(sd).items()})
    return out


def dual_encoder_to_reference(state_dict: Mapping[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """The port's dual-encoder state_dict -> the reference's layout: the
    ``query_encoder.*`` / ``passage_encoder.*`` keys with HF tower names
    (BERT towers in ``BertModel`` names, which the reference's converter
    reads)."""
    out = {}
    for tower, sd in _towers(state_dict).items():
        out.update({f"{tower}.{k}": v for k, v in tower_to_hf(sd).items()})
    return out


def cross_encoder_state_dict(state_dict: Mapping[str, Any], arch: str
                             ) -> Dict[str, torch.Tensor]:
    """HF ``BertForSequenceClassification`` (``arch='bert'``) or
    ``DistilBertForSequenceClassification`` weights, optionally
    ``module.``-prefixed, or the port's ``CrossEncoder`` state_dict (from a
    ``.msgpack``) -> the port's ``CrossEncoder`` state_dict."""
    sd = _strip(state_dict, "module.")
    if any(k.startswith("encoder.embeddings.") for k in sd):
        return {k: _tensor(v) for k, v in sd.items()}
    tower = _strip(sd, "bert." if arch == "bert" else "distilbert.")
    out = {f"encoder.{k}": v for k, v in tower_from_hf(tower).items()}
    heads = ((("bert.pooler.dense", "pooler.dense"), "pooler"),
             (("classifier",), "classifier")) if arch == "bert" else \
        ((("pre_classifier",), "pre_classifier"),
         (("classifier",), "classifier"))
    for names, ours in heads:
        for name in names:
            if f"{name}.weight" in sd:
                out[f"{ours}.weight"] = _tensor(sd[f"{name}.weight"])
                out[f"{ours}.bias"] = _tensor(sd[f"{name}.bias"])
                break
    return out


def cross_encoder_to_hf(state_dict: Mapping[str, torch.Tensor], arch: str
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``CrossEncoder`` state_dict -> HF
    ``BertForSequenceClassification`` / ``DistilBertForSequenceClassification``
    names (the inverse of ``cross_encoder_state_dict``)."""
    tower = {k[len("encoder."):]: v for k, v in state_dict.items()
             if k.startswith("encoder.")}
    prefix = "bert." if arch == "bert" else "distilbert."
    out = {prefix + k: v for k, v in tower_to_hf(tower).items()}
    for head in HEADS:
        for kind in ("weight", "bias"):
            key = f"{head}.{kind}"
            if key in state_dict:
                name = "bert.pooler.dense" if head == "pooler" else head
                out[f"{name}.{kind}"] = state_dict[key]
    return out


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The weights of a checkpoint, read on the host: a reference / HF
    ``.pth.tar`` / ``.pt`` / ``.bin`` as stored (unwrapped from
    ``{"state_dict": ...}``); a flax ``.msgpack`` (a JAX ``Trainer``
    checkpoint or a bare param tree) in the port's names."""
    if path.endswith(".msgpack"):
        from cldrd_tpu_torch.train.msgpack_io import (
            flax_params,
            load_flax_checkpoint,
        )

        return state_dict_from_flax(flax_params(load_flax_checkpoint(path)))
    with torch.serialization.safe_globals([argparse.Namespace]):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return blob
