"""Drivers: one module per entry of the port that a traffic mix drives.
A traffic file names its driver (``"driver": "retrieve"``); the driver
reads the mix's parameters, makes the inputs from the seed, builds the
port's objects, warms up, runs the window and, after it, compares the
window's outputs with the reference. ``run(run) -> dict`` returns the
work counts, the end-to-end metrics, the shapes the per-layer readers
need, and ``check``, the comparison, called once the port's state is
freed. Where it takes the window's time it calls ``run.close_spans()``.
Each declares its work unit: ``UNIT`` (what ``attempted`` counts) and
``units(traffic)``, those of one pass or step of the window's loop.
"""
from __future__ import annotations

import torch

# HF's names of a BERT config -> the port's (DistilBERT's)
_BERT_KEYS = {"hidden_size": "dim", "intermediate_size": "hidden_dim",
              "num_attention_heads": "n_heads",
              "num_hidden_layers": "n_layers",
              "hidden_dropout_prob": "dropout",
              "attention_probs_dropout_prob": "attention_dropout"}


def dims(config: dict) -> dict:
    """The architecture's sizes under the port's names."""
    out = {k: config[k] for k in (
        "vocab_size", "max_position_embeddings", "initializer_range",
        "weights_std")}
    for hf, port in _BERT_KEYS.items():
        if hf in config:
            out[port] = config[hf]
    for key in ("dim", "hidden_dim", "n_heads", "n_layers", "dropout",
                "attention_dropout", "type_vocab_size"):
        if key in config:
            out[key] = config[key]
    out.setdefault("type_vocab_size", 0)
    return out


def port_config(config: dict):
    """The port's ``DistilBertConfig`` (``BertConfig`` for a BERT) as the
    configuration file states it."""
    from cldrd_tpu_torch.models import BertConfig, DistilBertConfig

    d = dims(config)
    kwargs = dict(vocab_size=d["vocab_size"],
                  max_position_embeddings=d["max_position_embeddings"],
                  dim=d["dim"], n_layers=d["n_layers"], n_heads=d["n_heads"],
                  hidden_dim=d["hidden_dim"], dropout=d["dropout"],
                  attention_dropout=d["attention_dropout"],
                  initializer_range=d["initializer_range"],
                  attention_impl=config["attention_impl"])
    if config["model_type"] == "bert":
        return BertConfig(type_vocab_size=d["type_vocab_size"], **kwargs)
    return DistilBertConfig(**kwargs)


def compute_dtype(config: dict):
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[config["compute_dtype"]]


def free_device() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
