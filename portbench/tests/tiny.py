"""Tiny cells for the CPU tests: the benchmark's configurations and
mixes with the sizes cut, the drivers and the reference unchanged."""
from __future__ import annotations

import copy

from portbench import harness

SIZES = {"dim": 64, "hidden_dim": 128, "n_heads": 2, "n_layers": 2,
         "vocab_size": 512, "max_position_embeddings": 64}
BERT = {"hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 2, "num_hidden_layers": 2,
        "vocab_size": 512, "max_position_embeddings": 64}
TRAFFIC = {
    "distilbert.retrieve.exact-int8-b512": {
        "queries": 200, "encode_batch": 64, "search_batch": 128, "k": 100,
        "vocab_words": 300,
        "store": {"rows": 16384, "block_rows": 4096, "centres": 64,
                  "noise": 0.5, "norm_sigma": 0.25},
        "warmup_passes": 1, "trace_passes": 1},
    "distilbert.train.flat-bz8": {
        "examples": 40, "passages": 200, "vocab_words": 300,
        "passage_words": {"mean": 20.0, "sigma": 0.45, "min": 4,
                          "max": 60},
        "warmup_steps_run": 4, "trace_steps": 2},
    "minilm.teacher.flat-top100": {
        "queries": 4, "candidates": 20, "vocab_words": 300, "max_len": 48,
        "batch_size": 16,
        "passage_words": {"mean": 20.0, "sigma": 0.45, "min": 4,
                          "max": 60},
        "warmup_passes": 1, "trace_passes": 1},
}
TRAIN = {"batch_size": 2, "max_passage_len": 32, "logging_steps": 2}
DP = "distilbert.train.dp4-bz8"


def cell(name: str) -> harness.Cell:
    if name == DP:
        return dp_cell()
    c = harness.Cell(name)
    c.config = dict(c.config)
    c.config.update(BERT if c.config["model_type"] == "bert" else SIZES)
    c.traffic = copy.deepcopy(c.traffic)
    c.traffic.update(TRAFFIC[name])
    if "train" in c.traffic:
        c.traffic["train"].update(TRAIN)
        # a global batch of 2 a rank
        c.traffic["train"]["batch_size"] = 2 * c.traffic.get("ranks", 1)
    return c


def dp_cell() -> harness.Cell:
    """The train cell on four ranks (gloo on the CPU), its mix read from
    ``traffic/train-dp4-bz8.json``: a cell measured on four cards and
    left out of ``BENCHMARK.json`` (PERF.md, open questions)."""
    c = cell("distilbert.train.flat-bz8")
    c.name, c.chips = DP, 4
    c.traffic = copy.deepcopy(harness.load_json(
        harness.HERE, "traffic", "train-dp4-bz8.json"))
    c.traffic.update(TRAFFIC["distilbert.train.flat-bz8"],
                     warmup_steps_run=3)
    c.traffic["train"].update(TRAIN, batch_size=2 * c.traffic["ranks"])
    c.limits = harness.load_json(harness.HERE, "limits", DP + ".json")
    return c
