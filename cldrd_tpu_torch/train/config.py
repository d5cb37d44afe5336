"""Training configuration (port of ``cldrd_tpu/train/config.py``): one
``TrainConfig`` dataclass with the reference's defaults
(``nway_listwise_1.py:99-165``), a plain YAML round-trip, and the
three-iteration CL-DRD curriculum as data (``curriculum_iterations``).
The fields and their YAML form are the JAX package's, so a config file
means the same thing to both packages.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class TrainConfig:
    """Hyperparameters for one curriculum iteration (reference defaults of
    ``nway_listwise_1.py:99-165`` unless noted)."""

    # data
    queries_path: str = ""
    passages_path: str = ""
    training_path: str = ""
    train_fmt: str = "relT_most_semi_hard"
    label_mode: str = "8"
    max_query_len: int = 30            # reference :127
    max_passage_len: int = 256         # reference :128

    # model
    model_name_or_path: str = "sebastian-hofstaetter/distilbert-dot-tas_b-b256-msmarco"
    share_weights: bool = False        # reference :132 (separate towers)
    in_batch_loss: bool = False
    all_in_batch_neg: bool = True
    apply_cosine_similarity: bool = False  # missing ctof_grained trainer flag

    # optimization
    learning_rate: float = 7e-6
    num_train_epochs: int = 4
    batch_size: int = 8                # global batch (reference divides by nranks)
    warmup_steps: int = 4000
    weight_decay: float = 0.01
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    seed: int = 4680
    # optional TensorBoard event files under <run_dir>/tb (the TSV/JSONL
    # logs stay the contract; reference left TB commented out,
    # nway_listwise_3.py:19)
    tensorboard: bool = False
    # accumulate gradients over this many micro-batches before one AdamW
    # update (optax.MultiSteps, mean of micro-grads == the large-batch
    # mean-loss gradient when examples are independent, i.e. without
    # in_batch_loss): effective batch = batch_size * grad_accum_steps at
    # batch_size's activation memory. The reference has no equivalent
    # (DDP scaled batch by adding GPUs).
    grad_accum_steps: int = 1

    # loss
    loss: str = "lambda_mrr"           # lambda_mrr | ranknet | lambda_loss |
                                       # kl_div | margin_mse | weighted_pointwise | kd
    reg_lambda: float = 0.0            # L2 logit regularization (reference :348-350)
    weighing_scheme: str = "ndcgLoss1_scheme"  # for loss == lambda_loss
    loss_at_k: Optional[int] = None    # lambda_loss @k truncation (reference :40-41)
    temperature: float = 1.0           # for kl_div / kd (scripts use T=50)
    lambda_weight: float = 1.0         # kd aux-loss weight (scripts use 10)
    kd_mode: str = "ylabel"            # missing knowledge_distill trainer flag
    neg_score_mode: str = "original"   # mean | original (kd score trainers)

    # checkpointing / logging
    run_folder: str = "./experiments"
    experiment_name: str = "experiment"
    model_checkpoint: Optional[str] = None  # warm start (weights only)
    resume: Optional[str] = None            # full-state resume
    logging_steps: int = 50            # reference :117
    evaluate_steps: int = 10_000       # checkpoint cadence, reference :116

    # precision / parallelism
    compute_dtype: str = "bfloat16"    # bf16 compute over fp32 params
    n_devices: Optional[int] = None    # None = the process group's ranks
    remat: bool = False                # per-block activation rematerialization
    pack_passages: Optional[bool] = None  # pack short passages into shared
                                       # max_passage_len rows (segment-masked
                                       # attention + position reset,
                                       # data/packing.py): identical logits at
                                       # token-proportional passage-tower
                                       # work. None ('auto') resolves to the
                                       # flat layout (resolve_pack_passages)

    # observability (SURVEY §5.2: the reference has no NaN handling beyond a
    # print; here a non-finite loss fails fast by default)
    nan_policy: str = "raise"          # raise | warn | ignore

    def replace(self, **overrides) -> "TrainConfig":
        return dataclasses.replace(self, **overrides)

    def resolve(self) -> "TrainConfig":
        """Resolve 'auto' fields to concrete values (Trainer does this at
        construction, so the saved config.yaml records what ran)."""
        if self.pack_passages is None:
            return self.replace(
                pack_passages=resolve_pack_passages(self.pack_passages))
        return self

    # -------------------------------------------------------- serialization

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_yaml(self) -> str:
        """Plain key: value YAML (no external yaml dep needed to write)."""
        lines = []
        for k, v in sorted(self.to_dict().items()):
            lines.append(f"{k}: {json.dumps(v)}")
        return "\n".join(lines) + "\n"

    def save_yaml(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_yaml())

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_yaml(cls, path: str) -> "TrainConfig":
        d = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or ":" not in line:
                    continue
                key, val = line.split(":", 1)
                d[key.strip()] = json.loads(val.strip())
        return cls.from_dict(d)


def resolve_pack_passages(value: Optional[bool]) -> bool:
    """``None`` ('auto') -> the flat ``[bz, nway, L]`` layout until the
    card's measurements of both layouts (``chip_smoke.py``'s train phase)
    say otherwise; explicit True/False always wins (``--pack-passages`` /
    ``--no-pack-passages``)."""
    return bool(value) if value is not None else False


def curriculum_iterations(base: Optional[TrainConfig] = None) -> List[TrainConfig]:
    """The reference's three iteration configs
    (``nway_listwise_{1,2,3}.py`` defaults):

      iter 1: 5relT_25neg,  label_mode 8,  lr 7e-6, 4 epochs
      iter 2: 10relT_20neg, label_mode 9,  lr 3e-6, 2 epochs (warm-start 1)
      iter 3: 20relT_10neg, label_mode 10, lr 3e-6, 2 epochs (warm-start 2)
    """
    base = base or TrainConfig()
    return [
        base.replace(label_mode="8", learning_rate=7e-6, num_train_epochs=4,
                     experiment_name="curriculum_iter1"),
        base.replace(label_mode="9", learning_rate=3e-6, num_train_epochs=2,
                     experiment_name="curriculum_iter2"),
        base.replace(label_mode="10", learning_rate=3e-6, num_train_epochs=2,
                     experiment_name="curriculum_iter3"),
    ]
