"""Training: config, optimizer, checkpoints, the trainer and the
curriculum loop (port of ``cldrd_tpu/train``)."""
from .checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    load_warm_start_params,
    save_checkpoint,
)
from .config import (
    TrainConfig,
    curriculum_iterations,
    resolve_pack_passages,
)
from .curriculum import run_curriculum
from .optim import Optimizer, linear_warmup_schedule
from .trainer import Trainer, TrainState, batch_mrr_recall, make_loss_fn

__all__ = ["Optimizer", "TrainConfig", "TrainState",
           "Trainer", "batch_mrr_recall", "curriculum_iterations",
           "latest_checkpoint", "linear_warmup_schedule", "load_checkpoint",
           "load_warm_start_params", "make_loss_fn",
           "resolve_pack_passages", "run_curriculum", "save_checkpoint"]
