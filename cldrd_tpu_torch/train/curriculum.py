"""The CL-DRD curriculum as one program (port of
``cldrd_tpu/train/curriculum.py``): each iteration trains from the
previous one's final weights, handed over in memory; every iteration
still writes its own resumable checkpoints."""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from cldrd_tpu_torch.models import DistilBertConfig

from .config import TrainConfig
from .trainer import Trainer, TrainState

logger = logging.getLogger("cldrd_tpu_torch.train")

DatasetFactory = Callable[[TrainConfig], Any]
IterationHook = Callable[[int, TrainState, Trainer], None]


def run_curriculum(iterations: Sequence[TrainConfig],
                   model_config: DistilBertConfig,
                   dataset_factory: DatasetFactory,
                   init_params: Optional[Dict[str, torch.Tensor]] = None,
                   device=None,
                   after_iteration: Optional[IterationHook] = None
                   ) -> TrainState:
    """Train every iteration in turn. ``dataset_factory(cfg)`` builds the
    iteration's dataset; ``init_params`` (a state_dict) seeds iteration
    1; ``after_iteration(i, state, trainer)`` runs after each one."""
    assert len(iterations) >= 1
    state: Optional[TrainState] = None
    params = init_params
    for i, cfg in enumerate(iterations):
        logger.info("=== curriculum iteration %d/%d (label_mode %s, lr %g, "
                    "%d epochs) ===", i + 1, len(iterations), cfg.label_mode,
                    cfg.learning_rate, cfg.num_train_epochs)
        trainer = Trainer(cfg, model_config, device=device)
        state = trainer.train(dataset_factory(cfg), init_params=params)
        params = state.params
        if after_iteration is not None:
            after_iteration(i, state, trainer)
    assert state is not None
    return state
