"""Curriculum trainer: one config-driven training loop (port of
``cldrd_tpu/train/trainer.py`` on one device).

- loss = ``cfg.loss`` on the [bz, nway'] dual-encoder logits; in-batch
  negatives pad the labels with -0.5; the L2 logit regularizer
  ``reg_lambda`` applies only without in-batch negatives
  (``nway_listwise_1.py:334-350``);
- bf16 compute over fp32 params: every weight is cast per matmul, the
  gradients land in fp32, with no loss scaling;
- clip + AdamW + linear warmup, gradient accumulation (``optim.py``);
- batch MRR@10 / Recall@10, the TSV/JSONL log every ``logging_steps``, a
  full checkpoint every ``evaluate_steps`` and at the end;
- ``resume`` continues at the exact batch, ``model_checkpoint`` warm
  starts the weights; ``nan_policy`` decides what a non-finite loss does;
  SIGTERM checkpoints at the next step boundary and returns;
- the dropout of step n comes from ``DropoutRNG(seed, n)``, so a resumed
  run replays the masks of the uninterrupted one.

Metrics stay on the device until a logging or checkpoint boundary, where
they are fetched together (one synchronisation per boundary).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import signal
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cldrd_tpu_torch import losses as L
from cldrd_tpu_torch.data.nway_dataset import NwayBatch, NwayDataset
from cldrd_tpu_torch.data.prefetch import prefetch
from cldrd_tpu_torch.device import resolve_device
from cldrd_tpu_torch.models import (
    DistilBertConfig,
    DropoutRNG,
    NwayDualEncoder,
)
from cldrd_tpu_torch.models.convert import (
    dual_encoder_state_dict,
    dual_encoder_to_reference,
)
from cldrd_tpu_torch.utils import AverageMeter, write_train_logs

from .checkpoint import (
    load_checkpoint,
    load_warm_start_params,
    save_checkpoint,
)
from .config import TrainConfig
from .optim import Optimizer, global_norm, linear_warmup_schedule

logger = logging.getLogger("cldrd_tpu_torch.train")

IN_BATCH_PAD = -0.5  # reference nway_listwise_1.py:343-345


@dataclasses.dataclass
class TrainState:
    """The result of ``Trainer.train``: fp32 params (the model's
    state_dict), the micro-step count and the epoch."""

    params: Dict[str, torch.Tensor]
    step: int
    epoch: int


def make_loss_fn(cfg: TrainConfig) -> Callable:
    """``cfg.loss`` -> ``(logits, labels, teacher_scores) -> scalar``.
    Ranking losses read the graded labels, distillation losses the
    teacher scores (the labels when the file has none)."""
    name = cfg.loss
    if name == "lambda_mrr":
        return lambda logits, labels, teacher: L.lambda_mrr_loss(logits,
                                                                 labels)
    if name == "ranknet":
        return lambda logits, labels, teacher: L.ranknet_loss(logits, labels)
    if name == "lambda_loss":
        return lambda logits, labels, teacher: L.lambda_loss(
            logits, labels, weighing_scheme=cfg.weighing_scheme,
            k=cfg.loss_at_k)
    if name == "kl_div":
        return lambda logits, labels, teacher: L.kl_div_loss(
            logits, teacher, T=cfg.temperature)
    if name == "margin_mse":
        return lambda logits, labels, teacher: L.margin_mse_loss(logits,
                                                                 teacher)
    if name == "weighted_pointwise":
        return lambda logits, labels, teacher: L.weighted_pointwise_loss(
            logits, labels, T=cfg.temperature)
    if name == "kd":
        # pairwise ranking on the label order + temperature-scaled KL on
        # the teacher scores
        return lambda logits, labels, teacher: (
            L.ranknet_loss(logits, labels)
            + cfg.lambda_weight * L.kl_div_loss(logits, teacher,
                                                T=cfg.temperature))
    raise ValueError(f"unknown loss {name!r}")


def batch_mrr_recall(logits: torch.Tensor, labels: torch.Tensor,
                     cutoff: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch MRR@cutoff / Recall@cutoff: sort labels by logits (stable,
    descending) and count every label == 1.0 across the batch."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    is_one = torch.gather(labels, -1, order) == 1.0
    pos = torch.arange(labels.shape[-1], device=labels.device)[None, :]
    within = is_one & (pos < cutoff)
    denom = torch.clamp(is_one.sum(), min=1)
    mrr = torch.where(within, 1.0 / (pos + 1.0),
                      torch.zeros((), device=labels.device)).sum() / denom
    return mrr, within.float().sum() / denom


def batch_to_device(batch: NwayBatch, dev: torch.device) -> Dict[str, Any]:
    """The device-facing part of a collated batch: token ids as int64,
    labels and teacher scores as fp32; the packed layout when the batch
    has it, else the flat one."""

    def ids(d):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            dev, torch.int64) for k, v in d.items()}

    labels = torch.from_numpy(batch.labels).to(dev)
    teacher = (batch.teacher_scores if batch.teacher_scores is not None
               else batch.labels)
    out = {"query": ids(batch.query), "labels": labels,
           "teacher_scores": torch.from_numpy(teacher).to(dev)}
    if batch.packed_passages is not None:
        out["packed_passages"] = ids(batch.packed_passages)
    else:
        out["nway_passages"] = ids(batch.nway_passages)
    return out


class Trainer:
    """Config-driven training for one curriculum iteration, on one
    device (``device=None`` is CUDA)."""

    def __init__(self, cfg: TrainConfig, model_config: DistilBertConfig,
                 device=None):
        cfg = cfg.resolve()
        if cfg.remat:
            raise NotImplementedError("remat is not ported yet")
        if cfg.n_devices not in (None, 1):
            raise NotImplementedError(
                f"n_devices={cfg.n_devices}: the port trains on one device "
                "(multi-GPU is not ported yet)")
        if cfg.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        self.cfg = cfg
        self.model_config = model_config
        self.device = resolve_device(device)
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.model = NwayDualEncoder(
            model_config, share_weights=cfg.share_weights,
            apply_cosine_similarity=cfg.apply_cosine_similarity,
            dtype=self.dtype, in_batch_loss=cfg.in_batch_loss,
            all_in_batch_neg=cfg.all_in_batch_neg)
        self.run_dir = os.path.join(cfg.run_folder, cfg.experiment_name)
        os.makedirs(self.run_dir, exist_ok=True)
        cfg.save_yaml(os.path.join(self.run_dir, "config.yaml"))
        self._tb = None
        if cfg.tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(self.run_dir, "tb"))
            except ImportError:
                logger.warning("tensorboard requested but unavailable; "
                               "TSV/JSONL logs only")
        self.optimizer: Optional[Optimizer] = None
        self._schedule = None

    # ------------------------------------------------------------- state

    def _make_optimizer(self, total_steps: int) -> Optimizer:
        cfg = self.cfg
        k = max(1, int(cfg.grad_accum_steps))
        # the schedule counts optimizer updates: k micro-batches each
        opt_steps = max(1, total_steps // k)
        self._schedule = linear_warmup_schedule(cfg.learning_rate,
                                                cfg.warmup_steps, opt_steps)
        return Optimizer(
            list(self.model.named_parameters()), cfg.learning_rate,
            opt_steps, warmup_steps=cfg.warmup_steps,
            weight_decay=cfg.weight_decay, adam_epsilon=cfg.adam_epsilon,
            max_grad_norm=cfg.max_grad_norm, grad_accum_steps=k)

    def _init_params(self, init_params: Optional[Dict[str, torch.Tensor]]
                     ) -> None:
        if init_params is None:
            self.model.reset_parameters(seed=self.cfg.seed)
        else:
            self._load_params(init_params)

    def _load_params(self, params: Dict[str, torch.Tensor]) -> None:
        missing = self.model.load_state_dict(
            {k: v.float() for k, v in params.items()},
            strict=False).missing_keys
        if missing:
            raise KeyError(f"missing weights {missing[:5]}")

    def _save(self, step: int, epoch: int) -> str:
        return save_checkpoint(
            {"state_dict": dual_encoder_to_reference(self.model.state_dict()),
             "optimizer": self.optimizer.state_dict(),
             "scheduler": self.optimizer.scheduler.state_dict(),
             "step": step, "epoch": epoch}, self.run_dir, step)

    # ---------------------------------------------------------- main loop

    def train(self, dataset: NwayDataset,
              init_params: Optional[Dict[str, torch.Tensor]] = None,
              step_hook: Optional[Callable[[int, Dict[str, float]], None]]
              = None) -> TrainState:
        """Train over ``dataset`` for ``cfg.num_train_epochs``. Weights:
        ``cfg.resume`` restores the full state, else
        ``cfg.model_checkpoint`` loads weights only, else ``init_params``
        (a state_dict) or a random init from ``cfg.seed``."""
        cfg = self.cfg
        steps_per_epoch = len(dataset) // cfg.batch_size
        total_steps = steps_per_epoch * cfg.num_train_epochs
        assert steps_per_epoch > 0, "dataset smaller than one batch"
        self._init_params(init_params)
        self.model.to(self.device).train()
        self.optimizer = self._make_optimizer(total_steps)

        start_epoch, skip_batches, global_step = 0, 0, 0
        if cfg.resume:
            assert not cfg.model_checkpoint, \
                "resume and model_checkpoint are exclusive"
            blob = load_checkpoint(cfg.resume)
            self._load_params(dual_encoder_state_dict(blob["state_dict"],
                                                      cfg.share_weights))
            if "adam" in blob:  # a JAX Trainer's .msgpack
                self.optimizer.load_adam_moments(**blob["adam"])
            else:
                self.optimizer.load_state_dict(blob["optimizer"])
                self.optimizer.scheduler.load_state_dict(blob["scheduler"])
            global_step = int(blob["step"])
            # the shuffle is seeded per epoch, so skipping the consumed
            # batches resumes at the exact batch
            start_epoch = global_step // steps_per_epoch
            skip_batches = global_step % steps_per_epoch
            logger.info("resumed from %s at step %d (epoch %d, skipping %d "
                        "batches)", cfg.resume, global_step, start_epoch,
                        skip_batches)
        elif cfg.model_checkpoint:
            self._load_params(load_warm_start_params(cfg.model_checkpoint,
                                                     cfg.share_weights))
            logger.info("warm-started weights from %s", cfg.model_checkpoint)

        # the packed layout is a collation property: align the dataset
        if getattr(dataset, "pack_passages", None) != cfg.pack_passages:
            dataset.pack_passages = cfg.pack_passages
        logger.info("start training: %d examples, %d steps/epoch, %d total "
                    "steps, lr %g, loss %s, label_mode %s, device %s",
                    len(dataset), steps_per_epoch, total_steps,
                    cfg.learning_rate, cfg.loss, cfg.label_mode, self.device)

        preempt = threading.Event()

        def _on_sigterm(signum, frame):
            logger.warning("SIGTERM: checkpointing at the next step boundary")
            preempt.set()

        install = threading.current_thread() is threading.main_thread()
        prev = signal.signal(signal.SIGTERM, _on_sigterm) if install else None
        try:
            return self._train_loop(dataset, global_step, start_epoch,
                                    skip_batches, preempt, step_hook)
        finally:
            if install:
                signal.signal(signal.SIGTERM,
                              prev if prev is not None else signal.SIG_DFL)

    def _step(self, batch: Dict[str, Any], rng: DropoutRNG,
              loss_fn) -> Dict[str, torch.Tensor]:
        """One micro-step: forward, backward, optimizer (every k-th)."""
        cfg = self.cfg
        logits = self.model(batch["query"], batch.get("nway_passages"),
                            batch.get("packed_passages"), rng=rng)
        labels, teacher = batch["labels"], batch["teacher_scores"]
        if cfg.in_batch_loss:
            pad = labels.new_full((labels.shape[0],
                                   logits.shape[1] - labels.shape[1]),
                                  IN_BATCH_PAD)
            labels = torch.cat([labels, pad], dim=-1)
            teacher = torch.cat([teacher, pad], dim=-1)
        loss = loss_fn(logits, labels, teacher)
        reg = torch.zeros((), device=logits.device)
        if cfg.reg_lambda > 0.0 and not cfg.in_batch_loss:
            reg = torch.linalg.vector_norm(logits.reshape(-1)) * \
                cfg.reg_lambda
            loss = loss + reg
        params = self.optimizer.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        gnorm = global_norm(grads)
        with torch.no_grad():
            self.optimizer.step(grads)
            mrr, recall = batch_mrr_recall(logits.detach(), labels)
        return {"loss": loss.detach(), "mrr": mrr, "recall": recall,
                "reg_loss": reg.detach(), "grad_norm": gnorm}

    def _train_loop(self, dataset, global_step, start_epoch, skip_batches,
                    preempt, step_hook) -> TrainState:
        cfg = self.cfg
        loss_fn = make_loss_fn(cfg)
        k_acc = max(1, int(cfg.grad_accum_steps))
        meters = {k: AverageMeter() for k in ("loss", "mrr", "recall",
                                              "reg", "aux")}
        log_path = os.path.join(self.run_dir, "train_logs.log")
        pending = []

        def flush():
            if not pending:
                return
            names = list(pending[0][1])
            values = torch.stack([torch.stack([m[n].float() for n in names])
                                  for _, m in pending]).cpu().tolist()
            for (step, _), row in zip(pending, values):
                m = dict(zip(names, row))
                self._check_finite(m, step)
                meters["loss"].update(m["loss"])
                meters["mrr"].update(m["mrr"])
                meters["recall"].update(m["recall"])
                if cfg.reg_lambda > 0.0:
                    meters["reg"].update(m["reg_loss"])
                    meters["aux"].update(m["reg_loss"]
                                         / max(m["loss"], 1e-12))
                if step_hook is not None:
                    step_hook(step, m)
            pending.clear()

        first_checked = False
        epoch = start_epoch
        for epoch in range(start_epoch, cfg.num_train_epochs):
            batches = prefetch(dataset.batches(
                cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
                drop_last=True), depth=2)
            for batch_idx, batch in enumerate(batches):
                if epoch == start_epoch and batch_idx < skip_batches:
                    continue  # consumed before the resume checkpoint
                if not first_checked:
                    self._validate_token_range(batch)
                    first_checked = True
                rng = DropoutRNG(cfg.seed, global_step, self.device)
                metrics = self._step(batch_to_device(batch, self.device),
                                     rng, loss_fn)
                global_step += 1
                pending.append((global_step, metrics))
                if (global_step % cfg.logging_steps == 0
                        or global_step % cfg.evaluate_steps == 0):
                    flush()
                if global_step % cfg.logging_steps == 0:
                    lr = float(self._schedule(global_step // k_acc))
                    kwargs = {}
                    if cfg.reg_lambda > 0.0:
                        kwargs = dict(reg_loss=meters["reg"].avg,
                                      total_aux_ratio=meters["aux"].avg)
                        meters["reg"].reset(), meters["aux"].reset()
                    write_train_logs(epoch + 1, global_step,
                                     meters["loss"].avg, meters["mrr"].avg,
                                     meters["recall"].avg, lr,
                                     filename=log_path, **kwargs)
                    if self._tb is not None:
                        for tag, key in (("loss", "loss"), ("mrr@10", "mrr"),
                                         ("recall@10", "recall")):
                            self._tb.add_scalar(tag, meters[key].avg,
                                                global_step)
                        self._tb.add_scalar("lr", lr, global_step)
                    for key in ("loss", "mrr", "recall"):
                        meters[key].reset()
                saved = None
                if global_step % cfg.evaluate_steps == 0:
                    # metrics were flushed and checked above, so a
                    # non-finite state is never saved under 'raise'
                    saved = self._save(global_step, epoch)
                if preempt.is_set():
                    flush()
                    path = saved or self._save(global_step, epoch)
                    logger.warning("preempted at step %d: checkpoint saved to "
                                   "%s; relaunch with resume=%r to continue "
                                   "at the exact batch", global_step, path,
                                   path)
                    batches.close()
                    if self._tb is not None:
                        self._tb.flush()
                    return self._state(global_step, epoch)
        flush()
        self._save(global_step, epoch)  # end of training
        if k_acc > 1 and global_step % k_acc:
            logger.warning("grad_accum_steps=%d does not divide the %d "
                           "micro-steps: the last %d micro-batch gradients "
                           "were never applied", k_acc, global_step,
                           global_step % k_acc)
        if self._tb is not None:
            self._tb.flush()
        return self._state(global_step, epoch)

    def _state(self, step: int, epoch: int) -> TrainState:
        return TrainState(params=self.model.state_dict(), step=step,
                          epoch=epoch)

    def _check_finite(self, m: Dict[str, float], step: int) -> None:
        if not np.isfinite(m["loss"]):
            msg = (f"non-finite loss {m['loss']} at step {step} "
                   f"(grad_norm={m['grad_norm']}); check tokenizer/model "
                   "vocab agreement and learning rate")
            if self.cfg.nan_policy == "raise":
                raise FloatingPointError(msg)
            if self.cfg.nan_policy == "warn":
                logger.warning(msg)

    def _validate_token_range(self, batch: NwayBatch) -> None:
        """Out-of-range token ids would index past the embedding table:
        checked on the host, on the first batch."""
        vocab = self.model_config.vocab_size
        max_pos = self.model_config.max_position_embeddings
        for name, tokens in (("query", batch.query),
                             ("passage", batch.nway_passages)):
            max_id = int(tokens["input_ids"].max())
            if max_id >= vocab:
                raise ValueError(f"{name} token id {max_id} >= model "
                                 f"vocab_size {vocab}: tokenizer and model "
                                 "config disagree")
            seq_len = tokens["input_ids"].shape[-1]
            if seq_len > max_pos:
                raise ValueError(f"{name} length {seq_len} > "
                                 f"max_position_embeddings {max_pos}")
