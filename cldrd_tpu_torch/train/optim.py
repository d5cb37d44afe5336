"""Optimizer: AdamW + linear warmup/decay + global-norm clipping + gradient
accumulation (port of ``cldrd_tpu/train/optim.py`` and of the trainer's
``optax.MultiSteps`` wrapper).

- ``torch.optim.AdamW`` (decoupled weight decay, bias correction) with two
  parameter groups. The reference's no-decay filter
  ``['bias', 'LayerNorm.weight']`` matches by substring, so it exempts
  every bias and ``embeddings.LayerNorm.weight`` but not the blocks'
  ``sa_layer_norm.weight`` / ``output_layer_norm.weight``, which decay.
- The HF linear warmup schedule as a ``LambdaLR`` stepped once per
  optimizer update: the lr of the n-th update (counting from 0) is
  ``schedule(n)``, so the first update's lr is 0, as in optax.
- Clipping by the global norm with optax's formula: ``g / norm *
  max_norm`` only when ``norm >= max_norm``.
- ``grad_accum_steps = k``: the running mean of k micro-batch gradients
  (``acc + (g - acc) / (i + 1)``, optax ``MultiSteps``), clipped and
  applied every k-th micro-step; the schedule counts updates.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch


def linear_warmup_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int):
    """HF ``get_linear_schedule_with_warmup``: ``count -> lr``."""

    def schedule(count: int) -> float:
        return peak_lr * _lr_factor(count, warmup_steps, total_steps)

    return schedule


def _lr_factor(count: int, warmup_steps: int, total_steps: int) -> float:
    if count < warmup_steps:
        return count / max(1, warmup_steps)
    return max(0.0, (total_steps - count) / max(1, total_steps - warmup_steps))


def decays(name: str) -> bool:
    """True for parameters that receive weight decay: everything but
    biases and the embedding LayerNorm's weight."""
    return not (name.endswith("bias")
                or name.endswith("embeddings.LayerNorm.weight"))


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in fp32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class Optimizer:
    """Clip + AdamW + schedule over ``named_params``, with gradient
    accumulation. ``step(grads)`` takes one micro-batch's gradients (in
    parameter order) and returns whether the parameters were updated."""

    def __init__(self, named_params: List[Tuple[str, torch.nn.Parameter]],
                 learning_rate: float, total_steps: int,
                 warmup_steps: int = 4000, weight_decay: float = 0.01,
                 adam_epsilon: float = 1e-8, max_grad_norm: float = 1.0,
                 grad_accum_steps: int = 1):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        groups = [
            {"params": [p for n, p in named_params if decays(n)],
             "weight_decay": weight_decay},
            {"params": [p for n, p in named_params if not decays(n)],
             "weight_decay": 0.0},
        ]
        self.adamw = torch.optim.AdamW(groups, lr=learning_rate,
                                       betas=(0.9, 0.999), eps=adam_epsilon)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.adamw,
            lambda count: _lr_factor(count, warmup_steps, total_steps))
        self.max_grad_norm = max_grad_norm
        self.k = max(1, int(grad_accum_steps))
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    def step(self, grads: List[torch.Tensor]) -> bool:
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            grads, self.mini_step = self.acc, 0
        norm = global_norm(grads)
        # optax: t if norm < max_norm else t / norm * max_norm
        clip = torch.where(norm < self.max_grad_norm,
                           torch.ones_like(norm), norm)
        for p, g in zip(self.params, grads):
            p.grad = torch.where(norm < self.max_grad_norm, g,
                                 g / clip * self.max_grad_norm)
        self.adamw.step()
        self.scheduler.step()
        for p in self.params:
            p.grad = None
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        return True

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "mini_step": self.mini_step,
                "acc": self.acc}

    @torch.no_grad()
    def load_adam_moments(self, count: int, mu: Dict[str, torch.Tensor],
                          nu: Dict[str, torch.Tensor]) -> None:
        """Resume from optax's adam state: ``count`` updates taken, the
        first and second moments by parameter name; the schedule moves to
        ``count`` as ``count`` ``step()`` calls would."""
        for name, p in zip(self.names, self.params):
            self.adamw.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name].to(p.device, p.dtype).clone(),
                "exp_avg_sq": nu[name].to(p.device, p.dtype).clone()}
        sched = self.scheduler.state_dict()
        sched.update(last_epoch=count, _step_count=count + 1)
        self.scheduler.load_state_dict(sched)
        for group, base, factor in zip(self.adamw.param_groups,
                                       self.scheduler.base_lrs,
                                       self.scheduler.lr_lambdas):
            group["lr"] = base * factor(count)

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.mini_step = int(state["mini_step"])
        acc = state.get("acc")
        self.acc = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.params)]
