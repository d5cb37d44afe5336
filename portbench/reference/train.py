"""The curriculum's training step in plain float32: the dual encoder's
n-way logits, the LambdaRank-MRR loss, clipping by the global norm and
AdamW with the linear warmup, followed for a run's first steps or
from a given state and optimizer moments.

- logits: the query's CLS embedding against each of its n-way passages'
  (inner products, no in-batch negatives);
- lambda_mrr (the CL-DRD loss, ``nway_listwise_1.py``): items sorted by
  predicted score; over pairs with ``label_i > label_j`` the logistic loss
  of the score difference weighted by ``|1/rank_i - 1/rank_j|``; the mean
  over those pairs;
- the gradient's global norm clipped to ``max_grad_norm`` (``g / norm *
  max`` where ``norm >= max``);
- AdamW (betas 0.9 / 0.999, eps, decoupled weight decay except on biases
  and the embeddings' LayerNorm weight), the learning rate of the
  ``c``-th update ``lr * c / warmup`` during the warmup (0 for the first).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .encoder import Quant, encode


def lambda_mrr(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    n = y_pred.shape[-1]
    order = torch.argsort(-y_pred, dim=-1, stable=True)
    pred = torch.gather(y_pred, -1, order)
    true = torch.gather(y_true, -1, order)
    pair = (true[:, :, None] - true[:, None, :]) > 0
    diffs = torch.where(pair, pred[:, :, None] - pred[:, None, :],
                        torch.zeros((), dtype=pred.dtype, device=pred.device))
    losses = torch.logaddexp(torch.zeros_like(diffs), -diffs)
    inv = 1.0 / torch.arange(1, n + 1, dtype=pred.dtype, device=pred.device)
    weights = torch.abs(inv[None, :, None] - inv[None, None, :])
    return (losses * weights * pair).sum() / pair.sum().clamp(min=1)


def decays(name: str) -> bool:
    return not (name.endswith("bias")
                or name.endswith("embeddings.LayerNorm.weight"))


def step_logits(p, cfg: dict, batch: Dict[str, torch.Tensor],
                dropouts: Sequence, quant: Quant = None,
                own: Optional[int] = None) -> torch.Tensor:
    """One step's logits [bz, nway]. The batch's rows split evenly over
    ``dropouts`` (a data-parallel rank's masks each): each share runs the
    query tower, then the passage tower, with its own masks. ``own``: the
    one share whose embeddings carry gradients (a rank whose gradients
    are not exchanged); the others enter as constants."""
    bz, nway, lp = batch["p_ids"].shape
    per = bz // len(dropouts)
    qs, ds = [], []
    for r, drop in enumerate(dropouts):
        rows = slice(r * per, (r + 1) * per)
        q = encode(p, "query_encoder.", cfg, batch["q_ids"][rows],
                   batch["q_mask"][rows], dropout=drop, quant=quant)
        d = encode(p, "passage_encoder.", cfg,
                   batch["p_ids"][rows].reshape(-1, lp),
                   batch["p_mask"][rows].reshape(-1, lp), dropout=drop,
                   quant=quant).reshape(per, nway, -1)
        if own is not None and r != own:
            q, d = q.detach(), d.detach()
        qs.append(q)
        ds.append(d)
    return torch.einsum("bd,bnd->bn", torch.cat(qs), torch.cat(ds))


def follow(params0: Dict[str, torch.Tensor], cfg: dict, opt: dict,
           batches: Sequence[Dict[str, torch.Tensor]], dropouts: Sequence,
           quant: Quant = None, own: Optional[int] = None, start: int = 0,
           moments: Optional[Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]] = None
           ) -> dict:
    """``len(batches)`` steps from ``params0`` (``dropouts``: each step's
    list of per-rank masks): each step's loss and logits, the first
    clipped gradient's norm by leaf, and each leaf's change after the
    last step (norms, as Python floats). ``start`` updates were taken
    before ``params0``, with AdamW's ``moments`` (first, second) after
    them; none by default."""
    names = list(params0)
    p = {n: params0[n].detach().clone().float().requires_grad_(True)
         for n in names}
    if moments is None:
        m = {n: torch.zeros_like(p[n]) for n in names}
        v = {n: torch.zeros_like(p[n]) for n in names}
    else:
        m, v = ({n: x[n].detach().clone().float() for n in names}
                for x in moments)
    b1, b2 = 0.9, 0.999
    losses: List[float] = []
    logits: List[torch.Tensor] = []
    first: Dict[str, float] = {}
    for count, (batch, drop) in enumerate(zip(batches, dropouts), start):
        out = step_logits(p, cfg, batch, drop, quant, own)
        loss = lambda_mrr(out, batch["labels"])
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        losses.append(float(loss.detach()))
        logits.append(out.detach().cpu())
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if norm >= opt["max_grad_norm"]:
                grads = [g / norm * opt["max_grad_norm"] for g in grads]
            if count == start:
                first = {n: float(torch.linalg.vector_norm(g))
                         for n, g in zip(names, grads)}
            lr = opt["learning_rate"] * min(1.0, count / opt["warmup_steps"])
            t = count + 1
            for n, g in zip(names, grads):
                if decays(n):
                    p[n].mul_(1.0 - lr * opt["weight_decay"])
                m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v[n].sqrt() / (1.0 - b2 ** t) ** 0.5).add_(
                    opt["adam_epsilon"])
                p[n].addcdiv_(m[n], denom, value=-lr / (1.0 - b1 ** t))
        del grads
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p[n] - params0[n].float()))
                  for n in names}
    return {"losses": losses, "logits": logits, "grad_norms": first,
            "change_norms": change}
