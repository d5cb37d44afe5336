"""LambdaRank-MRR listwise loss (the CL-DRD training loss): a pairwise
logistic loss over items sorted by predicted score, weighted by
``|1/i - 1/j|`` of the two positions, over pairs with ``true_i > true_j``,
reduced by a mask-weighted mean (or sum). Port of
``cldrd_tpu/losses/lambda_rank.py``."""
from __future__ import annotations

import torch


def _pairwise_terms(y_pred, y_true, padded_value_indicator: float):
    """(losses [bz, n, n], pair mask [bz, n, n], n) over pred-sorted items;
    items with y_true == padded_value_indicator join no pair."""
    n = y_pred.shape[-1]
    padded = y_true == padded_value_indicator
    neg_inf = torch.tensor(float("-inf"), dtype=y_pred.dtype,
                           device=y_pred.device)
    y_pred = torch.where(padded, neg_inf, y_pred)
    y_true_m = torch.where(padded, neg_inf.to(y_true.dtype), y_true)
    order = torch.argsort(-y_pred, dim=-1, stable=True)
    pred_sorted = torch.gather(y_pred, -1, order)
    true_sorted = torch.gather(y_true_m, -1, order)
    true_diffs = true_sorted[:, :, None] - true_sorted[:, None, :]
    pair_mask = torch.isfinite(true_diffs) & (true_diffs > 0)
    diffs = pred_sorted[:, :, None] - pred_sorted[:, None, :]
    diffs = torch.where(pair_mask, diffs, torch.zeros_like(diffs))
    diffs = torch.clamp(diffs, -1e8, 1e8)
    losses = torch.logaddexp(torch.zeros_like(diffs), -diffs)
    return losses, pair_mask, n


def _masked_reduce(losses, mask, reduction: str):
    masked = losses * mask
    if reduction == "sum":
        return masked.sum()
    if reduction == "mean":
        return masked.sum() / torch.clamp(mask.sum(), min=1)
    raise ValueError("Reduction method can be either sum or mean")


def _inv_pos_weights(n: int, like: torch.Tensor) -> torch.Tensor:
    inv = 1.0 / torch.arange(1, n + 1, dtype=like.dtype, device=like.device)
    return torch.abs(inv[None, :, None] - inv[None, None, :])


def lambda_mrr_loss(y_pred, y_true, eps: float = 1e-10,
                    padded_value_indicator: float = -1,
                    reduction: str = "mean", sigma: float = 1.0):
    del eps, sigma  # signature parity with the reference
    losses, mask, n = _pairwise_terms(y_pred, y_true, padded_value_indicator)
    return _masked_reduce(losses * _inv_pos_weights(n, y_pred), mask,
                          reduction)


def bweight_lambda_mrr_loss(y_pred, y_true, batch_weight, eps: float = 1e-10,
                            padded_value_indicator: float = -1,
                            reduction: str = "mean", sigma: float = 1.0):
    """``lambda_mrr_loss`` with a per-example weight on every pair term."""
    del eps, sigma
    losses, mask, n = _pairwise_terms(y_pred, y_true, padded_value_indicator)
    weighted = (losses * _inv_pos_weights(n, y_pred)
                * batch_weight.reshape(-1, 1, 1))
    return _masked_reduce(weighted, mask, reduction)
