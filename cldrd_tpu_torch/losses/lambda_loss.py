"""LambdaLoss (Wang et al., CIKM'18) with the seven weighing schemes, NDCG
gains and discounts, ``power``/``linear`` gain, ``@k`` truncation and a
natural or binary log (port of ``cldrd_tpu/losses/lambda_loss.py``)."""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch


def ndcgLoss1_scheme(G, D, *args):
    return (G / D)[:, :, None]


def ndcgLoss2_scheme(G, D, *args):
    n = G.shape[1]
    pos = torch.arange(1, n + 1, device=G.device)
    delta = torch.abs(pos[:, None] - pos[None, :])
    # the reference indexes D[0, delta - 1], which wraps at the diagonal;
    # the diagonal is zeroed below
    prev = torch.abs(D[0, (delta - 1) % n])
    curr = torch.abs(D[0, delta % n])
    deltas = torch.abs(1.0 / prev - 1.0 / curr)
    deltas = deltas * (1 - torch.eye(n, dtype=deltas.dtype,
                                     device=deltas.device))
    return deltas[None, :, :] * torch.abs(G[:, :, None] - G[:, None, :])


def lambdaRank_scheme(G, D, *args):
    return torch.abs(1.0 / D[:, :, None] - 1.0 / D[:, None, :]) * torch.abs(
        G[:, :, None] - G[:, None, :])


def ndcgLoss2PP_scheme(G, D, *args):
    return args[0] * ndcgLoss2_scheme(G, D) + lambdaRank_scheme(G, D)


def rankNet_scheme(G, D, *args):
    return 1.0


def rankNetWeightedByGTDiff_scheme(G, D, *args):
    t = args[1]
    return torch.abs(t[:, :, None] - t[:, None, :])


def rankNetWeightedByGTDiffPowed_scheme(G, D, *args):
    t = args[1]
    return torch.abs(t[:, :, None] ** 2 - t[:, None, :] ** 2)


SCHEMES = {
    "ndcgLoss1_scheme": ndcgLoss1_scheme,
    "ndcgLoss2_scheme": ndcgLoss2_scheme,
    "lambdaRank_scheme": lambdaRank_scheme,
    "ndcgLoss2PP_scheme": ndcgLoss2PP_scheme,
    "rankNet_scheme": rankNet_scheme,
    "rankNetWeightedByGTDiff_scheme": rankNetWeightedByGTDiff_scheme,
    "rankNetWeightedByGTDiffPowed_scheme":
        rankNetWeightedByGTDiffPowed_scheme,
}


def lambda_loss(y_pred, y_true, eps: float = 1e-4,
                padded_value_indicator: float = -1,
                weighing_scheme: Optional[Union[str, Callable]] = None,
                k: Optional[int] = None, sigma: float = 1.0,
                mu: float = 10.0, reduction: str = "mean",
                reduction_log: str = "natural", gain: str = "power"):
    """y_pred, y_true: [bz, n]; ``k`` truncates the loss pairs and the
    ideal DCG to the top-k positions."""
    if isinstance(weighing_scheme, str):
        scheme_name, weighing_fn = weighing_scheme, SCHEMES[weighing_scheme]
    elif weighing_scheme is None:
        scheme_name, weighing_fn = None, None
    else:
        scheme_name = getattr(weighing_scheme, "__name__", "")
        weighing_fn = weighing_scheme
    n = y_pred.shape[-1]
    k = n if k is None else k
    dev = y_pred.device

    padded = y_true == padded_value_indicator
    neg_inf = torch.tensor(float("-inf"), dtype=y_pred.dtype, device=dev)
    y_pred = torch.where(padded, neg_inf, y_pred)
    y_true = torch.where(padded, neg_inf.to(y_true.dtype), y_true)

    order = torch.argsort(-y_pred, dim=-1, stable=True)
    y_pred_sorted = torch.gather(y_pred, -1, order)
    true_by_preds = torch.gather(y_true, -1, order)
    y_true_sorted = -torch.sort(-y_true, dim=-1, stable=True).values

    true_diffs = true_by_preds[:, :, None] - true_by_preds[:, None, :]
    pair_mask = torch.isfinite(true_diffs)
    if scheme_name != "ndcgLoss1_scheme":
        pair_mask = pair_mask & (true_diffs > 0)
    at_k = torch.zeros((n, n), dtype=torch.bool, device=dev)
    at_k[:k, :k] = True

    true_by_preds = torch.clamp(true_by_preds, min=0.0)
    y_true_sorted = torch.clamp(y_true_sorted, min=0.0)
    pos = torch.arange(1, n + 1, dtype=y_pred.dtype, device=dev)
    D = torch.log2(1.0 + pos)[None, :]
    if gain == "power":
        max_dcg = torch.clamp(((2.0 ** y_true_sorted - 1.0) / D)[:, :k].sum(
            -1), min=eps)
        G = (2.0 ** true_by_preds - 1.0) / max_dcg[:, None]
    elif gain == "linear":
        max_dcg = torch.clamp(((y_true_sorted - 1.0) / D)[:, :k].sum(-1),
                              min=eps)
        G = (true_by_preds - 1.0) / max_dcg[:, None]
    else:
        raise ValueError(f"{gain} not defined.")
    weights = 1.0 if weighing_fn is None else weighing_fn(
        G, D, mu, true_by_preds)

    diffs = y_pred_sorted[:, :, None] - y_pred_sorted[:, None, :]
    diffs = torch.where(pair_mask, diffs, torch.zeros_like(diffs))
    diffs = torch.clamp(diffs, -1e8, 1e8)
    probas = torch.clamp(torch.clamp(torch.sigmoid(sigma * diffs),
                                     min=eps) ** weights, min=eps)
    if reduction_log == "natural":
        losses = torch.log(probas)
    elif reduction_log == "binary":
        losses = torch.log2(probas)
    else:
        raise ValueError(
            "Reduction logarithm base can be either natural or binary")
    mask = pair_mask & at_k[None]
    masked = losses * mask
    if reduction == "sum":
        return -masked.sum()
    if reduction == "mean":
        return -masked.sum() / torch.clamp(mask.sum(), min=1)
    raise ValueError("Reduction method can be either sum or mean")
