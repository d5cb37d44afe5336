"""RankNet pairwise logistic loss over pred-sorted items (port of
``cldrd_tpu/losses/ranknet.py``)."""
from __future__ import annotations

from .lambda_rank import _masked_reduce, _pairwise_terms


def ranknet_loss(y_pred, y_true, eps: float = 1e-10,
                 padded_value_indicator: float = -1,
                 reduction: str = "mean", sigma: float = 1.0):
    del eps, sigma
    losses, mask, _ = _pairwise_terms(y_pred, y_true, padded_value_indicator)
    return _masked_reduce(losses, mask, reduction)
