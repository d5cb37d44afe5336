"""Weighted pointwise logistic loss, ``mean(log(1 + exp(-pred/T)) * w)``
(port of ``cldrd_tpu/losses/weighted_pointwise.py``)."""
from __future__ import annotations

import torch


def weighted_pointwise_loss(y_pred: torch.Tensor, y_weight: torch.Tensor,
                            T: float = 1.0) -> torch.Tensor:
    x = -y_pred / T
    return (torch.logaddexp(torch.zeros_like(x), x) * y_weight).mean()
