"""Temperature-scaled listwise KL divergence,
``KL(softmax(teacher/T) || softmax(student/T))``, batchmean (port of
``cldrd_tpu/losses/kl_div.py``)."""
from __future__ import annotations

import torch


def kl_div_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
                T: float = 1.0) -> torch.Tensor:
    assert y_pred.dim() == y_true.dim() == 2
    log_p = torch.log_softmax(y_pred / T, dim=-1)
    q = torch.softmax(y_true / T, dim=-1)
    log_q = torch.log_softmax(y_true / T, dim=-1)
    return (q * (log_q - log_p)).sum() / y_pred.shape[0]
