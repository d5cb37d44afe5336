"""Margin-MSE distillation loss: MSE between the student's and teacher's
all-pairs score differences (port of ``cldrd_tpu/losses/margin_mse.py``)."""
from __future__ import annotations

import torch


def margin_mse_loss(m_student: torch.Tensor,
                    m_teacher: torch.Tensor) -> torch.Tensor:
    assert m_student.dim() == m_teacher.dim() == 2
    ds = m_student[:, :, None] - m_student[:, None, :]
    dt = m_teacher[:, :, None] - m_teacher[:, None, :]
    return ((ds - dt) ** 2).mean()
