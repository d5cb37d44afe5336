"""Ranking and distillation losses (port of ``cldrd_tpu/losses``), on
``[bz, n]`` score tensors; each returns a 0-d tensor."""
from .kl_div import kl_div_loss
from .lambda_loss import SCHEMES, lambda_loss
from .lambda_rank import bweight_lambda_mrr_loss, lambda_mrr_loss
from .margin_mse import margin_mse_loss
from .ranknet import ranknet_loss
from .weighted_pointwise import weighted_pointwise_loss

__all__ = ["SCHEMES", "bweight_lambda_mrr_loss", "kl_div_loss",
           "lambda_loss", "lambda_mrr_loss", "margin_mse_loss",
           "ranknet_loss", "weighted_pointwise_loss"]
