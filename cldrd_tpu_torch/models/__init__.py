from .convert import load_checkpoint, params_from_flax
from .distilbert import DistilBertConfig, DistilBertEncoder, cls_pool
from .dual_encoder import NwayDualEncoder

__all__ = ["DistilBertConfig", "DistilBertEncoder", "NwayDualEncoder",
           "cls_pool", "load_checkpoint", "params_from_flax"]
