from .bert import BertConfig, BertEncoder
from .convert import load_checkpoint, params_from_flax
from .cross_encoder import CrossEncoder
from .distilbert import (
    DistilBertConfig,
    DistilBertEncoder,
    DropoutRNG,
    cls_pool,
    resolve_attention_impl,
)
from .dual_encoder import DualEncoder, NwayDualEncoder

__all__ = ["BertConfig", "BertEncoder", "CrossEncoder", "DistilBertConfig",
           "DistilBertEncoder", "DropoutRNG", "DualEncoder",
           "NwayDualEncoder", "cls_pool", "load_checkpoint",
           "params_from_flax", "resolve_attention_impl"]
