from .activation import gelu, relu
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention)
from .common import dropout, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm, rms_norm
from .rope import apply_rope, rope_tables

__all__ = ["apply_rope", "cross_entropy", "dropout", "embedding",
           "flash_attention", "flash_attn_unpadded", "gelu", "layer_norm",
           "linear", "relu", "rms_norm", "rope_tables",
           "scaled_dot_product_attention"]
