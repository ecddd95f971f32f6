from .attention import flash_attention, scaled_dot_product_attention
from .common import embedding, linear
from .loss import cross_entropy
from .norm import rms_norm
from .rope import apply_rope, rope_tables

__all__ = ["apply_rope", "cross_entropy", "embedding", "flash_attention",
           "linear", "rms_norm", "rope_tables",
           "scaled_dot_product_attention"]
