from .common import embedding, linear
from .norm import rms_norm
from .rope import apply_rope, rope_tables

__all__ = ["apply_rope", "embedding", "linear", "rms_norm", "rope_tables"]
