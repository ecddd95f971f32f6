from .fused_transformer import (FusedFeedForward, FusedMultiHeadAttention,
                                FusedTransformerEncoderLayer,
                                fused_feedforward,
                                fused_multi_head_attention)

__all__ = ["FusedFeedForward", "FusedMultiHeadAttention",
           "FusedTransformerEncoderLayer", "fused_feedforward",
           "fused_multi_head_attention"]
