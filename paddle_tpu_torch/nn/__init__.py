from . import functional, quant
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layers import (Dropout, Embedding, LayerNorm, Linear,
                     ParallelCrossEntropy, RMSNorm)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "ParallelCrossEntropy", "RMSNorm",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer", "clip_grad_norm_",
           "clip_grad_value_", "functional", "quant"]
