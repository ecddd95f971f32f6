from . import functional, quant
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layers import (Dropout, Embedding, LayerNorm, Linear,
                     ParallelCrossEntropy, RMSNorm)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "Embedding", "LayerNorm", "Linear",
           "ParallelCrossEntropy", "RMSNorm", "clip_grad_norm_",
           "clip_grad_value_", "functional", "quant"]
