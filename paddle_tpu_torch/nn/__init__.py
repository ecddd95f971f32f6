from . import functional, quant
from .layers import (Dropout, Embedding, LayerNorm, Linear,
                     ParallelCrossEntropy, RMSNorm)

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear",
           "ParallelCrossEntropy", "RMSNorm", "functional", "quant"]
