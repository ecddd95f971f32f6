from . import functional, quant
from .layers import Embedding, Linear, ParallelCrossEntropy, RMSNorm

__all__ = ["Embedding", "Linear", "ParallelCrossEntropy", "RMSNorm",
           "functional", "quant"]
