from . import functional
from .layers import Embedding, Linear, RMSNorm

__all__ = ["Embedding", "Linear", "RMSNorm", "functional"]
