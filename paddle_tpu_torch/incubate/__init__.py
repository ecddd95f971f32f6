"""Incubating APIs (counterpart of `paddle_tpu/incubate/`): the fused
transformer encoder layers."""
from . import nn

__all__ = ["nn"]
