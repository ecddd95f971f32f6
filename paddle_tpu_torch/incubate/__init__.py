"""Incubating APIs (counterpart of `paddle_tpu/incubate/`): the fused
transformer layers and functionals."""
from . import nn

__all__ = ["nn"]
