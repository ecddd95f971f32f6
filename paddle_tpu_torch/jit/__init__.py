"""Counterpart of `paddle_tpu/jit`: the training step `train_step`, run
eagerly (`to_static` is not ported)."""
from .api import train_step

__all__ = ["train_step"]
