"""Activations (counterpart of `paddle_tpu/ops/activation.py`, which
`paddle_tpu.nn.functional` exports). XLA code in the reference, PyTorch's
operators here."""
from __future__ import annotations

import torch.nn.functional as TF


def relu(x, name=None):
    return TF.relu(x)


def gelu(x, approximate=False, name=None):
    """Exact GELU, or its tanh approximation with `approximate`."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")
