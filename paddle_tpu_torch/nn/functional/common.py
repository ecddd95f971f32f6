"""Common functionals (counterpart of
`paddle_tpu/nn/functional/common.py`)."""
from __future__ import annotations

import torch


def linear(x, weight):
    """Paddle weight layout: weight is [in_features, out_features]. The
    product is a plain `torch.matmul`, as the JAX package leaves it to XLA."""
    return torch.matmul(x, weight)


def embedding(ids, weight):
    """Row gather: weight [vocab, hidden], ids [...] -> [..., hidden]."""
    return weight[ids]
