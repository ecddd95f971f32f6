"""Layers the LLaMA model is built from, on a single rank.

`Linear` stands for `Linear`, `ColumnParallelLinear` and
`RowParallelLinear` (`paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py`)
at tensor-parallel degree 1, `Embedding` for `VocabParallelEmbedding`, and
`RMSNorm` for `paddle_tpu/nn/norm_layers.py::RMSNorm`. Parameter names and
shapes equal the JAX layers', so a state dict maps across by name
(`paddle_tpu_torch.weights`). Parameters are allocated uninitialised on
`device`; the model fills them (`LlamaForCausalLM.init_weights`) or loads
them.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F


class Linear(nn.Module):
    """y = x @ weight, weight [in_features, out_features] (the LLaMA
    linears have no bias)."""

    def __init__(self, in_features, out_features, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, x):
        return F.linear(x, self.weight)


class Embedding(nn.Module):
    """weight [num_embeddings, embedding_dim]; ids -> rows."""

    def __init__(self, num_embeddings, embedding_dim, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            hidden_size, dtype=dtype, device=device), requires_grad=False)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)
