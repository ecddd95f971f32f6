"""Layers the LLaMA model and the incubate encoder layers are built from,
on a single rank.

`Linear` stands for `Linear`, `ColumnParallelLinear` and
`RowParallelLinear` (`paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py`)
at tensor-parallel degree 1, `Embedding` for `VocabParallelEmbedding`, and
`RMSNorm` for `paddle_tpu/nn/norm_layers.py::RMSNorm`, and
`ParallelCrossEntropy` for its namesake in `mp_layers.py`; `LayerNorm` and
`Dropout` stand for `paddle_tpu/nn/norm_layers.py::LayerNorm` and
`paddle_tpu/nn/common_layers.py::Dropout`. Parameter names
and shapes equal the JAX layers', so a state dict maps across by name
(`paddle_tpu_torch.weights`). Parameters are trainable and allocated
uninitialised on `device`; the model fills them
(`LlamaForCausalLM.init_weights`) or loads them. Serving runs its forwards
under `torch.no_grad()`.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import functional as F


def _fan_in_out(shape):
    """The reference initialisers' fans (`nn/initializer._fan_in_out`)."""
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def xavier_normal(shape, generator, dtype, device):
    """A tensor of `shape` drawn from the reference's default weight
    initialiser, Xavier normal (std sqrt(2 / (fan_in + fan_out))), on
    `device` from `generator`, in f32 and then cast to `dtype`."""
    fan_in, fan_out = _fan_in_out(shape)
    w = torch.randn(shape, generator=generator, device=device)
    return (w * math.sqrt(2.0 / (fan_in + fan_out))).to(dtype)


class Linear(nn.Module):
    """y = x @ weight (+ bias), weight [in_features, out_features]. With
    `has_bias` (the reference's `has_bias`, or `bias_attr` other than
    False) a bias [out_features] starts at 0; without it (the LLaMA
    linears) `bias` is None and the state holds no bias."""

    def __init__(self, in_features, out_features, dtype=torch.float32,
                 device=None, has_bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(
            out_features, dtype=dtype, device=device)) if has_bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """weight [num_embeddings, embedding_dim]; ids -> rows. The row
    `padding_idx` is zeroed here (the rest stay uninitialised) and reads 0
    in the forward; `sparse` takes only its dense default False and
    `weight_attr` only None (until `nn/initializer`); `name` is unused."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        if sparse:
            raise NotImplementedError("Embedding(sparse=True): sparse "
                                      "gradients are not ported")
        if weight_attr is not None:
            raise NotImplementedError("Embedding(weight_attr=...): parameter "
                                      "attributes are not ported (pass None)")
        self._padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, dtype=dtype, device=device))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            hidden_size, dtype=dtype, device=device))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class ParallelCrossEntropy(nn.Module):
    """Softmax cross entropy at tensor-parallel degree 1: per-token losses
    with a trailing size-1 axis, [..., 1]. `mp_group` (the model-parallel
    group) takes only its single-card default None; `name` is unused."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        if mp_group is not None:
            raise NotImplementedError("ParallelCrossEntropy(mp_group=...): "
                                      "tensor parallelism is not ported")
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return F.cross_entropy(input, label, reduction="none",
                               ignore_index=self.ignore_index).unsqueeze(-1)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing `normalized_shape` dims: weight 1 and
    bias 0 to start."""

    def __init__(self, normalized_shape, epsilon=1e-05, dtype=torch.float32,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self._shape, dtype=dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(self._shape, dtype=dtype,
                                             device=device))

    def forward(self, x):
        return F.layer_norm(x, self._shape, self.weight, self.bias,
                            self._epsilon)


class Dropout(nn.Module):
    """`F.dropout` with the module's training flag; `name` is unused."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)
