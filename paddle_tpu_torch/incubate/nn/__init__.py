"""The incubate layers (counterpart of `paddle_tpu/incubate/nn/`): the fused
transformer layers, `FusedMultiTransformer`, the fused linear, and the
layer forms `FusedDropoutAdd` and `FusedEcMoe`."""
import torch
from torch import nn as _nn

from . import functional
from .fused_linear import FusedLinear, fused_linear, fused_matmul_bias
from .fused_transformer import (FusedBiasDropoutResidualLayerNorm,
                                FusedFeedForward, FusedMultiHeadAttention,
                                FusedMultiTransformer,
                                FusedTransformerEncoderLayer, _Params,
                                fused_feedforward,
                                fused_multi_head_attention)


class FusedDropoutAdd(_nn.Module):
    """`functional.fused_dropout_add` with the layer's training flag."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return functional.fused_dropout_add(x, y, p=self.p,
                                            training=self.training,
                                            mode=self.mode)


class FusedEcMoe(_nn.Module):
    """`functional.fused_ec_moe` with the layer's experts: `bmm0_weight`
    [e, hidden, inter] and `bmm1_weight` [e, inter, hidden] Xavier-normal
    from `generator` (default one drawn from the global stream), the
    biases [e, 1, ...] zero. The caller computes the gate logits.
    `weight_attr` and `bias_attr` take only None."""

    def __init__(self, hidden_size, inter_size, num_experts,
                 act_type="gelu", weight_attr=None, bias_attr=None,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        if weight_attr is not None or bias_attr is not None:
            raise NotImplementedError("FusedEcMoe: parameter attributes "
                                      "are not ported (pass None)")
        self.act_type = act_type
        mk = _Params(dtype, device, generator)
        self.bmm0_weight = mk.xavier(num_experts, hidden_size, inter_size)
        self.bmm0_bias = mk.const(0.0, num_experts, 1, inter_size)
        self.bmm1_weight = mk.xavier(num_experts, inter_size, hidden_size)
        self.bmm1_bias = mk.const(0.0, num_experts, 1, hidden_size)

    def forward(self, x, gate):
        return functional.fused_ec_moe(
            x, gate, self.bmm0_weight, self.bmm0_bias, self.bmm1_weight,
            self.bmm1_bias, act_type=self.act_type)


__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedDropoutAdd",
           "FusedEcMoe", "FusedFeedForward", "FusedLinear",
           "FusedMultiHeadAttention", "FusedMultiTransformer",
           "FusedTransformerEncoderLayer", "functional", "fused_feedforward",
           "fused_linear", "fused_matmul_bias", "fused_multi_head_attention"]
