"""Fused linear forms (counterpart of
`paddle_tpu/incubate/nn/fused_linear.py`): `fused_matmul_bias`,
`fused_linear`, `fused_linear_activation` and `FusedLinear`. XLA code in
the reference (it fuses the matmul, bias and activation itself), so plain
PyTorch here: `torch.matmul` plus the bias, on the auto-cast white list as
the reference's "matmul"."""
from __future__ import annotations

import torch

from ...framework import amp_state as _amp
from ...framework import random as _random
from ...framework.device import resolve_device
from ...nn import functional as F
from ...nn.layers import Linear, xavier_normal


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """x @ y (+ bias), each operand's last two axes swapped first where
    asked."""
    x, y, bias = _amp.cast_inputs("matmul", x, y, bias)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    return out if bias is None else out + bias


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ weight (+ bias); weight [in, out], or [out, in] with
    `transpose_weight`."""
    return fused_matmul_bias(x, weight, bias, False, transpose_weight)


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu"):
    """`activation` (a name of `nn.functional`: "gelu", exact, or "relu")
    of `fused_matmul_bias`."""
    return getattr(F, activation)(fused_matmul_bias(x, y, bias, trans_x,
                                                    trans_y))


class FusedLinear(Linear):
    """A `Linear` whose forward is `fused_linear`: weight [in, out] (the
    reference keeps this layout whatever `transpose_weight` says, and so
    does this), Xavier-normal from `generator` (default one drawn from the
    global stream), a zero bias unless `bias_attr` is False. `weight_attr`
    takes only None; `name` is unused."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None,
                 dtype=torch.float32, device=None, generator=None):
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError(
                "FusedLinear: parameter attributes are not ported (pass "
                "None, or bias_attr=False for no bias)")
        dev = resolve_device(device)
        super().__init__(in_features, out_features, dtype=dtype, device=dev,
                         has_bias=bias_attr is not False)
        gen = generator if generator is not None else _random.generator(dev)
        with torch.no_grad():
            self.weight.copy_(xavier_normal((in_features, out_features), gen,
                                            dtype, dev))

    def forward(self, x):
        return fused_linear(x, self.weight, self.bias)
