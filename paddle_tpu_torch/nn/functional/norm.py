"""Normalisation functionals (counterpart of
`paddle_tpu/nn/functional/norm.py`)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework import amp_state as _amp
from ...kernels import rms_norm as _krms


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """LayerNorm over the trailing `normalized_shape` dims with the
    population variance, then `weight` and `bias` where given. XLA code in
    the reference (no Pallas kernel), so PyTorch's own operator here. On the
    auto-cast black list ("layer_norm")."""
    x, weight, bias = _amp.cast_inputs("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return TF.layer_norm(x, list(normalized_shape), weight, bias, epsilon)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last dim, then `weight` where given; output in x's
    dtype; differentiable. `name` is accepted and unused, as in the
    reference.

    Without a gradient to take (serving) only the forward runs, and it
    writes no rstd; with one, `RMSNormFunction` runs the forward with rstd
    and, on the way back, the backward. A CPU tensor takes the plain
    versions (and a dtype the kernels do not take, the plain expression
    under autograd); any other tensor launches the CUDA kernels, which take
    every float32, bfloat16 or float16 x and a weight of x's dtype or
    float32 (`kernels.rms_norm.supports`), or raises. On the auto-cast
    black list ("rms_norm")."""
    x, weight = _amp.cast_inputs("rms_norm", x, weight)
    x = x.contiguous()
    weight = None if weight is None else weight.contiguous()
    if not (torch.is_grad_enabled() and (
            x.requires_grad or (weight is not None
                                and weight.requires_grad))):
        return _krms.rms_norm(x, weight, epsilon)
    cols = x.shape[-1] if x.dim() else 0
    if x.device.type == "cpu" and not _krms.supports(
            x.numel() // cols if cols else 0, cols, dtype=x.dtype,
            weight=weight):
        return _krms.rms_norm_ref(x, weight, epsilon)
    shape = x.shape
    y = _krms.RMSNormFunction.apply(x.reshape(-1, shape[-1]), weight,
                                    float(epsilon))
    return y.reshape(shape)
