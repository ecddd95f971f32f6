"""Normalisation functionals (counterpart of
`paddle_tpu/nn/functional/norm.py`)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...kernels import rms_norm as _krms


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    """LayerNorm over the trailing `normalized_shape` dims with the
    population variance, then `weight` and `bias` where given. XLA code in
    the reference (no Pallas kernel), so PyTorch's own operator here."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return TF.layer_norm(x, list(normalized_shape), weight, bias, epsilon)


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last dim, output in x's dtype; differentiable.

    Without a gradient to take (serving) only the forward runs, and it
    writes no rstd: the CUDA kernel for a CUDA tensor, which raises for an
    input it does not take; the plain version for a CPU tensor. With one,
    a shape the kernels take (`kernels.rms_norm.supports`) goes through
    `RMSNormFunction`: the forward and backward kernels for a CUDA tensor,
    their plain versions for a CPU tensor. Any other shape or dtype raises
    on CUDA and takes the plain expression, under autograd, on the CPU."""
    if not (torch.is_grad_enabled()
            and (x.requires_grad or weight.requires_grad)):
        return _krms.rms_norm(x, weight, epsilon)
    if not _krms.supports(x, weight):
        if x.device.type == "cpu":
            return _krms.rms_norm_ref(x, weight, epsilon)
        raise ValueError(
            f"rms_norm: the CUDA kernels do not take x {tuple(x.shape)} "
            f"{x.dtype} with weight {tuple(weight.shape)} {weight.dtype} "
            "(kernels.rms_norm.supports)")
    shape = x.shape
    y = _krms.RMSNormFunction.apply(x.reshape(-1, shape[-1]).contiguous(),
                                    weight.contiguous(), float(epsilon))
    return y.reshape(shape)
