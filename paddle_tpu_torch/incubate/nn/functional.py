"""The incubate fused functionals (counterpart of
`paddle_tpu/incubate/nn/functional.py`). Each is one traced XLA
expression in the reference, not a Pallas kernel, so plain PyTorch here.
Dropout masks come from the port's global stream (`F.dropout`), not
`jax.random`: other masks for one seed, the same distribution."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...nn import functional as F
from .fused_linear import fused_linear, fused_matmul_bias  # noqa: F401
from .fused_transformer import (  # noqa: F401
    fused_feedforward,
    fused_multi_head_attention,
)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """LayerNorm(residual + dropout(x + bias)) over the last axis, with the
    population variance, computed in the inputs' dtype as the reference's
    expression is."""
    y = x if bias is None else x + bias
    h = residual + F.dropout(y, dropout_rate, training=training, mode=mode)
    mean = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, unbiased=False)
    out = (h - mean) / torch.sqrt(var + ln_epsilon)
    if ln_scale is not None:
        out = out * ln_scale
    if ln_bias is not None:
        out = out + ln_bias
    return out


def softmax_mask_fuse_upper_triangle(x, name=None):
    """Causal softmax over the last axis of [batch, heads, seq_q, seq_k]
    scores, bottom-right aligned; a row with every position masked (seq_q >
    seq_k) reads 0."""
    if x.dim() != 4:
        raise ValueError(
            "softmax_mask_fuse_upper_triangle expects [b, h, sq, sk]")
    sq, sk = x.shape[-2], x.shape[-1]
    mask = torch.arange(sq, device=x.device)[:, None] + (sk - sq) >= \
        torch.arange(sk, device=x.device)[None]
    neg = torch.tensor(torch.finfo(torch.float32).min, dtype=x.dtype,
                       device=x.device)
    sm = torch.softmax(torch.where(mask, x, neg), dim=-1)
    return torch.where(mask.any(-1)[:, None], sm, 0.0)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """dropout(x) + y."""
    return F.dropout(x, p, training=training, mode=mode) + y


def _fused_norm(x, norm_weight, norm_bias, epsilon, begin_norm_axis,
                residual, bias, kind):
    """h = x + bias + residual; every axis from `begin_norm_axis` on
    normalised in f32 (RMS or layer), scaled and shifted by weights of
    those axes' shape; returns (out in x's dtype, h)."""
    h = x if bias is None else x + bias
    if residual is not None:
        h = h + residual
    ax = begin_norm_axis % h.dim()
    axes = tuple(range(ax, h.dim()))
    hf = h.float()
    if kind == "rms":
        out = hf * torch.rsqrt(hf.square().mean(axes, keepdim=True)
                               + epsilon)
    else:
        mean = hf.mean(axes, keepdim=True)
        var = hf.var(axes, keepdim=True, unbiased=False)
        out = (hf - mean) / torch.sqrt(var + epsilon)
    if norm_weight is not None:
        out = out * norm_weight.float().reshape(h.shape[ax:])
    if norm_bias is not None:
        out = out + norm_bias.float().reshape(h.shape[ax:])
    return out.to(x.dtype), h


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None, name=None):
    """(out, residual_out) = (RMSNorm(x + bias + residual), the pre-norm
    sum), normalising the axes from `begin_norm_axis` on."""
    return _fused_norm(x, norm_weight, norm_bias, epsilon, begin_norm_axis,
                       residual, bias, "rms")


def fused_layer_norm(x, norm_weight, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None,
                     name=None):
    """(out, residual_out) = (LayerNorm(x + bias + residual), the pre-norm
    sum), normalising the axes from `begin_norm_axis` on."""
    return _fused_norm(x, norm_weight, norm_bias, epsilon, begin_norm_axis,
                       residual, bias, "layer")


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type="gelu", name=None):
    """Dense soft-mixture MoE: every token through every expert's FFN,
    mixed by the softmax of the caller's gate logits. x [b, s, d], gate
    [b, s, e], bmm0_weight [e, d, d_ff], bmm0_bias [e, 1, d_ff],
    bmm1_weight [e, d_ff, d], bmm1_bias [e, 1, d]. "gelu" is the tanh
    approximation (`jax.nn.gelu`'s default, which the reference calls)."""
    if act_type not in ("gelu", "relu"):
        raise ValueError("fused_ec_moe: act_type must be gelu or relu")
    probs = torch.softmax(gate.float(), dim=-1)
    h = torch.einsum("bsd,edf->ebsf", x, bmm0_weight) + bmm0_bias[:, None]
    h = TF.gelu(h, approximate="tanh") if act_type == "gelu" else TF.relu(h)
    o = torch.einsum("ebsf,efd->ebsd", h, bmm1_weight) + bmm1_bias[:, None]
    return torch.einsum("ebsd,bse->bsd", o.float(), probs).to(x.dtype)
