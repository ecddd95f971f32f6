"""Attention functionals (counterpart of
`paddle_tpu/nn/functional/attention.py`).

`scaled_dot_product_attention` takes the flash-attention kernels when there
is no mask and `kernels.flash_attention.supports` takes the shape (the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors); a mask or
any other shape goes to `_sdpa_reference`. The choice is that explicit
test: no sequence-length threshold (the reference's were measured on a
TPU) and no exception caught. Dropout is not ported.
"""
from __future__ import annotations

import math

import torch

from ...kernels import flash_attention as _fa


def _sdpa_reference(q, k, v, mask=None, causal=False, scale=None):
    """q/k/v: [batch, seq, heads, head_dim]. Scores in the input dtype, the
    masked ones at the dtype's lowest value, softmax in f32 cast back."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * s
    low = torch.finfo(logits.dtype).min
    if causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=q.device).tril(kl - ql)
        logits = torch.where(keep, logits, low)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, low)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Paddle layout: [batch, seq, num_heads, head_dim]; causal masking is
    bottom-right aligned."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not ported (LLaMA trains without it)")
    s_q, d = query.shape[1], query.shape[3]
    if attn_mask is None and _fa.supports(s_q, key.shape[1], d,
                                          query.dtype):
        return _fa.flash_attention_bshd(query, key, value, causal=is_causal)
    return _sdpa_reference(query, key, value, mask=attn_mask,
                           causal=is_causal)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    training=True):
    """`paddle.nn.functional.flash_attention.flash_attention` without
    `return_softmax` (not ported): returns (out, None)."""
    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal, training=training)
    return out, None
