"""Attention functionals (counterpart of
`paddle_tpu/nn/functional/attention.py`).

`scaled_dot_product_attention` takes the flash-attention kernels when there
is no mask and `kernels.flash_attention.supports` takes the shape (the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors); a mask or
any other shape goes to `_sdpa_reference`. The choice is that explicit
test: no sequence-length threshold (the reference's were measured on a
TPU) and no exception caught. Dropout in training takes the flash dropout
bodies, with a fresh seed from the global stream, when
`FLAGS_flash_dropout_kernel` is on and the shape is one the kernels take;
otherwise `_sdpa_reference` with a bernoulli mask from that stream.
`flash_attn_unpadded` runs the segment-id bodies for head_dim 128 and a
dense segment-masked path otherwise.
"""
from __future__ import annotations

import math

import torch

from ...framework import amp_state as _amp
from ...framework import config as _config
from ...framework import random as _random
from ...kernels import flash_attention as _fa


def _sdpa_reference(q, k, v, mask=None, causal=False, scale=None,
                    dropout_p=0.0, generator=None):
    """q/k/v: [batch, seq, heads, head_dim]. Scores in the input dtype, the
    masked ones at the dtype's lowest value, softmax in f32 cast back; with
    dropout_p, the probabilities kept with probability 1 - dropout_p (a
    bernoulli mask from `generator`) and scaled by 1 / (1 - dropout_p)."""
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
    if dropout_p > 0.0:
        keep = torch.empty(probs.shape, device=q.device).bernoulli_(
            1.0 - dropout_p, generator=generator).bool()
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Paddle layout: [batch, seq, num_heads, head_dim]; causal masking is
    bottom-right aligned. `dropout_p` applies in training only. On the
    auto-cast white list ("sdpa"): q, k, v and a float32 additive mask are
    cast, as the reference casts them."""
    query, key, value, attn_mask = _amp.cast_inputs(
        "sdpa", query, key, value, attn_mask)
    p = dropout_p if training else 0.0
    s_q, d = query.shape[1], query.shape[3]
    flash = attn_mask is None and _fa.supports(s_q, key.shape[1], d,
                                               query.dtype)
    if p > 0.0:
        if flash and _config.get_flag("FLAGS_flash_dropout_kernel", False):
            return _fa.flash_attention_bshd(
                query, key, value, causal=is_causal, dropout=p,
                dropout_seed=_random.next_seed())
        return _sdpa_reference(query, key, value, mask=attn_mask,
                               causal=is_causal, dropout_p=p,
                               generator=_random.generator(query.device))
    if flash:
        return _fa.flash_attention_bshd(query, key, value, causal=is_causal)
    return _sdpa_reference(query, key, value, mask=attn_mask,
                           causal=is_causal)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """`paddle.nn.functional.flash_attention.flash_attention`: SDPA, and
    (out, None) even with `return_softmax`, as the reference returns.
    `fixed_seed_offset`, `rng_name` and `name` are accepted and unused, as
    in the reference (dropout seeds come from the global stream)."""
    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal, training=training)
    return out, None


def _unpadded_dense(q, k, v, cu_q, cu_k, scale, causal):
    """The reference's dense path for head widths the kernels do not take:
    f32 scores [heads, total_q, total_k] masked to equal sequences (and
    causal positions), softmax, masked probabilities in q's dtype."""
    total_q, total_k = q.shape[0], k.shape[0]
    seg_q = torch.searchsorted(cu_q[1:], torch.arange(total_q,
                                                      device=q.device),
                               right=True)
    seg_k = torch.searchsorted(cu_k[1:], torch.arange(total_k,
                                                      device=q.device),
                               right=True)
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float())
    s = s * (scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        mask = mask & (torch.arange(total_q, device=q.device)[:, None]
                       >= torch.arange(total_k, device=q.device)[None, :])
    s = torch.where(mask[None], s, torch.finfo(torch.float32).min)
    p = torch.where(mask[None], torch.softmax(s, dim=-1), 0.0).to(q.dtype)
    return torch.einsum("hqk,khd->qhd", p, v)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """`paddle.nn.functional.flash_attention.flash_attn_unpadded`: varlen
    attention over packed [total_tokens, heads, head_dim] tensors with
    [n_seqs + 1] prefix sums; returns (out, None). head_dim 128 (f32 or
    bf16) runs the segment-id flash bodies (`kernels.flash_attention.
    flash_attn_unpadded`), with dropout in training on a fresh seed from
    the global stream; any other width the dense segment-masked path, which
    raises on dropout in training, as the reference's does.
    `fixed_seed_offset`, `rng_name` and `name` are accepted and unused, as
    in the reference."""
    p = dropout if training else 0.0
    if _fa.supports(_fa.BLOCK, _fa.BLOCK, query.shape[-1], query.dtype):
        return _fa.flash_attn_unpadded(
            query, key, value, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
            max_seqlen_k, scale=scale, dropout=p, causal=causal,
            dropout_seed=_random.next_seed() if p > 0.0 else None)
    if dropout and training:
        raise NotImplementedError("flash_attn_unpadded: dropout unsupported")
    cu_q = torch.as_tensor(cu_seqlens_q, device=query.device).long()
    cu_k = torch.as_tensor(cu_seqlens_k, device=query.device).long()
    if causal and (cu_q.shape != cu_k.shape or not torch.equal(cu_q, cu_k)):
        raise ValueError(
            "flash_attn_unpadded(causal=True) needs cu_seqlens_q == "
            "cu_seqlens_k (per-sequence causal alignment)")
    return _unpadded_dense(query, key, value, cu_q, cu_k, scale, causal), \
        None
