"""Fused transformer encoder layers (counterpart of
`paddle_tpu/incubate/nn/fused_transformer.py`): `fused_multi_head_attention`,
`fused_feedforward`, `FusedMultiHeadAttention`, `FusedFeedForward` and
`FusedTransformerEncoderLayer`.

Parameter names and shapes equal the JAX layers' (`qkv_weight`
[3, heads, head_dim, d], linears in Paddle's [in, out] layout), so a state
maps across by name (`paddle_tpu_torch.weights.fused_encoder_state_*`).
The attention is `F.scaled_dot_product_attention`, so attention dropout in
training takes the flash dropout kernels when `FLAGS_flash_dropout_kernel`
is on and the shape is one they take (head_dim 128, sequence a multiple of
128, no mask). Weights start from the reference's initialisers (Xavier
normal weights, zero biases, unit norm scales) drawn from an explicit
generator, by default one made from the global stream
(`paddle_tpu_torch.seed`). Not ported: `cache_kv` / `cache`,
`FusedMultiTransformer`, `FusedBiasDropoutResidualLayerNorm`.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...framework import random as _random
from ...framework.device import resolve_device
from ...nn import functional as F


def _fan_in_out(shape):
    """The reference initialisers' fans (`nn/initializer._fan_in_out`)."""
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class _Params:
    """Creates a layer's parameters on one device, in one dtype, from one
    generator."""

    def __init__(self, dtype, device, generator):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.generator = generator if generator is not None \
            else _random.generator(self.device)

    def xavier(self, *shape):
        fan_in, fan_out = _fan_in_out(shape)
        std = math.sqrt(2.0 / (fan_in + fan_out))
        w = torch.randn(shape, generator=self.generator, device=self.device)
        return nn.Parameter((w * std).to(self.dtype))

    def const(self, value, *shape):
        return nn.Parameter(torch.full(shape, float(value), dtype=self.dtype,
                                       device=self.device))


def _single_card(ring_id):
    if ring_id != -1:
        raise NotImplementedError(
            f"ring_id={ring_id}: tensor-parallel groups are not ported (the "
            "single-card default is -1)")


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-05, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-05,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, name=None):
    """x [b, s, d]: (pre-LN) -> qkv projection (qkv_weight [3, heads,
    head_dim, d]) -> attention with `attn_dropout_rate` -> out projection
    -> dropout -> + x -> (post-LN). `ring_id` (the tensor-parallel group)
    takes only its single-card default -1; `name` is unused."""
    _single_card(ring_id)
    if cache_kv is not None:
        raise NotImplementedError("fused_multi_head_attention: cache_kv is "
                                  "not ported")
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, [x.shape[-1]], pre_ln_scale, pre_ln_bias,
                         pre_ln_epsilon)
    b, s, d = x.shape
    _, nh, hd, _ = qkv_weight.shape
    qkv = torch.matmul(x, qkv_weight.reshape(3 * nh * hd, d).t())
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.reshape(-1)
    q, k, v = qkv.reshape(b, s, 3, nh, hd).unbind(2)
    out = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0, training=training)
    out = F.linear(out.reshape(b, s, nh * hd), linear_weight, linear_bias)
    if dropout_rate:
        out = F.dropout(out, dropout_rate, training=training, mode=mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, [out.shape[-1]], ln_scale, ln_bias,
                           ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu", ln1_epsilon=1e-5,
                      ln2_epsilon=1e-5, pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, add_residual=True,
                      name=None):
    """x [b, s, d]: (pre-LN) -> linear1 -> activation ("relu" or "gelu")
    -> dropout -> linear2 -> dropout -> + x -> (post-LN). `ring_id` takes
    only its single-card default -1; `name` is unused."""
    _single_card(ring_id)
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, [x.shape[-1]], ln1_scale, ln1_bias, ln1_epsilon)
    out = getattr(F, activation)(F.linear(x, linear1_weight, linear1_bias))
    out = F.dropout(out, dropout1_rate, training=training, mode=mode)
    out = F.linear(out, linear2_weight, linear2_bias)
    out = F.dropout(out, dropout2_rate, training=training, mode=mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, [out.shape[-1]], ln2_scale, ln2_bias,
                           ln2_epsilon)
    return out


class FusedMultiHeadAttention(nn.Module):
    """Self-attention block over x [b, s, embed_dim] (`fused_multi_head_
    attention` with the layer's parameters and training flag)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, normalize_before=False,
                 epsilon=1e-5, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        mk = _Params(dtype, device, generator)
        d = embed_dim
        self.qkv_weight = mk.xavier(3, num_heads, self.head_dim, d)
        self.qkv_bias = mk.const(0.0, 3, num_heads, self.head_dim)
        self.linear_weight = mk.xavier(d, d)
        self.linear_bias = mk.const(0.0, d)
        self.pre_ln_scale = mk.const(1.0, d)
        self.pre_ln_bias = mk.const(0.0, d)
        self.ln_scale = mk.const(1.0, d)
        self.ln_bias = mk.const(0.0, d)

    def forward(self, query, attn_mask=None):
        return fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            ln_epsilon=self._epsilon, training=self.training)


class FusedFeedForward(nn.Module):
    """Feed-forward block over x [b, s, d_model] (`fused_feedforward` with
    the layer's parameters and training flag)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-05, activation="relu", act_dropout_rate=None,
                 normalize_before=False, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = dropout_rate if act_dropout_rate is None \
            else act_dropout_rate
        self._epsilon = epsilon
        mk = _Params(dtype, device, generator)
        self.linear1_weight = mk.xavier(d_model, dim_feedforward)
        self.linear1_bias = mk.const(0.0, dim_feedforward)
        self.linear2_weight = mk.xavier(dim_feedforward, d_model)
        self.linear2_bias = mk.const(0.0, d_model)
        self.ln1_scale = mk.const(1.0, d_model)
        self.ln1_bias = mk.const(0.0, d_model)
        self.ln2_scale = mk.const(1.0, d_model)
        self.ln2_bias = mk.const(0.0, d_model)

    def forward(self, src):
        return fused_feedforward(
            src, self.linear1_weight, self.linear2_weight, self.linear1_bias,
            self.linear2_bias, self.ln1_scale, self.ln1_bias, self.ln2_scale,
            self.ln2_bias, self.act_dropout_rate, self.dropout_rate,
            self.activation, self._epsilon, self._epsilon,
            self.normalize_before, training=self.training)


class FusedTransformerEncoderLayer(nn.Module):
    """`FusedMultiHeadAttention` then `FusedFeedForward`; attention dropout
    defaults to `dropout_rate`."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = _random.generator(device)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=dropout_rate if attn_dropout_rate is None
            else attn_dropout_rate,
            normalize_before=normalize_before, dtype=dtype, device=device,
            generator=generator)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, dtype=dtype, device=device,
            generator=generator)

    def forward(self, src, src_mask=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))
