"""Fused transformer layers (counterpart of
`paddle_tpu/incubate/nn/fused_transformer.py`): `fused_multi_head_attention`,
`fused_feedforward`, `FusedMultiHeadAttention`, `FusedFeedForward`,
`FusedTransformerEncoderLayer`, the decoder stack `FusedMultiTransformer`
and `FusedBiasDropoutResidualLayerNorm`.

Parameter names and shapes equal the JAX layers' (`qkv_weight`
[3, heads, head_dim, d], linears in Paddle's [in, out] layout), so a state
maps across by name (`paddle_tpu_torch.weights.fused_encoder_state_*`).
The attention is `F.scaled_dot_product_attention`, so attention dropout in
training takes the flash dropout kernels when `FLAGS_flash_dropout_kernel`
is on and the shape is one they take (head_dim 128, sequence a multiple of
128, no mask). Weights start from the reference's initialisers (Xavier
normal weights, zero biases, unit norm scales) drawn from an explicit
generator, by default one made from the global stream
(`paddle_tpu_torch.seed`). The encoder layers' `key`, `value` and `cache`
are accepted and unused, as in the reference; `cache_kv` of the functional
form raises (the reference's drops it too, but silently).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...framework import random as _random
from ...framework.device import resolve_device
from ...nn import functional as F
from ...nn.layers import xavier_normal


class _Params:
    """Creates a layer's parameters on one device, in one dtype, the random
    ones from one generator (without one, a generator drawn from the global
    stream at the first random weight)."""

    def __init__(self, dtype, device, generator=None):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.generator = generator

    def xavier(self, *shape):
        if self.generator is None:  # drawn from the global stream once
            self.generator = _random.generator(self.device)
        return nn.Parameter(xavier_normal(shape, self.generator, self.dtype,
                                          self.device))

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

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """Self-attention over `query`; `key`, `value` and `cache` are
        accepted and unused, as in the reference."""
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

    def forward(self, src, cache=None):
        """`cache` is accepted and unused, as in the reference."""
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

    def forward(self, src, src_mask=None, cache=None):
        """`cache` is accepted and unused, as in the reference."""
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


def _no_attrs(**attrs):
    """The *_attrs arguments (ParamAttr lists) take only None, or lists of
    None that count the layers: initialisers and names wait for
    `nn/initializer`."""
    for name, a in attrs.items():
        items = a if isinstance(a, (list, tuple)) else [a]
        if any(x is not None for x in items):
            raise NotImplementedError(
                f"FusedMultiTransformer({name}=...): parameter attributes "
                "are not ported (pass None)")


class FusedMultiTransformer(nn.Module):
    """A pre-norm decoder stack with a dense KV cache (the reference's
    serving module). Per-layer parameter lists as the reference lays them
    out: `ln_scales` / `ln_biases` [d], `qkv_weights` [3, heads, head_dim,
    d] (this layout whatever `trans_qkvw` says, as in the reference),
    `qkv_biases` [3, heads, head_dim], `linear_weights` [d, d] and
    `linear_biases`, `ffn_ln_scales` / `ffn_ln_biases`, `ffn1_weights` [d,
    ffn], `ffn1_biases`, `ffn2_weights` [ffn, d], `ffn2_biases`.

    `forward(src)` is the context forward: each layer's attention through
    `F.scaled_dot_product_attention`, causal when there is no `attn_mask`
    (the flash kernel at head_dim 128 and sequences of multiples of 128).
    With `caches` (`gen_cache`'s [2, b, heads, max_len, head_dim] tensors)
    the s tokens' K/V are written at `time_step`..`time_step + s - 1`, in
    place, and every query attends the cache up to its own position (plain
    PyTorch: XLA code in the reference); it returns (out, caches). A cache
    must have the K/V's dtype: an f32 cache under bf16 weights raises the
    reference's TypeError. `pre_caches`, `rotary_embs`, `rotary_emb_dims`
    and `seq_lens` are accepted and unused, as in the reference.

    The qkv biases add per q / k / v. The reference adds `bias[:, None,
    None]` to [b, 3, s, heads, head_dim], which broadcasts the 3 against
    the batch: it raises unless b == 3 and, at b == 3, agrees with this
    only for zero biases (its initial ones)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, ln_bias_attrs=None,
                 qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None, epsilon=1e-5,
                 num_layers=-1, nranks=1, trans_qkvw=True, ring_id=-1,
                 name=None, dtype=torch.float32, device=None,
                 generator=None):
        _no_attrs(**{k: v for k, v in locals().items()
                     if k.endswith("_attrs")})
        super().__init__()
        assert normalize_before, "FusedMultiTransformer is pre-norm only"
        _single_card(ring_id)
        if nranks != 1:
            raise NotImplementedError(
                f"nranks={nranks}: tensor parallelism is not ported")
        if num_layers < 0:
            num_layers = len(qkv_weight_attrs) if isinstance(
                qkv_weight_attrs, (list, tuple)) else 1
        self.num_layers = num_layers
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dim_feedforward = dim_feedforward
        self._epsilon = epsilon
        self.activation = activation
        self.dropout_rate = dropout_rate
        mk = _Params(dtype, device, generator)
        d, nh, hd, ff = embed_dim, num_heads, self.head_dim, dim_feedforward
        self.ln_scales, self.ln_biases = nn.ParameterList(), \
            nn.ParameterList()
        self.qkv_weights, self.qkv_biases = nn.ParameterList(), \
            nn.ParameterList()
        self.linear_weights, self.linear_biases = nn.ParameterList(), \
            nn.ParameterList()
        self.ffn_ln_scales, self.ffn_ln_biases = nn.ParameterList(), \
            nn.ParameterList()
        self.ffn1_weights, self.ffn1_biases = nn.ParameterList(), \
            nn.ParameterList()
        self.ffn2_weights, self.ffn2_biases = nn.ParameterList(), \
            nn.ParameterList()
        for _ in range(num_layers):
            self.ln_scales.append(mk.const(1.0, d))
            self.ln_biases.append(mk.const(0.0, d))
            self.qkv_weights.append(mk.xavier(3, nh, hd, d))
            self.qkv_biases.append(mk.const(0.0, 3, nh, hd))
            self.linear_weights.append(mk.xavier(d, d))
            self.linear_biases.append(mk.const(0.0, d))
            self.ffn_ln_scales.append(mk.const(1.0, d))
            self.ffn_ln_biases.append(mk.const(0.0, d))
            self.ffn1_weights.append(mk.xavier(d, ff))
            self.ffn1_biases.append(mk.const(0.0, ff))
            self.ffn2_weights.append(mk.xavier(ff, d))
            self.ffn2_biases.append(mk.const(0.0, d))

    def gen_cache(self, batch_size, max_length):
        """Dense KV caches, one [2, b, heads, max_length, head_dim] f32
        tensor a layer (as the reference's), on the module's device."""
        dev = self.ln_scales[0].device
        return [torch.zeros(2, batch_size, self.num_heads, max_length,
                            self.head_dim, dtype=torch.float32, device=dev)
                for _ in range(self.num_layers)]

    def _cached_attention(self, q, k, v, cache, time_step):
        """Write k, v [b, s, heads, d] at time_step (the start clamped so
        the window fits, as the reference's dynamic_update_slice clamps),
        then attend: query i sees cache positions <= time_step + i."""
        if cache.dtype != k.dtype:
            raise TypeError(
                "FusedMultiTransformer: the cache is "
                f"{str(cache.dtype).replace('torch.', '')} but the keys are "
                f"{str(k.dtype).replace('torch.', '')} (the reference's "
                "dynamic_update_slice requires arguments to have the same "
                "dtypes)")
        s, max_len = q.shape[1], cache.shape[3]
        t0 = min(max(int(time_step), 0), max_len - s)
        cache[0, :, :, t0:t0 + s] = k.transpose(1, 2)
        cache[1, :, :, t0:t0 + s] = v.transpose(1, 2)
        qt = q.transpose(1, 2)
        logits = torch.einsum("bhqd,bhkd->bhqk", qt, cache[0]) \
            / math.sqrt(self.head_dim)
        pos_k = torch.arange(max_len, device=q.device)
        pos_q = int(time_step) + torch.arange(s, device=q.device)
        mask = pos_k[None, :] <= pos_q[:, None]
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p, cache[1]).transpose(1, 2)

    def _layer(self, i, x, attn_mask, cache, time_step):
        residual = x
        out = F.layer_norm(x, [self.embed_dim], self.ln_scales[i],
                           self.ln_biases[i], self._epsilon)
        b, s = out.shape[:2]
        w = self.qkv_weights[i]
        qkv = torch.matmul(out, w.reshape(-1, self.embed_dim).t()) \
            + self.qkv_biases[i].reshape(-1)
        q, k, v = qkv.reshape(b, s, 3, self.num_heads,
                              self.head_dim).unbind(2)
        if cache is not None:
            attn = self._cached_attention(q, k, v, cache, time_step)
        else:
            attn = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None,
                training=self.training)
        x = residual + F.linear(attn.reshape(b, s, self.embed_dim),
                                self.linear_weights[i],
                                self.linear_biases[i])
        out = F.layer_norm(x, [self.embed_dim], self.ffn_ln_scales[i],
                           self.ffn_ln_biases[i], self._epsilon)
        out = getattr(F, self.activation)(
            F.linear(out, self.ffn1_weights[i], self.ffn1_biases[i]))
        return x + F.linear(out, self.ffn2_weights[i], self.ffn2_biases[i])

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                rotary_embs=None, rotary_emb_dims=0, seq_lens=None,
                time_step=None):
        """src [b, s, d] -> out [b, s, d], or (out, caches) with `caches`
        (decoding at `time_step`, default 0)."""
        x = src
        t = 0 if time_step is None else time_step
        for i in range(self.num_layers):
            x = self._layer(i, x, attn_mask,
                            None if caches is None else caches[i], t)
        if caches is not None:
            return x, list(caches)
        return x


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """LayerNorm(residual + dropout(x + bias)) with the layer's
    `linear_bias` (0), `ln_scale` (1) and `ln_bias` (0) and its training
    flag (`functional.fused_bias_dropout_residual_layer_norm`).
    `weight_attr`, `bias_attr` and `name` are accepted and unused, as in
    the reference."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        mk = _Params(dtype, device)
        self.linear_bias = mk.const(0.0, embed_dim)
        self.ln_scale = mk.const(1.0, embed_dim)
        self.ln_bias = mk.const(0.0, embed_dim)

    def forward(self, x, residual):
        from .functional import fused_bias_dropout_residual_layer_norm

        return fused_bias_dropout_residual_layer_norm(
            x, residual, self.linear_bias, self.ln_scale, self.ln_bias,
            self.dropout_rate, self.epsilon, training=self.training)
