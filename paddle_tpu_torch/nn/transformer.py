"""Transformer layers (counterpart of `paddle_tpu/nn/transformer.py`):
`MultiHeadAttention` with its incremental `Cache` and `StaticCache`,
`TransformerEncoderLayer` / `TransformerEncoder`,
`TransformerDecoderLayer` / `TransformerDecoder` (each with `gen_cache`)
and `Transformer`.

Attention goes through `F.scaled_dot_product_attention`: without a mask at
head_dim 128 and sequences of multiples of 128 the flash kernels, with
dropout in training the drop bodies under `FLAGS_flash_dropout_kernel`,
else the dense reference path. Parameter names and shapes equal the JAX
layers' (linears [in, out] with biases, `norm1` ..., `layers.N`), so a
state maps across by name (`weights.fused_encoder_state_from_numpy` takes
any module). Weights start from the reference's initialisers (Xavier
normal, zero biases, unit norm scales) drawn from `generator`, by default
one made from the global stream. `weight_attr` takes only None and
`bias_attr` None or False (no bias): parameter attributes wait for
`nn/initializer`.
"""
from __future__ import annotations

import collections
import copy

import torch
from torch import nn

from ..framework import random as _random
from ..framework.device import resolve_device
from . import functional as F
from .layers import Dropout, LayerNorm, Linear, xavier_normal


class _Init:
    """Linears on one device, in one dtype, Xavier-normal from one
    generator."""

    def __init__(self, weight_attr, bias_attr, dtype, device, generator):
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError(
                "parameter attributes are not ported (weight_attr None; "
                "bias_attr None, or False for no bias)")
        self.has_bias = bias_attr is not False
        self.dtype = dtype
        self.device = resolve_device(device)
        self.generator = generator if generator is not None \
            else _random.generator(self.device)

    @property
    def attention_kw(self):
        """The arguments that build a `MultiHeadAttention` of this kind."""
        return dict(bias_attr=None if self.has_bias else False,
                    dtype=self.dtype, device=self.device,
                    generator=self.generator)

    def linear(self, n_in, n_out):
        layer = Linear(n_in, n_out, dtype=self.dtype, device=self.device,
                       has_bias=self.has_bias)
        with torch.no_grad():
            layer.weight.copy_(xavier_normal((n_in, n_out), self.generator,
                                             self.dtype, self.device))
        return layer

    def norm(self, d, eps=1e-5):
        return LayerNorm(d, eps, dtype=self.dtype, device=self.device)


class MultiHeadAttention(nn.Module):
    """Multi-head attention over [b, s, embed_dim] (keys and values of
    `kdim` / `vdim`). With a `Cache` the new keys and values are
    concatenated after the cached ones and (out, new cache) is returned;
    with a `StaticCache` its projected keys and values are used as they are
    and only out is returned (with `need_weights`, (out, None))."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        mk = _Init(weight_attr, bias_attr, dtype, device, generator)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = mk.linear(embed_dim, embed_dim)
        self.k_proj = mk.linear(self.kdim, embed_dim)
        self.v_proj = mk.linear(self.vdim, embed_dim)
        self.out_proj = mk.linear(embed_dim, embed_dim)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """`StaticCache` (type=MultiHeadAttention.StaticCache): the
        projected heads of key and value (default key); else an empty
        incremental `Cache` [b, 0, heads, head_dim] in key's dtype."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return self.Cache(
            torch.zeros(shape, dtype=key.dtype, device=key.device),
            torch.zeros(shape, dtype=key.dtype, device=key.device))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                new_cache = self.Cache(k, v)
            else:
                new_cache = None
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None and not isinstance(cache, self.StaticCache):
            return out, new_cache
        if self.need_weights:
            return out, None
        return out


class TransformerEncoderLayer(nn.Module):
    """Self-attention and a feed-forward block, each with dropout and a
    residual, LayerNorm after each (or before, `normalize_before`)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        mk = _Init(weight_attr, bias_attr, dtype, device, generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **mk.attention_kw)
        self.linear1 = mk.linear(d_model, dim_feedforward)
        self.dropout = Dropout(act_dropout)
        self.linear2 = mk.linear(dim_feedforward, d_model)
        self.norm1 = mk.norm(d_model, layer_norm_eps)
        self.norm2 = mk.norm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    """`num_layers` copies of `encoder_layer` (deep copies: the same initial
    weights), then `norm` where given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Self-attention (incremental `Cache`), cross-attention over `memory`
    (`StaticCache`) and a feed-forward block, each with dropout, a residual
    and LayerNorm after (or before, `normalize_before`)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        mk = _Init(weight_attr, bias_attr, dtype, device, generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **mk.attention_kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **mk.attention_kw)
        self.linear1 = mk.linear(d_model, dim_feedforward)
        self.dropout = Dropout(act_dropout)
        self.linear2 = mk.linear(dim_feedforward, d_model)
        self.norm1 = mk.norm(d_model, layer_norm_eps)
        self.norm2 = mk.norm(d_model, layer_norm_eps)
        self.norm3 = mk.norm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental_cache = None
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
            static_cache = None
        else:
            out = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            tgt = out[0] if isinstance(out, tuple) else out
            static_cache = cache[1]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if cache is None:
            return tgt
        return tgt, (incremental_cache, static_cache)

    def gen_cache(self, memory):
        """(an empty incremental `Cache`, the `StaticCache` of memory)."""
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    """`num_layers` copies of `decoder_layer`, then `norm` where given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            caches = list(zip(*caches))
        return caches


class Transformer(nn.Module):
    """An encoder and a decoder stack (or `custom_encoder` /
    `custom_decoder`); with `normalize_before` each stack ends in a
    LayerNorm."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = _random.generator(device)
        layer_kw = dict(dtype=dtype, device=device, generator=generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **layer_kw)
            enc_norm = LayerNorm(d_model, dtype=dtype, device=device) \
                if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **layer_kw)
            dec_norm = LayerNorm(d_model, dtype=dtype, device=device) \
                if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """[length, length] f32 additive causal mask: 0 on and below the
        diagonal, -inf above; on `device` (default the current CUDA
        device)."""
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.where(keep, 0.0, float("-inf")).to(torch.float32)
