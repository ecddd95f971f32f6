"""LLaMA-family causal LM (counterpart of `paddle_tpu/models/llama.py`), the
serving paths: the dense-cache forward `forward_cached` (batched prefill)
and the paged single-token decode `forward_paged`.

Parameter names and shapes equal the JAX model's, linears in Paddle's
[in, out] layout. The training forward (flash attention, ring and zigzag
context parallelism, scan-stacked layers) is not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as TF
from torch import nn

from ..framework.device import resolve_device, torch_dtype
from ..nn import Embedding, Linear, RMSNorm
from ..nn.functional import apply_rope, rope_tables
from .causal_lm import CausalLMBase
from .paged_step import paged_attention_step


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"

    @staticmethod
    def llama2_7b():
        return LlamaConfig(hidden_size=4096, intermediate_size=11008,
                           num_hidden_layers=32, num_attention_heads=32)

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, seq=128):
        return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                           intermediate_size=hidden * 4,
                           num_hidden_layers=layers,
                           num_attention_heads=heads,
                           num_key_value_heads=heads,
                           max_position_embeddings=seq)


class LlamaMLP(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, i, dtype=dtype, device=device)
        self.up_proj = Linear(h, i, dtype=dtype, device=device)
        self.down_proj = Linear(i, h, dtype=dtype, device=device)

    def forward(self, x):
        return self.down_proj(TF.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaAttention(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_attention_heads ({self.num_heads}) must be divisible "
                f"by num_key_value_heads ({self.num_kv_heads})")
        self.head_dim = config.hidden_size // self.num_heads
        self.rope_theta = config.rope_theta
        hs = config.hidden_size
        kv = self.num_kv_heads * self.head_dim
        self.q_proj = Linear(hs, self.num_heads * self.head_dim, dtype=dtype,
                             device=device)
        self.k_proj = Linear(hs, kv, dtype=dtype, device=device)
        self.v_proj = Linear(hs, kv, dtype=dtype, device=device)
        self.o_proj = Linear(self.num_heads * self.head_dim, hs, dtype=dtype,
                             device=device)

    def _qkv(self, hidden_states):
        b, s = hidden_states.shape[:2]
        q = self.q_proj(hidden_states).reshape(b, s, self.num_heads,
                                               self.head_dim)
        k = self.k_proj(hidden_states).reshape(b, s, self.num_kv_heads,
                                               self.head_dim)
        v = self.v_proj(hidden_states).reshape(b, s, self.num_kv_heads,
                                               self.head_dim)
        return q, k, v

    def _rotate(self, q, k, offset):
        cos, sin = rope_tables(q.shape[1], self.head_dim,
                               base=self.rope_theta, dtype=q.dtype,
                               position_offset=offset, device=q.device)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin)

    def forward_cached(self, hidden_states, kv_cache, cur_len):
        """Prefill/decode over a dense cache (k_cache, v_cache), each
        [b, max_len, kv_heads, d]: cur_len tokens are present and the s new
        tokens land at cur_len..cur_len+s-1. The caches are written in
        place. Returns (out [b, s, hidden], kv_cache)."""
        b, s = hidden_states.shape[:2]
        q, k, v = self._qkv(hidden_states)
        q, k = self._rotate(q, k, cur_len)
        kc, vc = kv_cache
        kc[:, cur_len:cur_len + s] = k.to(kc.dtype)
        vc[:, cur_len:cur_len + s] = v.to(vc.dtype)
        kr, vr = kc, vc
        rep = self.num_heads // self.num_kv_heads
        if rep != 1:
            kr = kr.repeat_interleave(rep, dim=2)
            vr = vr.repeat_interleave(rep, dim=2)
        scale = 1.0 / math.sqrt(self.head_dim)
        scores = torch.einsum("bshd,bThd->bhsT", q.float(), kr.float()) \
            * scale
        S = kr.shape[1]
        q_pos = cur_len + torch.arange(s, device=q.device)[:, None]
        k_pos = torch.arange(S, device=q.device)[None, :]
        scores = scores.masked_fill(~(k_pos <= q_pos), -1e30)
        p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhsT,bThd->bshd", p, vr.float()).to(q.dtype)
        out = out.reshape(b, s, self.num_heads * self.head_dim)
        return self.o_proj(out), (kc, vc)

    def forward_paged(self, hidden_states, paged_cache, block_tables,
                      context_lens, active=None):
        """Single-token decode over the paged cache (models.paged_step).
        hidden_states: [b, 1, hidden]. Returns (out, paged_cache)."""
        q, k, v = self._qkv(hidden_states)
        out, cache = paged_attention_step(
            q, k, v, paged_cache, block_tables, context_lens, active=active,
            rotate=self._rotate)
        return self.o_proj(out), cache


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, dtype,
                                       device)
        self.self_attn = LlamaAttention(config, dtype, device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                dtype, device)
        self.mlp = LlamaMLP(config, dtype, device)

    def _finish(self, residual, attn_out):
        h = residual + attn_out
        return h + self.mlp(self.post_attention_layernorm(h))

    def forward_cached(self, hidden_states, kv_cache, cur_len):
        h, cache = self.self_attn.forward_cached(
            self.input_layernorm(hidden_states), kv_cache, cur_len)
        return self._finish(hidden_states, h), cache

    def forward_paged(self, hidden_states, paged_cache, block_tables,
                      context_lens, active=None):
        h, cache = self.self_attn.forward_paged(
            self.input_layernorm(hidden_states), paged_cache, block_tables,
            context_lens, active=active)
        return self._finish(hidden_states, h), cache


class LlamaModel(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      dtype, device)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, dtype, device)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype,
                            device)

    def forward_cached(self, input_ids, caches, cur_len):
        """caches: per-layer (k_cache, v_cache). Returns (hidden,
        caches)."""
        h = self.embed_tokens(input_ids)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            h, nc = layer.forward_cached(h, cache, cur_len)
            new_caches.append(nc)
        return self.norm(h), new_caches

    def forward_paged(self, input_ids, paged_caches, block_tables,
                      context_lens, active=None):
        h = self.embed_tokens(input_ids)
        new_caches = []
        for layer, cache in zip(self.layers, paged_caches):
            h, nc = layer.forward_paged(h, cache, block_tables,
                                        context_lens, active=active)
            new_caches.append(nc)
        return self.norm(h), new_caches


class LlamaForCausalLM(CausalLMBase):
    """LLaMA with its vocab head, on `device` (default: the current CUDA
    device) in `config.dtype`. Weights start random from `seed`
    (`init_weights`); `paddle_tpu_torch.weights.load_llama_state` replaces
    them with the JAX model's."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dtype = torch_dtype(config.dtype)
        self.llama = LlamaModel(config, dtype, dev)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, dtype=dtype, device=dev)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed, std=0.02):
        """Linear and embedding weights ~ N(0, std^2), norm weights 1, drawn
        on the model's own device from a generator seeded with `seed`."""
        dev = self._backbone_embed_weight().device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("layernorm.weight") or name == "llama.norm.weight":
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=gen)

    def forward_cached(self, input_ids, caches, cur_len):
        h, new_caches = self.llama.forward_cached(input_ids, caches, cur_len)
        return self._head(h), new_caches

    def forward_paged(self, input_ids, paged_caches, block_tables,
                      context_lens, active=None):
        h, new_caches = self.llama.forward_paged(
            input_ids, paged_caches, block_tables, context_lens,
            active=active)
        return self._head(h), new_caches

    def _backbone_embed_weight(self):
        return self.llama.embed_tokens.weight
