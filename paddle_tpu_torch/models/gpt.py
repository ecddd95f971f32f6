"""GPT-2/3-family causal LM (counterpart of `paddle_tpu/models/gpt.py`):
learned position embeddings (no rope), LayerNorm, a fused QKV projection
with bias, a 4x GELU (tanh) MLP, a final LayerNorm before the (by default
tied) head. It keeps LLaMA's contracts: `forward` (training; causal
attention through `F.scaled_dot_product_attention`, so the flash kernels at
the shapes they take), `forward_cached` (a dense-cache prefill or step, used
by `generate` and the engine's prefill), `forward_paged` (the serving step:
decode, a prefill chunk or a speculative window, with every keyword the
engine hands `LlamaForCausalLM.forward_paged`) and `pp_embed` / `pp_layers`
/ `pp_head`.

Parameter names and shapes equal the JAX model's, linears in Paddle's
[in, out] layout (`paddle_tpu_torch.weights.load_gpt_state`).
`config.scan_layers` is accepted and leaves the layer loop as it is.

Positions: `forward` and `forward_cached` at a Python-int offset raise the
reference's `ValueError`s where a position would pass
`max_position_embeddings`; at a tensor offset (the decode steps of
`generate`) and in `forward_paged` the positions are clamped to the last
row on the device, which is what the reference's gather does (an embedding
lookup past the table on CUDA would instead fire a device assert). The
speculative draft steps and the verify window embed positions past a row's
limit; those positions are never committed.

Tensor parallelism (a global mesh with "tp" > 1): the reference's layout
(`paddle_tpu/models/gpt.py:80-85, 171-175, 225, 310`): the fused QKV and
`fc_in` column-parallel without gather (their biases sharded), `out_proj`
and `fc_out` row-parallel with `input_is_parallel` (biases replicated,
added after the all_reduce), a vocab-parallel token embedding, replicated
positions, a column-parallel untied head. The QKV columns are head-major,
so a rank's contiguous column shard holds whole heads (q, k and v of
heads / tp heads); each rank runs those heads.

Pipeline parallelism (a global mesh with "pp" > 1): as LLaMA's, the model
holds its stage; the token and position embeddings sit on the first
stage, the final LayerNorm on the last, and the tied head's token
embedding on both (its gradient summed over the two).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..distributed.fleet.layers.mpu.mp_layers import (ColumnParallelLinear,
                                                      RowParallelLinear,
                                                      VocabParallelEmbedding)
from ..distributed.fleet.utils.recompute import recompute
from ..distributed.pipeline import StageLayers
from ..framework.device import resolve_device, torch_dtype
from ..kernels import paged_attention as _pa
from ..nn import Embedding, LayerNorm, ParallelCrossEntropy
from ..nn import functional as F
from .causal_lm import CausalLMBase, pp_setup, tp_setup
from .paged_step import paged_attention_step


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    intermediate_size: int = 0  # 0 -> 4 * hidden (GPT's convention)
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    use_recompute: bool = False
    # accepted; the layers run as a plain loop either way
    scan_layers: bool = False
    # > 0: the training step's loss is the chunked LM-head cross entropy
    fused_ce_chunks: int = 0
    dtype: str = "float32"

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size

    @staticmethod
    def gpt2_small():
        return GPTConfig(hidden_size=768, num_hidden_layers=12,
                         num_attention_heads=12)

    @staticmethod
    def gpt3_1p3b():
        return GPTConfig(hidden_size=2048, num_hidden_layers=24,
                         num_attention_heads=16,
                         max_position_embeddings=2048)

    @staticmethod
    def tiny(vocab=128, hidden=32, layers=2, heads=2, seq=32):
        return GPTConfig(vocab_size=vocab, hidden_size=hidden,
                         num_hidden_layers=layers,
                         num_attention_heads=heads,
                         max_position_embeddings=seq)


class GPTAttention(nn.Module):
    """Causal self-attention through one fused QKV projection with bias;
    `num_heads`: this rank's heads."""

    def __init__(self, config, dtype, device, tp=1):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads // tp
        self.head_dim = h // config.num_attention_heads
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, has_bias=True,
                                             gather_output=False,
                                             dtype=dtype, device=device)
        self.out_proj = RowParallelLinear(h, h, has_bias=True,
                                          input_is_parallel=True,
                                          dtype=dtype, device=device)

    def _qkv(self, hidden_states):
        """[b, s, 3 * hidden] -> q, k, v [b, s, heads, d]. The fused
        columns are head-major: head h owns the block [3 d h, 3 d (h + 1))
        as (q, k, v), the reference's layout (a [3, heads] split has the
        same shapes and computes something else)."""
        b, s = hidden_states.shape[:2]
        qkv = self.qkv_proj(hidden_states).reshape(b, s, self.num_heads, 3,
                                                    self.head_dim)
        return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]

    def _out(self, out, b, s):
        return self.out_proj(out.reshape(b, s, self.num_heads
                                         * self.head_dim))

    def forward(self, hidden_states, attn_mask=None):
        """Causal attention from position 0 (training); `attn_mask` ([b, 1,
        1, s] or broadcastable, bool or additive) applies on top of the
        causal mask, as the reference's SDPA takes both."""
        b, s = hidden_states.shape[:2]
        q, k, v = self._qkv(hidden_states)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=True,
            training=self.training)
        return self._out(out, b, s)

    def forward_cached(self, hidden_states, kv_cache, cur_len):
        """The s new tokens' K/V into the dense cache (k_cache, v_cache),
        each [b, max_len, heads, d], at cur_len..cur_len+s-1 (in place),
        then SDPA over the whole cache with an explicit mask (key position
        <= query position) in the model's dtype, not LLaMA's f32 einsum.
        Returns (out [b, s, hidden], kv_cache)."""
        b, s = hidden_states.shape[:2]
        q, k, v = self._qkv(hidden_states)
        kc, vc = kv_cache
        off = int(cur_len)
        kc[:, off:off + s] = k.to(kc.dtype)
        vc[:, off:off + s] = v.to(vc.dtype)
        total = kc.shape[1]
        pos_q = off + torch.arange(s, device=q.device)[:, None]
        pos_k = torch.arange(total, device=q.device)[None, :]
        mask = (pos_k <= pos_q)[None, None]
        out = F.scaled_dot_product_attention(
            q, kc.to(q.dtype), vc.to(q.dtype), attn_mask=mask,
            is_causal=False, training=False)
        return self._out(out, b, s), (kc, vc)

    def forward_paged(self, hidden_states, paged_cache, block_tables,
                      context_lens, active=None, scratch_page=None,
                      limit_lens=None, rows=None):
        """The serving step over the paged cache (`paged_step`), with no
        rotation: positions are embedded at the model level."""
        b, s = hidden_states.shape[:2]
        q, k, v = self._qkv(hidden_states)
        out, cache = paged_attention_step(
            q, k, v, paged_cache, block_tables, context_lens, active=active,
            scratch_page=scratch_page, limit_lens=limit_lens, rows=rows)
        return self.out_proj(out), cache


class GPTMLP(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.fc_in = ColumnParallelLinear(h, i, has_bias=True,
                                          gather_output=False, dtype=dtype,
                                          device=device)
        self.fc_out = RowParallelLinear(i, h, has_bias=True,
                                        input_is_parallel=True, dtype=dtype,
                                        device=device)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class GPTDecoderLayer(nn.Module):
    def __init__(self, config, dtype, device, tp=1):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        self.ln_1 = LayerNorm(h, eps, dtype=dtype, device=device)
        self.attn = GPTAttention(config, dtype, device, tp)
        self.ln_2 = LayerNorm(h, eps, dtype=dtype, device=device)
        self.mlp = GPTMLP(config, dtype, device)
        self.use_recompute = config.use_recompute

    def _finish(self, residual, attn_out):
        h = residual + attn_out
        return h + self.mlp(self.ln_2(h))

    def _inner(self, hidden_states, attn_mask=None):
        return self._finish(hidden_states,
                            self.attn(self.ln_1(hidden_states), attn_mask))

    def forward(self, hidden_states, attn_mask=None):
        if self.use_recompute and self.training:
            return recompute(self._inner, hidden_states, attn_mask)
        return self._inner(hidden_states, attn_mask)

    def forward_cached(self, hidden_states, kv_cache, cur_len):
        a, cache = self.attn.forward_cached(self.ln_1(hidden_states),
                                            kv_cache, cur_len)
        return self._finish(hidden_states, a), cache

    def forward_paged(self, hidden_states, paged_cache, block_tables,
                      context_lens, active=None, scratch_page=None,
                      limit_lens=None, rows=None):
        a, cache = self.attn.forward_paged(
            self.ln_1(hidden_states), paged_cache, block_tables,
            context_lens, active=active, scratch_page=scratch_page,
            limit_lens=limit_lens, rows=rows)
        return self._finish(hidden_states, a), cache


class GPTModel(nn.Module):
    """`layout` (a `distributed.pipeline.Layout`): at pp > 1 only the
    stage's layers (`StageLayers`, by global index), the token and
    position embeddings on the first stage (the token embedding also on
    the last where `embed` asks for it: the tied head), the final
    LayerNorm on the last."""

    def __init__(self, config, dtype, device, tp=1, layout=None,
                 embed=False):
        super().__init__()
        self.config = config
        h = config.hidden_size
        split = layout is not None and layout.split
        self.split = split
        first = not split or layout.first
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, h, dtype=dtype, device=device) \
            if first or embed else None
        self.embed_positions = Embedding(
            config.max_position_embeddings, h, dtype=dtype,
            device=device) if first else None
        if split:
            self.layers = StageLayers(
                {i: GPTDecoderLayer(config, dtype, device, tp)
                 for i in layout.layer_ids})
        else:
            self.layers = nn.ModuleList(
                [GPTDecoderLayer(config, dtype, device, tp)
                 for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(h, config.layer_norm_epsilon, dtype=dtype,
                              device=device) if not split or layout.last \
            else None
        self._layout = layout

    def _whole(self, what):
        if self.split:
            self._layout.refuse(what)

    def _positions(self, pos):
        """Position ids clamped to the table's last row (the reference's
        gather), on the device: no host check."""
        return pos.clamp(max=self.config.max_position_embeddings - 1)

    def _embed(self, input_ids, position_offset=0):
        """Token plus learned position embeddings of [b, s] ids at
        positions offset..offset+s-1. A Python-int offset raises where a
        position passes `max_position_embeddings` (the reference's static
        checks); a tensor offset clamps."""
        s = input_ids.shape[1]
        max_pos = self.config.max_position_embeddings
        if s > max_pos:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{max_pos}")
        if isinstance(position_offset, int) and position_offset + s > max_pos:
            raise ValueError(
                f"position {position_offset + s} exceeds "
                f"max_position_embeddings {max_pos} (shorten the prompt "
                "or max_new_tokens, or raise max_position_embeddings)")
        dev = input_ids.device
        pos = torch.arange(s, device=dev)
        if torch.is_tensor(position_offset):
            pos = self._positions(pos + position_offset.to(dev))
        else:
            pos = pos + int(position_offset)
        return self.embed_tokens(input_ids) + self.embed_positions(pos[None])

    def forward(self, input_ids, attn_mask=None):
        self._whole("GPTModel.forward")
        h = self._embed(input_ids)
        for layer in self.layers:
            h = layer(h, attn_mask)
        return self.ln_f(h)

    def forward_cached(self, input_ids, caches, cur_len):
        self._whole("serving")
        h = self._embed(input_ids, position_offset=cur_len)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            h, nc = layer.forward_cached(h, cache, cur_len)
            new_caches.append(nc)
        return self.ln_f(h), new_caches

    def forward_paged(self, input_ids, paged_caches, block_tables,
                      context_lens, active=None, scratch_page=None,
                      limit_lens=None, max_layers=None, window_rows=False):
        """Per-row learned positions: row b's s tokens sit at
        context_lens[b]..+s-1 (clamped on the device). max_layers and
        window_rows as `LlamaModel.forward_paged`'s."""
        self._whole("serving")
        dev = input_ids.device
        s = input_ids.shape[1]
        pos = context_lens.to(dev, torch.int64, non_blocking=True)[:, None] \
            + torch.arange(s, device=dev)[None, :]
        h = self.embed_tokens(input_ids) \
            + self.embed_positions(self._positions(pos))
        rows = _pa.window_rows(block_tables, context_lens, s, limit_lens,
                               active) if window_rows and s > 1 else None
        layers = self.layers if max_layers is None \
            else self.layers[:max_layers]
        new_caches = []
        for layer, cache in zip(layers, paged_caches):
            h, nc = layer.forward_paged(h, cache, block_tables,
                                        context_lens, active=active,
                                        scratch_page=scratch_page,
                                        limit_lens=limit_lens, rows=rows)
            new_caches.append(nc)
        return self.ln_f(h), new_caches


class GPTForCausalLM(CausalLMBase):
    """GPT with its vocab head (tied to the token embedding by default), on
    `device` (default: the current CUDA device) in `config.dtype`. Weights
    start random from `seed` (`init_weights`);
    `paddle_tpu_torch.weights.load_gpt_state` replaces them with the JAX
    model's."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = config
        tp_setup(self, {"num_attention_heads": config.num_attention_heads})
        pp_setup(self, config.num_hidden_layers)
        dev = resolve_device(device)
        dtype = torch_dtype(config.dtype)
        tie = config.tie_word_embeddings
        self.gpt = GPTModel(config, dtype, dev, self.tp_degree, self.pp,
                            embed=tie and self.pp.last)
        self.lm_head = None if tie or not self.pp.last else \
            ColumnParallelLinear(config.hidden_size, config.vocab_size,
                                 has_bias=False, gather_output=False,
                                 dtype=dtype, device=dev)
        self.loss_fn = ParallelCrossEntropy()
        self._mark_tied()
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed, std=0.02):
        """Linear and embedding weights ~ N(0, std^2); LayerNorm weights 1;
        every bias 0. Drawn on the model's own device from a generator
        seeded with `seed`. A sharded weight is this rank's slice of the
        full tensor (`_normal_full_`), so the model equals the tp = 1 model
        of the same seed; at pp > 1 each rank holds its stage's slice of
        the pp = 1 model of the seed (`_seeded_init`)."""
        from ..weights import gpt_param_shapes

        def rule(name):
            if name.endswith(".bias"):
                return "zero"
            return "one" if ".ln_" in name else "normal"

        self._seeded_init(seed, std, rule, gpt_param_shapes(self.config))

    def forward(self, input_ids, attn_mask=None):
        return self._head(self.gpt(input_ids, attn_mask))

    def forward_cached(self, input_ids, caches, cur_len):
        h, new_caches = self.gpt.forward_cached(input_ids, caches, cur_len)
        return self._head(h), new_caches

    def forward_paged(self, input_ids, paged_caches, block_tables,
                      context_lens, active=None, scratch_page=None,
                      limit_lens=None, max_layers=None, window_rows=False):
        """As `LlamaForCausalLM.forward_paged`: [b, s] ids at positions
        context_lens..context_lens+s-1 over the paged caches -> ([b, s,
        vocab] logits, caches)."""
        h, new_caches = self.gpt.forward_paged(
            input_ids, paged_caches, block_tables, context_lens,
            active=active, scratch_page=scratch_page, limit_lens=limit_lens,
            max_layers=max_layers, window_rows=window_rows)
        return self._head(h), new_caches

    def _backbone_embed_weight(self):
        return self.gpt.embed_tokens.weight

    # the pipeline decomposition: LLaMA's contract
    def pp_embed(self, input_ids):
        return self.gpt._embed(input_ids)

    def pp_layers(self):
        """The decoder layers this rank holds, in order."""
        return list(self.gpt.layers)

    def pp_head(self, hidden):
        return self._head(self.gpt.ln_f(hidden))
