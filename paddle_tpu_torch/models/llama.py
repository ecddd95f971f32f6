"""LLaMA-family causal LM (counterpart of `paddle_tpu/models/llama.py`): the
training forward `forward` (causal attention through
`F.scaled_dot_product_attention`, so the flash kernels at the shapes they
take; with a padding `attn_mask`, folded into the causal mask, the dense
reference path, as in the reference), the dense-cache forward
`forward_cached` (batched prefill) and the paged step `forward_paged`
(single-token decode, or a window of tokens: a prefill chunk or a
speculative verify; `max_layers` runs a shallow-exit draft). `config.use_recompute` recomputes each decoder layer's
activations in training (`distributed.fleet.utils.recompute`).

Parameter names and shapes equal the JAX model's, linears in Paddle's
[in, out] layout. `config.scan_layers` is accepted and leaves the layer
loop as it is (the reference's `lax.scan` over stacked layers shrinks a
compiled program; an eager PyTorch loop has none to shrink).
`config.cp_zigzag_stream=True` raises: context parallelism is not ported.

Tensor parallelism: built under a global mesh with a "tp" axis of degree
tp > 1 (`fleet.init` with `mp_degree`), the model holds this rank's shards
as the reference lays them out (`paddle_tpu/models/llama.py:99-136, 390,
455-463`): q/k/v/gate/up column-parallel without gather, o/down
row-parallel with `input_is_parallel`, a vocab-parallel embedding, a
column-parallel head without gather into `ParallelCrossEntropy`; each rank
runs num_heads / tp query heads and kv_heads / tp KV heads; the serving
forwards (`forward_cached`, `forward_paged`) return the rank's vocab shard
of the logits, which the serving engine and `generate` gather. Heads that
tp does not divide raise (each rank holds whole heads), as does a mesh
with "sp" or "sep" > 1 (context parallelism). `config.sequence_parallel`
(PaddleNLP's switch; the reference's LLaMA has none) at tp > 1 runs the
training forward with Megatron sequence parallelism
(`fleet/utils/sequence_parallel_utils.py`): the activations between the
blocks are split along the sequence over "tp", the projections into a
block are `ColumnSequenceParallelLinear`s and out of it
`RowSequenceParallelLinear`s, and the norms' weights are marked
sequence-parallel; the final norm's output is gathered whole.

Pipeline parallelism: built under a global mesh with a "pp" axis of S > 1
stages, the model holds only its stage (`distributed.pipeline.Layout`):
the decoder layers of `stage_layer_ids` (with `config.virtual_pp_degree`
v > 1, the interleaved layout), the embedding on the first stage, the
final norm and head on the last, a tied embedding on both. The
decomposition `pp_embed` / `pp_layers` / `pp_head` is the reference's;
the schedules run it (`models.trainer.build_pipeline_train_step`,
`PipelineParallel`), and the whole-model forwards raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as TF
from torch import nn

from ..framework.device import resolve_device, torch_dtype
from ..kernels import paged_attention as _pa
from ..distributed.fleet.layers.mpu.mp_layers import (ColumnParallelLinear,
                                                      RowParallelLinear,
                                                      VocabParallelEmbedding)
from ..distributed.fleet.utils import sequence_parallel_utils as _sp
from ..distributed.fleet.utils.recompute import recompute
from ..distributed.pipeline import StageLayers
from ..nn import ParallelCrossEntropy, RMSNorm
from ..nn import functional as F
from ..nn.functional import apply_rope, rope_tables
from .causal_lm import CausalLMBase, pp_setup, tp_setup
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
    use_recompute: bool = False
    # the zigzag context-parallel token layout (not ported: True raises)
    cp_zigzag_stream: bool = False
    # accepted; the layers run as a plain loop either way
    scan_layers: bool = False
    # > 0: the training step's loss is the chunked LM-head cross entropy
    # over this many token chunks (CausalLMBase.compute_loss_hidden)
    fused_ce_chunks: int = 0
    dtype: str = "float32"
    # the port-only fields come after the reference's, so a positional
    # call binds as it does there
    # at pipeline degree > 1: the chunks a rank holds for the interleaved
    # schedule (PaddleNLP's field; the layout of `pipeline.stage_layer_ids`)
    virtual_pp_degree: int = 1
    # at tensor-parallel degree > 1: sequence parallelism in the training
    # forward (the serving forwards raise)
    sequence_parallel: bool = False

    @staticmethod
    def llama2_7b():
        return LlamaConfig(hidden_size=4096, intermediate_size=11008,
                           num_hidden_layers=32, num_attention_heads=32)

    @staticmethod
    def llama2_13b():
        return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                           num_hidden_layers=40, num_attention_heads=40,
                           num_key_value_heads=40)

    @staticmethod
    def gpt3_1p3b():
        return LlamaConfig(vocab_size=50304, hidden_size=2048,
                           intermediate_size=8192, num_hidden_layers=24,
                           num_attention_heads=16,
                           max_position_embeddings=2048)

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, seq=128):
        return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                           intermediate_size=hidden * 4,
                           num_hidden_layers=layers,
                           num_attention_heads=heads,
                           num_key_value_heads=heads,
                           max_position_embeddings=seq)


def _linears(sp):
    """The (column, row) tensor-parallel linear classes: the
    sequence-parallel pair with `sp`."""
    if sp:
        return _sp.ColumnSequenceParallelLinear, _sp.RowSequenceParallelLinear
    return ColumnParallelLinear, RowParallelLinear


class LlamaMLP(nn.Module):
    def __init__(self, config, dtype, device, sp=False):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        column, row = _linears(sp)
        col = dict(has_bias=False, gather_output=False, dtype=dtype,
                   device=device)
        self.gate_proj = column(h, i, **col)
        self.up_proj = column(h, i, **col)
        self.down_proj = row(i, h, has_bias=False, input_is_parallel=True,
                             dtype=dtype, device=device)

    def forward(self, x):
        return self.down_proj(TF.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaAttention(nn.Module):
    """`num_heads` / `num_kv_heads`: this rank's heads (all of them at
    tensor-parallel degree 1)."""

    def __init__(self, config, dtype, device, tp=1, sp=False):
        super().__init__()
        heads, kv_heads = config.num_attention_heads, \
            config.num_key_value_heads
        if heads % kv_heads:
            raise ValueError(
                f"num_attention_heads ({heads}) must be divisible "
                f"by num_key_value_heads ({kv_heads})")
        self.num_heads, self.num_kv_heads = heads // tp, kv_heads // tp
        self.head_dim = config.hidden_size // heads
        self.rope_theta = config.rope_theta
        hs = config.hidden_size
        kv = kv_heads * self.head_dim
        column, row = _linears(sp)
        col = dict(has_bias=False, gather_output=False, dtype=dtype,
                   device=device)
        self.q_proj = column(hs, heads * self.head_dim, **col)
        self.k_proj = column(hs, kv, **col)
        self.v_proj = column(hs, kv, **col)
        self.o_proj = row(heads * self.head_dim, hs, has_bias=False,
                          input_is_parallel=True, dtype=dtype, device=device)

    def _qkv(self, hidden_states):
        """q, k, v [b, s, heads, d]; s is the projections' (the whole
        sequence, where sequence parallelism gathers a shard's)."""
        q, k, v = (self.q_proj(hidden_states), self.k_proj(hidden_states),
                   self.v_proj(hidden_states))
        b, s = q.shape[:2]
        return (q.reshape(b, s, self.num_heads, self.head_dim),
                k.reshape(b, s, self.num_kv_heads, self.head_dim),
                v.reshape(b, s, self.num_kv_heads, self.head_dim))

    def _rotate(self, q, k, offset):
        cos, sin = rope_tables(q.shape[1], self.head_dim,
                               base=self.rope_theta, dtype=q.dtype,
                               position_offset=offset, device=q.device)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin)

    def forward(self, hidden_states, attn_mask=None):
        """Causal self-attention over [b, s, hidden] from position 0 (the
        training path): GQA repeats K/V to the query heads first. A padding
        `attn_mask` ([b, 1, 1, s], bool or additive) is folded into the
        causal mask as the reference folds it: a bool mask by AND, an
        additive one plus the dtype's lowest value above the diagonal."""
        q, k, v = self._qkv(hidden_states)
        b, s = q.shape[:2]
        q, k = self._rotate(q, k, 0)
        rep = self.num_heads // self.num_kv_heads
        if rep != 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if attn_mask is not None:
            causal = torch.ones(s, s, dtype=torch.bool,
                                device=q.device).tril()[None, None]
            if attn_mask.dtype == torch.bool:
                mask = attn_mask.broadcast_to(
                    tuple(attn_mask.shape[:2]) + (s, s)) & causal
            else:
                low = torch.finfo(attn_mask.dtype).min
                mask = attn_mask + torch.where(
                    causal, 0.0, low).to(attn_mask.dtype)
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=False,
                training=self.training)
        else:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 training=self.training)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))

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
                      context_lens, active=None, scratch_page=None,
                      limit_lens=None, rows=None):
        """Decode (s == 1) or a window of s tokens (s > 1) over the paged
        cache (models.paged_step): (k_pages, v_pages), or with int8 pages
        (k_pages, v_pages, k_scales, v_scales). hidden_states: [b, s,
        hidden]. Returns (out, paged_cache)."""
        q, k, v = self._qkv(hidden_states)
        out, cache = paged_attention_step(
            q, k, v, paged_cache, block_tables, context_lens, active=active,
            rotate=self._rotate, scratch_page=scratch_page,
            limit_lens=limit_lens, rows=rows)
        return self.o_proj(out), cache


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, dtype, device, tp=1, sp=False):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, dtype,
                                       device)
        self.self_attn = LlamaAttention(config, dtype, device, tp, sp)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                dtype, device)
        self.mlp = LlamaMLP(config, dtype, device, sp)
        if sp:  # each rank's norms see a sequence shard
            for norm in (self.input_layernorm, self.post_attention_layernorm):
                _sp.mark_as_sequence_parallel_parameter(norm.weight)
        self.use_recompute = config.use_recompute

    def _finish(self, residual, attn_out):
        h = residual + attn_out
        return h + self.mlp(self.post_attention_layernorm(h))

    def _inner(self, hidden_states, attn_mask=None):
        return self._finish(hidden_states, self.self_attn(
            self.input_layernorm(hidden_states), attn_mask))

    def forward(self, hidden_states, attn_mask=None):
        if self.use_recompute and self.training:
            return recompute(self._inner, hidden_states, attn_mask)
        return self._inner(hidden_states, attn_mask)

    def forward_cached(self, hidden_states, kv_cache, cur_len):
        h, cache = self.self_attn.forward_cached(
            self.input_layernorm(hidden_states), kv_cache, cur_len)
        return self._finish(hidden_states, h), cache

    def forward_paged(self, hidden_states, paged_cache, block_tables,
                      context_lens, active=None, scratch_page=None,
                      limit_lens=None, rows=None):
        h, cache = self.self_attn.forward_paged(
            self.input_layernorm(hidden_states), paged_cache, block_tables,
            context_lens, active=active, scratch_page=scratch_page,
            limit_lens=limit_lens, rows=rows)
        return self._finish(hidden_states, h), cache


class LlamaModel(nn.Module):
    """`sp`: sequence parallelism (`config.sequence_parallel` at tp >
    1). `layout` (a `distributed.pipeline.Layout`): at pp > 1 only the
    stage's layers (`StageLayers`, by global index), the embedding on the
    first stage (and on the last where `embed` asks for it: a tied head),
    the final norm on the last."""

    def __init__(self, config, dtype, device, tp=1, layout=None,
                 embed=False):
        super().__init__()
        self.config = config
        self.tp = tp
        self.sp = bool(config.sequence_parallel) and tp > 1
        split = layout is not None and layout.split
        self.split = split
        if not split or layout.first or embed:
            self.embed_tokens = VocabParallelEmbedding(
                config.vocab_size, config.hidden_size, dtype=dtype,
                device=device)
        else:
            self.embed_tokens = None
        if split:
            self.layers = StageLayers(
                {i: LlamaDecoderLayer(config, dtype, device, tp, self.sp)
                 for i in layout.layer_ids})
        else:
            self.layers = nn.ModuleList(
                [LlamaDecoderLayer(config, dtype, device, tp, self.sp)
                 for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype,
                            device) if not split or layout.last else None
        if self.sp and self.norm is not None:
            _sp.mark_as_sequence_parallel_parameter(self.norm.weight)
        self._layout = layout

    def scatter(self, h):
        """The embedding's output cut to this rank's sequence shard under
        sequence parallelism (as it is otherwise)."""
        if not self.sp:
            return h
        if h.shape[1] % self.tp:
            raise ValueError(
                f"sequence parallelism: the sequence length "
                f"{h.shape[1]} is not divisible by the tensor-parallel "
                f"degree {self.tp}")
        return _sp.ScatterOp.apply(h, axis=1)

    def _whole(self, what):
        if self.split:
            self._layout.refuse(what)

    def forward(self, input_ids, attn_mask=None):
        self._whole("LlamaModel.forward")
        h = self.scatter(self.embed_tokens(input_ids))
        for layer in self.layers:
            h = layer(h, attn_mask)
        h = self.norm(h)
        return _sp.GatherOp.apply(h, axis=1) if self.sp else h

    def _serving(self):
        self._whole("serving")
        if self.sp:
            raise NotImplementedError(
                "a sequence-parallel LLaMA runs the training forward only; "
                "build it without config.sequence_parallel to decode")

    def forward_cached(self, input_ids, caches, cur_len):
        """caches: per-layer (k_cache, v_cache). Returns (hidden,
        caches)."""
        self._serving()
        h = self.embed_tokens(input_ids)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            h, nc = layer.forward_cached(h, cache, cur_len)
            new_caches.append(nc)
        return self.norm(h), new_caches

    def forward_paged(self, input_ids, paged_caches, block_tables,
                      context_lens, active=None, scratch_page=None,
                      limit_lens=None, max_layers=None, window_rows=False):
        """max_layers: only the first N decoder layers run, over N cache
        entries (the shallow-exit draft of speculative decoding); the final
        norm still applies, so the head sees a normed early exit.
        window_rows: a window attends as decode rows (`_pa.window_rows`,
        built here once for every layer)."""
        self._serving()
        h = self.embed_tokens(input_ids)
        rows = _pa.window_rows(block_tables, context_lens,
                               input_ids.shape[1], limit_lens, active) \
            if window_rows and input_ids.shape[1] > 1 else None
        layers = self.layers if max_layers is None \
            else self.layers[:max_layers]
        new_caches = []
        for layer, cache in zip(layers, paged_caches):
            h, nc = layer.forward_paged(h, cache, block_tables,
                                        context_lens, active=active,
                                        scratch_page=scratch_page,
                                        limit_lens=limit_lens, rows=rows)
            new_caches.append(nc)
        return self.norm(h), new_caches


class LlamaForCausalLM(CausalLMBase):
    """LLaMA with its vocab head, on `device` (default: the current CUDA
    device) in `config.dtype`. Weights start random from `seed`
    (`init_weights`); `paddle_tpu_torch.weights.load_llama_state` replaces
    them with the JAX model's."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        if config.cp_zigzag_stream:
            raise NotImplementedError(
                "cp_zigzag_stream=True: context parallelism is not ported")
        self.config = config
        tp_setup(self, {"num_attention_heads": config.num_attention_heads,
                        "num_key_value_heads": config.num_key_value_heads})
        pp_setup(self, config.num_hidden_layers)
        dev = resolve_device(device)
        dtype = torch_dtype(config.dtype)
        tie = config.tie_word_embeddings
        self.llama = LlamaModel(config, dtype, dev, self.tp_degree, self.pp,
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
        """Linear and embedding weights ~ N(0, std^2), norm weights 1, drawn
        on the model's own device from a generator seeded with `seed`. A
        sharded weight is this rank's slice of the full tensor
        (`_normal_full_`), so the model equals the tp = 1 model of the same
        seed; at pp > 1 each rank holds its stage's slice of the pp = 1
        model of the seed (`_seeded_init`)."""
        from ..weights import llama_param_shapes

        def rule(name):
            return "one" if name.endswith("layernorm.weight") or \
                name == "llama.norm.weight" else "normal"

        self._seeded_init(seed, std, rule, llama_param_shapes(self.config))

    def forward(self, input_ids, attn_mask=None):
        """[b, s] token ids (and a padding mask [b, 1, 1, s], bool or
        additive) -> [b, s, vocab] logits."""
        return self._head(self.llama(input_ids, attn_mask))

    # the pipeline decomposition (the reference's, `models/llama.py:
    # 491-499`): the embedding, the decoder layers, the final norm and head
    def pp_embed(self, input_ids):
        """The first stage's input: the embedding (this rank's sequence
        shard under sequence parallelism)."""
        return self.llama.scatter(self.llama.embed_tokens(input_ids))

    def pp_layers(self):
        """The decoder layers this rank holds, in order (all of them at
        pp 1)."""
        return list(self.llama.layers)

    def pp_head(self, hidden):
        """The last stage's logits: the final norm (the whole sequence
        gathered under sequence parallelism) and the head."""
        h = self.llama.norm(hidden)
        if self.llama.sp:
            h = _sp.GatherOp.apply(h, axis=1)
        return self._head(h)

    def forward_cached(self, input_ids, caches, cur_len):
        h, new_caches = self.llama.forward_cached(input_ids, caches, cur_len)
        return self._head(h), new_caches

    def forward_paged(self, input_ids, paged_caches, block_tables,
                      context_lens, active=None, scratch_page=None,
                      limit_lens=None, max_layers=None, window_rows=False):
        """Decode of [b, 1] ids, or a window of [b, s] ids at positions
        context_lens..context_lens+s-1, over the paged caches (per layer
        `paged_step.paged_attention_step`'s cache tuple) -> ([b, s, vocab]
        logits, caches). `active` [b] bool, `scratch_page`, `limit_lens`
        [b] (window positions at or past it write nothing) and
        `window_rows` (a window's attention as b * s decode rows clamped to
        `limit_lens`, the speculative verify's route) as there: at s == 1,
        or with `window_rows`, with `active` and `scratch_page` on the
        pools' device the step reads nothing back to the host. max_layers:
        only the first N decoder layers run (`LlamaModel.forward_paged`)."""
        h, new_caches = self.llama.forward_paged(
            input_ids, paged_caches, block_tables, context_lens,
            active=active, scratch_page=scratch_page, limit_lens=limit_lens,
            max_layers=max_layers, window_rows=window_rows)
        return self._head(h), new_caches

    def _backbone_embed_weight(self):
        return self.llama.embed_tokens.weight
