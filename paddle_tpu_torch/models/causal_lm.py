"""Shared causal-LM pieces (counterpart of `paddle_tpu/models/causal_lm.py`)
for the model families (LLaMA, GPT): dense KV-cache allocation,
`generate`, the tied/untied vocab head, the dense loss and the chunked
LM-head cross entropy (`forward_hidden` + `compute_loss_hidden`).

At tensor-parallel degree tp > 1 (`tp_setup`) the head's logits are this
rank's vocab shard: the loss is `ParallelCrossEntropy`'s (the chunked one
all_reduces each chunk's max and sums), the tied head reads the
vocab-parallel embedding's shard, the hidden states' gradient is
all_reduced over "tp" where the head consumes them (`_c_identity`), the
dense KV caches hold kv_heads / tp heads, and `generate` gathers the logits
(`_c_concat`) before it samples. Every rank then samples the same token:
the gathered logits are equal on every rank and each draws from a
generator seeded alike (`seed`, or the global stream, which the ranks
advance alike when seeded alike)."""
from __future__ import annotations

import torch
import torch.utils.checkpoint as _ckpt
from torch import nn

from .. import weights as _weights
from ..distributed import mesh as _mesh
from ..distributed.fleet.layers.mpu import mp_layers as _mp
from ..framework import amp_state as _amp


def tp_setup(model, heads):
    """Set `model.tp_degree`, `tp_rank` and `_tp_group` from the global
    mesh's "tp" axis. Raises where tp does not divide a head count of
    `heads` ({config field: count}; each rank holds whole heads, where the
    reference's GSPMD splits the columns wherever they fall), and on a
    mesh with "sp" or "sep" > 1 (context parallelism)."""
    for ax in ("sp", "sep"):
        if _mesh.axis_size(ax) > 1:
            raise NotImplementedError(
                f"a mesh with {ax} = {_mesh.axis_size(ax)}: context "
                "parallelism (context_parallel.py, ROADMAP Queue 1 item 4) "
                "is not ported")
    group, tp, rank = _mp.tp_group()
    for name, n in heads.items():
        if n % tp:
            raise ValueError(
                f"{name} = {n} is not divisible by the tensor-parallel "
                f"degree {tp}: each rank holds whole heads (heads that tp "
                "does not divide: ROADMAP Queue 1 item 4)")
    model.tp_degree, model.tp_rank, model._tp_group = tp, rank, group


def pp_setup(model, num_layers):
    """Set `model.pp`, the model's `distributed.pipeline.Layout`, from the
    global mesh's "pp" axis and the config's `virtual_pp_degree` (1 unless
    the config sets it; PaddleNLP's field). With a tied head at more than
    two stages, the group of the first and last stages is made here, on
    every rank alike."""
    from ..distributed import pipeline as _pipe

    cfg = model.config
    model.pp = _pipe.Layout(num_layers, getattr(cfg, "virtual_pp_degree", 1))
    if model.pp.split and cfg.tie_word_embeddings:
        from ..distributed.fleet.meta_parallel.pp_utils.p2p_communication \
            import link_for

        link_for().group_of((0, model.pp.num_stages - 1))


class CausalLMBase(nn.Module):
    """Subclass contract: set `self.config`, `self.lm_head` (None for a
    tied head) and `self.loss_fn`, implement `_backbone_embed_weight()`
    returning the [vocab, hidden] embedding weight, hold the backbone as
    `self.llama` or `self.gpt`, and expose `forward_cached(input_ids,
    caches, cur_len)`."""

    def _ref_param(self):
        """A parameter this rank holds (the model's dtype and device)."""
        return next(self.parameters())

    def _mark_tied(self):
        """At pp > 1 with a tied head, the embedding weight is held by the
        first stage (its owner) and the last (for the head); its gradient
        is summed over both (`pipeline.allreduce_shared_weight_gradients`)."""
        pp = self.pp
        if pp.split and self.config.tie_word_embeddings and \
                (pp.first or pp.last):
            from ..distributed import pipeline as _pipe

            _pipe.mark_shared(self._backbone_embed_weight(),
                              (0, pp.num_stages - 1), owner=pp.first)

    def _seeded_init(self, seed, std, rule, full_shapes):
        """Fill the parameters from a generator seeded with `seed`, on the
        model's device: `rule(name)` gives "one", "zero" or "normal"
        (N(0, std^2), `_normal_full_`). At pp > 1 the whole model's
        parameters are walked in their order (`full_shapes`), the draws of
        the layers other stages hold made and dropped, so each rank holds
        the slice of the pp = 1 model of the same seed."""
        ref = self._ref_param()
        gen = torch.Generator(device=ref.device)
        gen.manual_seed(int(seed))
        params = dict(self.named_parameters())
        for name in (full_shapes if self.pp.split else params):
            kind, p = rule(name), params.get(name)
            if kind == "one":
                if p is not None:
                    p.fill_(1.0)
            elif kind == "zero":
                if p is not None:
                    p.zero_()
            elif p is not None:
                self._normal_full_(name, p, std, gen)
            else:
                torch.empty(full_shapes[name], dtype=ref.dtype,
                            device=ref.device).normal_(0.0, std,
                                                       generator=gen)

    def _normal_full_(self, name, p, std, gen):
        """Fill parameter `name` with this rank's slice of a full-size
        N(0, std^2) draw from `gen`: the full tensor is drawn whatever the
        tensor-parallel degree (`weights.tp_split_axis`), so the ranks hold
        different shards and a model built at tp > 1 equals the tp = 1
        model of the same seed."""
        ax = _weights.tp_split_axis(name)
        if ax is None or self.tp_degree == 1:
            p.normal_(0.0, std, generator=gen)
            return
        full = list(p.shape)
        full[ax] *= self.tp_degree
        w = torch.empty(full, dtype=p.dtype, device=p.device)
        w.normal_(0.0, std, generator=gen)
        n = p.shape[ax]
        p.copy_(w.narrow(ax, self.tp_rank * n, n))

    def _kv_heads(self):
        """This rank's KV heads: the config's `num_key_value_heads` (or
        `num_attention_heads` for a config without it, GPT) over the
        tensor-parallel degree."""
        cfg = self.config
        return getattr(cfg, "num_key_value_heads", cfg.num_attention_heads) \
            // self.tp_degree

    def init_kv_caches(self, batch_size, max_length, dtype=None):
        """Dense per-layer (k, v) caches [b, max_length, kv_heads, head_dim],
        float32 unless `dtype` says otherwise, as in the JAX package, on the
        model's device."""
        cfg = self.config
        dtype = torch.float32 if dtype is None else dtype
        shape = (batch_size, max_length, self._kv_heads(),
                 cfg.hidden_size // cfg.num_attention_heads)
        self.pp.refuse("init_kv_caches")
        dev = self._ref_param().device
        return [(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev))
                for _ in range(cfg.num_hidden_layers)]

    def generate(self, input_ids, max_length=None, max_new_tokens=None,
                 decode_strategy="greedy_search", temperature=1.0,
                 top_k=0, top_p=1.0, eos_token_id=None, pad_token_id=0,
                 seed=None):
        """`models.generation.generate` on this model: (new tokens [b,
        n_new], scores [b])."""
        from .generation import generate as _generate

        self.pp.refuse("generate")
        return _generate(self, input_ids, max_length=max_length,
                         max_new_tokens=max_new_tokens,
                         decode_strategy=decode_strategy,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         eos_token_id=eos_token_id,
                         pad_token_id=pad_token_id, seed=seed)

    def _head(self, h):
        if self.lm_head is None:
            # tied head: the [vocab, hidden] embedding weight, transposed
            # (the reference's "matmul", on the auto-cast white list)
            if self.tp_degree > 1:
                h = _mp._c_identity(h, self._tp_group)
            h, w = _amp.cast_inputs("matmul", h,
                                    self._backbone_embed_weight())
            return torch.matmul(h, w.t())
        return self.lm_head(h)

    def gather_logits(self, logits):
        """The whole vocabulary's logits from this rank's shard (every
        rank's, gathered along the last axis; as they are at degree 1)."""
        return _mp._c_concat(logits, self._tp_group) \
            if self.tp_degree > 1 else logits

    def compute_loss(self, logits, labels):
        """mean(loss_fn(logits, labels)), averaged over every token (rows
        with the ignore label count in the denominator, as in the
        reference)."""
        return self.loss_fn(logits, labels).mean()

    def forward_hidden(self, input_ids, attn_mask=None):
        """The backbone's output (after the final norm), without the vocab
        head: the input of `compute_loss_hidden`."""
        return self._backbone()(input_ids, attn_mask)

    def _backbone(self):
        for name in ("llama", "gpt"):
            if hasattr(self, name):
                return getattr(self, name)
        raise NotImplementedError("subclass must expose its backbone")

    def compute_loss_hidden(self, hidden, labels, chunks=None):
        """The vocab head and the cross entropy in `chunks` slices of the
        tokens (default `config.fused_ce_chunks`, else 8; lowered to the
        largest divisor of the token count at most that): the [tokens,
        vocab] logits are never whole. Each slice's head matmul (f32
        logits; `torch.matmul` in the hidden states' dtype, as the JAX
        package leaves it to XLA), logsumexp and label pick run under
        `torch.utils.checkpoint`, so the backward recomputes one slice's
        logits at a time. Rows with the ignore label add 0, and the sum is
        divided by all tokens, ignored ones included, as `compute_loss`
        divides. At tensor-parallel degree > 1 each slice's loss is
        `parallel_cross_entropy`'s over this rank's vocab shard, with the
        group and rank of `loss_fn` (a `ParallelCrossEntropy`)."""
        cfg = self.config
        if chunks is None:
            chunks = int(getattr(cfg, "fused_ce_chunks", 0)) or 8
        tied = self.lm_head is None
        w = self._backbone_embed_weight() if tied else self.lm_head.weight
        ignore_index = getattr(self.loss_fn, "ignore_index", -100)
        n = hidden.shape[0] * hidden.shape[1]
        hf = hidden.reshape(n, hidden.shape[2])
        yf = labels.reshape(n).long()
        tp = self.tp_degree
        if tp > 1:
            hf = _mp._c_identity(hf, self._tp_group)
        c = max(min(int(chunks), n), 1)
        while n % c:
            c -= 1
        step = n // c

        def body(hs, ys, w):
            logits = torch.matmul(hs, w.t() if tied else w).float()
            if tp > 1:
                ce = self.loss_fn
                return _mp.parallel_cross_entropy(
                    logits, ys, ce._group, ce.rank, ignore_index).sum()
            logz = torch.logsumexp(logits, dim=-1)
            valid = ys != ignore_index
            picked = logits.gather(1, torch.where(valid, ys, 0)[:, None])
            nll = torch.where(valid, logz - picked[:, 0], 0.0)
            return nll.sum()

        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(c):
            total = total + _ckpt.checkpoint(
                body, hf[i * step:(i + 1) * step], yf[i * step:(i + 1) * step],
                w, use_reentrant=False)
        return total / n
