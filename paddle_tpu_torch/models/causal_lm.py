"""Shared causal-LM pieces (counterpart of `paddle_tpu/models/causal_lm.py`):
dense KV-cache allocation, the tied/untied vocab head, the dense loss and
the chunked LM-head cross entropy (`forward_hidden` +
`compute_loss_hidden`)."""
from __future__ import annotations

import torch
import torch.utils.checkpoint as _ckpt
from torch import nn

from ..framework import amp_state as _amp


class CausalLMBase(nn.Module):
    """Subclass contract: set `self.config`, `self.lm_head` (None for a
    tied head) and `self.loss_fn`, and implement `_backbone_embed_weight()`
    returning the [vocab, hidden] embedding weight."""

    def init_kv_caches(self, batch_size, max_length, dtype=torch.float32):
        """Dense per-layer (k, v) caches [b, max_length, kv_heads, head_dim],
        float32 by default as in the JAX package, on the model's device."""
        cfg = self.config
        shape = (batch_size, max_length, cfg.num_key_value_heads,
                 cfg.hidden_size // cfg.num_attention_heads)
        dev = self._backbone_embed_weight().device
        return [(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev))
                for _ in range(cfg.num_hidden_layers)]

    def _head(self, h):
        if self.lm_head is None:
            # tied head: the [vocab, hidden] embedding weight, transposed
            # (the reference's "matmul", on the auto-cast white list)
            h, w = _amp.cast_inputs("matmul", h,
                                    self._backbone_embed_weight())
            return torch.matmul(h, w.t())
        return self.lm_head(h)

    def compute_loss(self, logits, labels):
        """mean(loss_fn(logits, labels)), averaged over every token (rows
        with the ignore label count in the denominator, as in the
        reference)."""
        return self.loss_fn(logits, labels).mean()

    def forward_hidden(self, input_ids, attn_mask=None):
        """The backbone's output (after the final norm), without the vocab
        head: the input of `compute_loss_hidden`."""
        return self.llama(input_ids, attn_mask)

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
        divides."""
        cfg = self.config
        if chunks is None:
            chunks = int(getattr(cfg, "fused_ce_chunks", 0)) or 8
        tied = self.lm_head is None
        w = self._backbone_embed_weight() if tied else self.lm_head.weight
        ignore_index = getattr(self.loss_fn, "ignore_index", -100)
        n = hidden.shape[0] * hidden.shape[1]
        hf = hidden.reshape(n, hidden.shape[2])
        yf = labels.reshape(n).long()
        c = max(min(int(chunks), n), 1)
        while n % c:
            c -= 1
        step = n // c

        def body(hs, ys, w):
            logits = torch.matmul(hs, w.t() if tied else w).float()
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
