"""Shared causal-LM pieces (counterpart of `paddle_tpu/models/causal_lm.py`):
dense KV-cache allocation and the tied/untied vocab head."""
from __future__ import annotations

import torch
from torch import nn


class CausalLMBase(nn.Module):
    """Subclass contract: set `self.config` and `self.lm_head` (None for a
    tied head) and implement `_backbone_embed_weight()` returning the
    [vocab, hidden] embedding weight."""

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
            return torch.matmul(h, self._backbone_embed_weight().t())
        return self.lm_head(h)
