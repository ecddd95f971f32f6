"""The paged-attention decode step (counterpart of
`paddle_tpu/models/paged_step.py`, its single-token path).

Write the new token's K/V into the page pools, then run decode attention
over the pages. The speculative-verify window (s > 1), int8 pages and the
tensor-parallel shard_map of the JAX step are not ported.
"""
from __future__ import annotations

import torch

from ..kernels import paged_attention as _pa


def paged_attention_step(q, k, v, paged_cache, block_tables, context_lens,
                         active=None, rotate=None):
    """q: [b, 1, heads, d]; k/v: [b, 1, kv_heads, d]. paged_cache:
    (k_pages, v_pages), written in place. context_lens [b] int32 on the
    pools' device: tokens already cached. active: optional [b] bool, False
    rows write nothing and attend nothing (pass it on the host to keep the
    step free of device syncs). rotate(q, k, lens) applies the position
    encoding. Returns (out [b, 1, heads*d], paged_cache).

    Unlike the JAX step, an inactive row gets context 0 (a zero output,
    discarded by the caller) instead of reading its stale block-table row.
    """
    b, s, n_heads, head_dim = q.shape
    if s != 1:
        raise NotImplementedError(
            "only the single-token decode step (s == 1) is ported")
    k_pages, v_pages = paged_cache
    if rotate is not None:
        q, k = rotate(q, k, context_lens)
    _pa.update_paged_kv_cache(k_pages, v_pages, k[:, 0], v[:, 0],
                              block_tables, context_lens, active=active)
    ctx = context_lens + 1
    if active is not None:
        ctx = ctx * active.to(ctx.device, non_blocking=True)
    out = _pa.paged_attention(q[:, 0].contiguous(), k_pages, v_pages,
                              block_tables, ctx.to(torch.int32))
    return out.reshape(b, 1, n_heads * head_dim), paged_cache
