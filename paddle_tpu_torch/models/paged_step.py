"""The paged-attention decode step (counterpart of
`paddle_tpu/models/paged_step.py`, its single-token path).

Write the new token's K/V into the page pools (float, or int8 with scales),
then run decode attention over the pages through
`paged_attention_dispatch` (per-page or grouped-fetch kernel, as the flags
and the tuner say). The speculative-verify window
(s > 1) and the tensor-parallel shard_map of the JAX step are not ported.
"""
from __future__ import annotations

import torch

from ..kernels import paged_attention as _pa


def paged_attention_step(q, k, v, paged_cache, block_tables, context_lens,
                         active=None, rotate=None, scratch_page=None):
    """q: [b, 1, heads, d]; k/v: [b, 1, kv_heads, d]. paged_cache:
    (k_pages, v_pages), or (k_pages, v_pages, k_scales, v_scales) for int8
    pages, written in place. context_lens [b] int32 on the pools' device:
    tokens already cached. active: optional [b] bool, False rows write
    nothing into a sequence's pages and attend nothing. scratch_page: a
    page no sequence owns, where False rows write instead (the serving
    engine's: the step then reads nothing back to the host and captures in
    a CUDA graph, whatever device `active` lives on; without it a device
    mask costs a `nonzero` sync). rotate(q, k, lens) applies the position
    encoding. Returns (out [b, 1, heads*d], paged_cache).

    Unlike the JAX step, an inactive row gets context 0 (a zero output,
    discarded by the caller) instead of reading its stale block-table row.
    """
    b, s, n_heads, head_dim = q.shape
    if s != 1:
        raise NotImplementedError(
            "only the single-token decode step (s == 1) is ported")
    if rotate is not None:
        q, k = rotate(q, k, context_lens)
    if len(paged_cache) == 4:
        k_pages, v_pages, k_scales, v_scales = paged_cache
        _pa.update_paged_kv_cache_q8(k_pages, k_scales, v_pages, v_scales,
                                     k[:, 0], v[:, 0], block_tables,
                                     context_lens, active=active,
                                     scratch_page=scratch_page)
    else:
        k_pages, v_pages = paged_cache
        k_scales = v_scales = None
        _pa.update_paged_kv_cache(k_pages, v_pages, k[:, 0], v[:, 0],
                                  block_tables, context_lens, active=active,
                                  scratch_page=scratch_page)
    ctx = context_lens + 1
    if active is not None:
        ctx = ctx * active.to(ctx.device, non_blocking=True)
    out = _pa.paged_attention_dispatch(q[:, 0].contiguous(), k_pages,
                                       v_pages, block_tables,
                                       ctx.to(torch.int32),
                                       k_scales=k_scales, v_scales=v_scales)
    return out.reshape(b, 1, n_heads * head_dim), paged_cache
