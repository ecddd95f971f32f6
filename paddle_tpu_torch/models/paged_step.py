"""The paged-attention step of serving (counterpart of
`paddle_tpu/models/paged_step.py`).

Two shapes of step share the entry:
- s == 1, the decode step: write the new token's K/V into the page pools
  (float, or int8 with scales), then run decode attention over the pages
  through `paged_attention_dispatch` (per-page or grouped-fetch kernel, as
  the flags and the tuner say);
- s > 1, the window step (a chunked prefill's chunk, the speculative
  verify): all s tokens' K/V land at positions lens..lens+s-1 (positions
  at or past `limit_lens` write nothing into a sequence's pages: the window
  may overhang what a row holds), then every window position attends its
  own causal prefix: gathered in f32 (`paged_attention_window`, a chunk
  round), or given `rows` as b * s decode rows through the decode kernel,
  each clamped to `limit_lens` (`paged_attention_window_rows`, the
  speculative verify, which captures in a CUDA graph).

Tensor parallelism: the JAX step runs in a `shard_map` over "tp", the
pools and scale pools sharded on the KV-head axis. Here each rank already
holds its heads (the model's column shards give q, k and v of heads / tp
and kv_heads / tp heads, the engine's pools kv_heads / tp), so the step
reads the rank's head counts from the tensors and shards nothing.
"""
from __future__ import annotations

import torch

from ..kernels import paged_attention as _pa


def paged_attention_step(q, k, v, paged_cache, block_tables, context_lens,
                         active=None, rotate=None, scratch_page=None,
                         limit_lens=None, rows=None):
    """q: [b, s, heads, d]; k/v: [b, s, kv_heads, d]. paged_cache:
    (k_pages, v_pages), or (k_pages, v_pages, k_scales, v_scales) for int8
    pages, written in place. context_lens [b] int32: tokens already cached
    (on the pools' device, or for s > 1 also on the host, where the window
    attention reads it for free). active: optional [b] bool, False rows
    write nothing into a sequence's pages and attend nothing. scratch_page:
    a page no sequence owns, where masked writes go instead (the serving
    engine's: a decode step then reads nothing back to the host and
    captures in a CUDA graph, whatever device `active` lives on; without it
    a device mask costs a `nonzero` sync). limit_lens: optional [b],
    positions at or past it write nothing (s == 1: the row's token, which
    still attends lens + 1 positions, as in the reference). rows: the
    decode rows of the window (`_pa.window_rows`, built once a forward):
    an s > 1 window then attends through `paged_attention_window_rows`
    (the speculative verify's route). rotate(q, k, lens) applies the
    position encoding. Returns (out [b, s, heads*d], paged_cache).

    Unlike the JAX step, an inactive row gets context 0 (a zero output,
    discarded by the caller) instead of reading its stale block-table row.
    """
    b, s, n_heads, head_dim = q.shape
    if rotate is not None:
        q, k = rotate(q, k, context_lens)
    quant = len(paged_cache) == 4
    if quant:
        k_pages, v_pages, k_scales, v_scales = paged_cache
    else:
        k_pages, v_pages = paged_cache
        k_scales = v_scales = None
    if s > 1:
        if quant:
            _pa.scatter_paged_kv_window_q8(
                k_pages, k_scales, v_pages, v_scales, k, v, block_tables,
                context_lens, limit_lens=limit_lens, active=active,
                scratch_page=scratch_page)
        else:
            _pa.scatter_paged_kv_window(
                k_pages, v_pages, k, v, block_tables, context_lens,
                limit_lens=limit_lens, active=active,
                scratch_page=scratch_page)
        if rows is not None:
            out = _pa.paged_attention_window_rows(
                q, k_pages, v_pages, rows, k_scales=k_scales,
                v_scales=v_scales)
        else:
            out = _pa.paged_attention_window(
                q, k_pages, v_pages, block_tables, context_lens,
                k_scales=k_scales, v_scales=v_scales, active=active)
        return out.reshape(b, s, n_heads * head_dim), paged_cache
    write = active
    if limit_lens is not None:
        # a row at or past its limit writes nothing (the reference's rule)
        under = context_lens < limit_lens.to(context_lens.device)
        write = under if active is None \
            else active.to(under.device) & under
    if quant:
        _pa.update_paged_kv_cache_q8(k_pages, k_scales, v_pages, v_scales,
                                     k[:, 0], v[:, 0], block_tables,
                                     context_lens, active=write,
                                     scratch_page=scratch_page)
    else:
        _pa.update_paged_kv_cache(k_pages, v_pages, k[:, 0], v[:, 0],
                                  block_tables, context_lens, active=write,
                                  scratch_page=scratch_page)
    ctx = context_lens + 1
    if active is not None:
        ctx = ctx * active.to(ctx.device, non_blocking=True)
    out = _pa.paged_attention_dispatch(q[:, 0].contiguous(), k_pages,
                                       v_pages, block_tables,
                                       ctx.to(torch.int32),
                                       k_scales=k_scales, v_scales=v_scales)
    return out.reshape(b, 1, n_heads * head_dim), paged_cache
