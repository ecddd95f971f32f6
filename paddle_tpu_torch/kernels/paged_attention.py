"""Paged KV cache ops and the paged decode-attention kernel.

Counterpart of `paddle_tpu/kernels/paged_attention.py`. K and V live in
fixed-size pages `[kv_heads, n_pages, page_size, head_dim]`; each sequence
owns a row of a block table listing its pages.

- `alloc_pages`, `update_paged_kv_cache` and `prefill_paged_kv_cache` are
  plain PyTorch, and so are their int8 counterparts `alloc_page_scales`,
  `update_paged_kv_cache_q8` and `prefill_paged_kv_cache_q8`, which store
  each token's K and V as int8 with one f32 scale per (kv head, page, slot)
  (symmetric absmax over head_dim). They write the pools IN PLACE (JAX returns new arrays;
  here the pools are the engine's own buffers) and return them. JAX drops
  masked writes by sending them to an out-of-range index (`mode="drop"`);
  on CUDA that index is a device assert, so these ops select the rows they
  write with an explicit mask instead. The mask is read where it lives: a
  host (CPU) mask costs the device no synchronisation. The one-token
  writers also take a `scratch_page` that no sequence owns (the serving
  engine keeps one past its pool's pages): a masked row then writes there,
  selected by `torch.where`, so a device mask costs no `nonzero` and the
  write captures in a CUDA graph (duplicate indices land only on the
  scratch page, and a stale table row is never read).
- The window step (s tokens a row: a chunked prefill's chunk, the
  speculative verify) is plain PyTorch, as it is XLA code in the
  reference: `scatter_paged_kv_window` / `_q8` write the window (positions
  at or past `limit_lens`, and inactive rows, write nothing into a
  sequence's pages: with a `scratch_page` they write there, else they are
  left out by index) and `paged_attention_window` attends each position's
  causal prefix over the live rows and the pages they hold, gathered in
  f32. `paged_attention_window_rows` is the same function as b * s decode
  rows (`window_rows`, each row's context clamped to its `limit_lens`)
  through the decode kernel (no gather, no host read: the speculative
  verify's route, captured in a CUDA graph).
- `paged_attention` is the decode attention: the CUDA kernel
  `csrc/paged_attention.cu` for CUDA tensors (float pages, or int8 pages
  with their scales), `paged_attention_ref` (the plain counterpart of
  `paged_attention_xla`) for CPU tensors. There is no crossover dispatch:
  on CUDA the kernel runs at every context length. It takes any query group
  (q_heads = group * kv_heads) and head_dim 32, 64, 128 or 256
  (`supports`); the reference takes any head_dim, and on CUDA another one
  raises. `launches` counts the float kernel's launches, `q8_launches` the
  int8 kernel's.
- `paged_attention_grouped` is the grouped-fetch variant (the JAX
  `paged_attention_grouped`): the same function over float 16-token pages
  at head_dim 128 with tables a multiple of 8 pages wide, any query group
  (`grouped_supports`), by the per-page CUDA kernel for CUDA tensors (the
  reference's 8-page stages, one 128 KB block an SM, measured slower on
  the H100 at 5 of the 6 shapes `chip_flash_ab.py --parts paged` times)
  and by `paged_attention_grouped_ref`, a plain walk over the
  reference's 8-page groups, for CPU tensors. `grouped_launches` counts
  its entry's launches.
- `paged_attention_dispatch` picks between them as the JAX dispatch does:
  the tuner's winner when `FLAGS_autotune` is on or readonly, else the
  grouped kernel when `FLAGS_paged_grouped_kernel` is set and the shape
  fits, else `paged_attention`. There is no XLA crossover at a mapped
  context of 2048 (a TPU measurement), and a tuner failure raises.

The kernel is bound by bytes (each K and V row of the context read once),
and what held its one-block-per-row predecessor back was parallelism: the
longest row's blocks set the time. So it cuts every row's context into
splits of whole pages (flash-decoding): a unit of work is (row, kv head,
chunk of `QUERY_CHUNK` queries, split), `split_plan` picks the split length
from the table's width, the page size, the heads, the group and the SM
count (never from `context_lens`, which the host does not read: no device
sync, and the launch captures in a CUDA graph), so that one full-length row
alone fills the card. A unit stages its pages in shared memory by bulk
copies and writes an f32 partial (m, l, acc) to a workspace allocated
here; the last unit of each (row, kv head, chunk) to take a ticket sums the
partials in split order in the same launch (deterministic), and a row whose
context fits one split writes its output directly. One launch a call.
`paged_attention_split_ref` is that computation in plain PyTorch (the
tests' check of the plan and the combine).

The scale pools are [kv_heads, n_pages, page_size] f32. The reference pads
the last dim to 128 (`alloc_page_scales`: a TPU lane-tiling rule), which at
page 16 would make the scales a quarter of the int8 payload; its
`[..., :page_size]` equals the port's pools.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30  # the TPU kernel's masked-score value

launches = 0
q8_launches = 0
grouped_launches = 0

_HEAD_DIMS = (32, 64, 128, 256)  # the per-page kernel's widths
GROUP_PAGES = 8      # pages per grouped-fetch step: 8 x 16 = 128 tokens
_GROUPED_PAGE = 16
_GROUPED_HEAD_DIM = 128
QUERY_CHUNK = 8      # queries a unit takes; a larger group runs in chunks
SPLIT_MIN_TOKENS = 128  # a split is at least this long (4 warp slices)
UNITS_PER_SM = 2     # units one full-length row is cut into, per SM
MAX_SPLITS = 256     # splits a row is cut into at most (the combine's room)
_MAX_GROUPS = 1 << 16  # (row, kv head, chunk) tickets of the kernel
_lib = None
_sms: dict = {}


# ---------------------------------------------------------------------------
# cache management
# ---------------------------------------------------------------------------


def alloc_pages(n_pages, page_size, num_kv_heads, head_dim,
                dtype=torch.float32, device=None):
    """Empty (zeroed) K and V page pools."""
    shape = (num_kv_heads, n_pages, page_size, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _nonzero_on(mask, device):
    """Indices of the True entries of `mask` (computed on the mask's own
    device), moved to `device`."""
    idx = torch.nonzero(mask, as_tuple=True)
    return tuple(i.to(device, non_blocking=True) for i in idx)


def _token_targets(block_tables, context_lens, n_rows, dev, page_size,
                   active, scratch_page):
    """(rows, page_ids, slots) of the one-token writes: row b writes at
    position context_lens[b] of its table. With `scratch_page` every row
    writes, and a False row of `active` writes slot 0 of that page instead
    (fixed shapes, no device sync, whatever its stale table row holds);
    without, the False rows are left out by index (`_nonzero_on`)."""
    lens = context_lens.to(dev, torch.long)
    if active is not None and scratch_page is not None:
        act = active.to(dev)
        pos = torch.where(act, lens, 0)
        page_ids = torch.where(
            act, block_tables.gather(1, (pos // page_size)[:, None])[:, 0]
            .long(), scratch_page)
        return slice(None), page_ids, pos % page_size
    if active is None:
        rows = torch.arange(n_rows, device=dev)
    else:
        (rows,) = _nonzero_on(active, dev)
    pos = lens[rows]
    return rows, block_tables[rows, pos // page_size].long(), pos % page_size


def update_paged_kv_cache(k_pages, v_pages, k_new, v_new, block_tables,
                          context_lens, active=None, scratch_page=None):
    """Write one new token per sequence into its page.

    k_new/v_new: [batch, kv_heads, head_dim]; context_lens[b] tokens are
    already cached, so the new token lands at that position. active:
    optional [batch] bool; False rows write nothing into any page a
    sequence owns (their block-table row may be stale). scratch_page: a
    page of the pools that no sequence owns; given, a False row writes
    there instead (the write is then graph-safe: no `nonzero`, no sync)."""
    rows, page_ids, slots = _token_targets(
        block_tables, context_lens, k_new.shape[0], k_pages.device,
        k_pages.shape[2], active, scratch_page)
    k_pages[:, page_ids, slots] = k_new[rows].to(k_pages.dtype).transpose(0, 1)
    v_pages[:, page_ids, slots] = v_new[rows].to(v_pages.dtype).transpose(0, 1)
    return k_pages, v_pages


def prefill_paged_kv_cache(k_pages, v_pages, k_seq, v_seq, block_tables,
                           seq_lens):
    """Write whole prompts into pages.

    k_seq/v_seq: [batch, s, kv_heads, head_dim]; positions j >= seq_lens[b]
    are padding and write nothing."""
    dev = k_pages.device
    page_size = k_pages.shape[2]
    s = k_seq.shape[1]
    valid = torch.arange(s, device=seq_lens.device)[None, :] < \
        seq_lens[:, None]
    rows, pos = _nonzero_on(valid, dev)
    page_ids = block_tables[rows, pos // page_size].long()
    slots = pos % page_size
    k_pages[:, page_ids, slots] = \
        k_seq[rows, pos].to(k_pages.dtype).transpose(0, 1)
    v_pages[:, page_ids, slots] = \
        v_seq[rows, pos].to(v_pages.dtype).transpose(0, 1)
    return k_pages, v_pages


def alloc_page_scales(n_pages, page_size, num_kv_heads, device=None):
    """Zeroed K and V scale pools for int8 pages, [kv_heads, n_pages,
    page_size] f32 each."""
    shape = (num_kv_heads, n_pages, page_size)
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


def _quant_kv_token(x):
    """Per-(row, head) symmetric int8 quantization of [..., head_dim]
    values: scale = max(absmax / 127, 1e-12) in f32, q = clip(round(x /
    scale), -127, 127). Returns (q int8 [..., head_dim], scale [...])."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def update_paged_kv_cache_q8(k_pages, k_scales, v_pages, v_scales, k_new,
                             v_new, block_tables, context_lens, active=None,
                             scratch_page=None):
    """int8 `update_paged_kv_cache`: quantize each row's new token per kv
    head and write values and scales; False rows of `active` write nothing
    into a sequence's pages (with `scratch_page`, they write there).
    Returns (k_pages, k_scales, v_pages, v_scales)."""
    rows, page_ids, slots = _token_targets(
        block_tables, context_lens, k_new.shape[0], k_pages.device,
        k_pages.shape[2], active, scratch_page)
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        q, s = _quant_kv_token(new[rows])  # [r, kvh, d], [r, kvh]
        pages[:, page_ids, slots] = q.transpose(0, 1)
        scales[:, page_ids, slots] = s.transpose(0, 1)
    return k_pages, k_scales, v_pages, v_scales


def prefill_paged_kv_cache_q8(k_pages, k_scales, v_pages, v_scales, k_seq,
                              v_seq, block_tables, seq_lens):
    """int8 `prefill_paged_kv_cache`: whole prompts [batch, s, kv_heads,
    head_dim], quantized per (token, kv head); positions j >= seq_lens[b]
    write nothing. Returns (k_pages, k_scales, v_pages, v_scales)."""
    dev = k_pages.device
    page_size = k_pages.shape[2]
    s = k_seq.shape[1]
    valid = torch.arange(s, device=seq_lens.device)[None, :] < \
        seq_lens[:, None]
    rows, pos = _nonzero_on(valid, dev)
    page_ids = block_tables[rows, pos // page_size].long()
    slots = pos % page_size
    for pages, scales, seq in ((k_pages, k_scales, k_seq),
                               (v_pages, v_scales, v_seq)):
        q, sc = _quant_kv_token(seq[rows, pos])  # [r, kvh, d], [r, kvh]
        pages[:, page_ids, slots] = q.transpose(0, 1)
        scales[:, page_ids, slots] = sc.transpose(0, 1)
    return k_pages, k_scales, v_pages, v_scales


# ---------------------------------------------------------------------------
# the window step: s tokens a row (chunked prefill, speculative verify)
# ---------------------------------------------------------------------------


def _window_targets(k_pages, block_tables, start_lens, s, limit_lens,
                    active, scratch_page):
    """(index, page_ids, slots) of a [b, s] token window's writes: row b's
    token w lands at position start_lens[b] + w. A position at or past
    limit_lens[b] (the window may overhang what the row holds), and every
    position of a False row of `active`, writes nothing into a page a
    sequence owns: with `scratch_page` it writes there (fixed shapes, no
    sync; graph-safe), without it is left out by index, picked where the
    masks live (a host mask costs no sync). `index` selects the written
    entries of the flattened [b * s] window. The one copy of that rule,
    shared by the float and int8 writers (the reference's
    `_window_write_coords`)."""
    dev = k_pages.device
    page_size = k_pages.shape[2]
    mdev = dev if scratch_page is not None else start_lens.device
    start = start_lens.to(mdev, torch.long)
    pos = start[:, None] + torch.arange(s, device=mdev)
    limit = start[:, None] + s if limit_lens is None \
        else limit_lens.to(mdev, torch.long)[:, None]
    valid = pos < limit
    if active is not None:
        valid = valid & active.to(mdev)[:, None]
    tables = block_tables.to(dev)
    if scratch_page is not None:
        col = (pos // page_size).clamp_(max=tables.shape[1] - 1)
        page_ids = torch.where(valid, tables.gather(1, col).long(),
                               scratch_page)
        return slice(None), page_ids.reshape(-1), (pos % page_size).reshape(-1)
    rows, cols = _nonzero_on(valid, dev)
    p = pos.to(dev)[rows, cols]
    return rows * s + cols, tables[rows, p // page_size].long(), \
        p % page_size


def scatter_paged_kv_window(k_pages, v_pages, k_seq, v_seq, block_tables,
                            start_lens, limit_lens=None, active=None,
                            scratch_page=None):
    """Write a window of s new tokens a row into its pages (counterpart of
    `scatter_paged_kv_window`; which positions write where:
    `_window_targets`). k_seq/v_seq: [b, s, kv_heads, head_dim]. Writes the
    pools in place and returns them."""
    b, s = k_seq.shape[:2]
    idx, page_ids, slots = _window_targets(
        k_pages, block_tables, start_lens, s, limit_lens, active,
        scratch_page)
    for pages, seq in ((k_pages, k_seq), (v_pages, v_seq)):
        pages[:, page_ids, slots] = seq.reshape(b * s, *seq.shape[2:])[idx] \
            .to(pages.dtype).transpose(0, 1)
    return k_pages, v_pages


def scatter_paged_kv_window_q8(k_pages, k_scales, v_pages, v_scales, k_seq,
                               v_seq, block_tables, start_lens,
                               limit_lens=None, active=None,
                               scratch_page=None):
    """int8 `scatter_paged_kv_window`: each (row, token, kv head) quantized
    symmetrically, values and scales written. Returns (k_pages, k_scales,
    v_pages, v_scales)."""
    b, s = k_seq.shape[:2]
    idx, page_ids, slots = _window_targets(
        k_pages, block_tables, start_lens, s, limit_lens, active,
        scratch_page)
    for pages, scales, seq in ((k_pages, k_scales, k_seq),
                               (v_pages, v_scales, v_seq)):
        q, sc = _quant_kv_token(seq.reshape(b * s, *seq.shape[2:])[idx])
        pages[:, page_ids, slots] = q.transpose(0, 1)
        scales[:, page_ids, slots] = sc.transpose(0, 1)
    return k_pages, k_scales, v_pages, v_scales


def paged_attention_window(q, k_pages, v_pages, block_tables, context_lens,
                           scale=None, k_scales=None, v_scales=None,
                           active=None):
    """Window attention over the paged cache (counterpart of
    `paged_attention_window_xla`): query w of row b attends positions <=
    context_lens[b] + w of its table, its own just-written token
    included, in f32 over float pages or int8 pages with f32 per-slot
    scales. q: [b, s, q_heads, head_dim] -> [b, s, q_heads, head_dim].

    Only the rows of `active` (every row without it) and the first
    ceil((max context + s) / page_size) pages of their tables are
    gathered: the positions past them are masked in the reference. A
    False row's output is 0 (the reference's reads its stale table).
    `context_lens` and `active` are read on the host: CPU tensors cost
    nothing, CUDA ones one sync. Its scratch: one f32 [rows, q_heads, s,
    positions] tensor (the scores, turned into weights in place) and the
    gathered K and V in f32.
    """
    b, s, n_q_heads, head_dim = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    group = n_q_heads // n_kv_heads
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    lens = context_lens.cpu().long()
    out = torch.zeros_like(q)
    rows = torch.arange(b) if active is None \
        else torch.nonzero(active.cpu(), as_tuple=True)[0]
    if rows.numel() == 0:
        return out
    n_pages = min(-(-(int(lens[rows].max()) + s) // page_size),
                  block_tables.shape[1])
    dev = q.device
    rows_d = rows.to(dev)
    tables = block_tables.to(dev)[rows_d, :n_pages].long()
    r, S = rows.numel(), n_pages * page_size
    kd = k_pages[:, tables].reshape(n_kv_heads, r, S, head_dim).float()
    vd = v_pages[:, tables].reshape(n_kv_heads, r, S, head_dim).float()
    if k_scales is not None:
        kd = kd * k_scales[:, tables].reshape(n_kv_heads, r, S)[..., None]
        vd = vd * v_scales[:, tables].reshape(n_kv_heads, r, S)[..., None]
    qf = q[rows_d].reshape(r, s, n_kv_heads, group, head_dim).float()
    sc = torch.einsum("bwhgd,hbsd->bhgws", qf, kd) * scale
    q_pos = lens[rows].to(dev)[:, None] + torch.arange(s, device=dev)
    mask = torch.arange(S, device=dev)[None, None, :] <= q_pos[:, :, None]
    sc.masked_fill_(~mask[:, None, None], NEG_INF)
    # softmax in place: one [rows, q_heads, s, positions] f32 tensor
    sc -= sc.amax(dim=-1, keepdim=True)
    sc.exp_()
    sc /= sc.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgws,hbsd->bwhgd", sc, vd)
    out[rows_d] = o.reshape(r, s, n_q_heads, head_dim).to(q.dtype)
    return out


def window_rows(block_tables, context_lens, s, limit_lens=None,
                active=None):
    """The decode rows of a window of s tokens a row: (tables [b * s,
    pages], ctx [b * s] int32), row b * s + w being window position w of
    row b over row b's table with context min(context_lens[b] + w + 1,
    limit_lens[b]), 0 for a False row of `active`. A forward builds them
    once for all its layers (`paged_attention_window_rows`)."""
    dev = block_tables.device
    ctx = context_lens.to(dev, torch.int32)[:, None] + \
        torch.arange(1, s + 1, device=dev, dtype=torch.int32)
    if limit_lens is not None:
        ctx = torch.minimum(ctx, limit_lens.to(dev, torch.int32)[:, None])
    if active is not None:
        ctx = ctx * active.to(dev)[:, None]
    return (block_tables.repeat_interleave(s, dim=0),
            ctx.reshape(-1).to(torch.int32))


def paged_attention_window_rows(q, k_pages, v_pages, rows, scale=None,
                                k_scales=None, v_scales=None):
    """Window attention as b * s single-token decodes (the speculative
    verify's route) over the decode rows of `window_rows`, through
    `paged_attention_dispatch` (the per-page or the grouped kernel on CUDA,
    the plain references on the CPU). Below `limit_lens` this is
    `paged_attention_window`'s function; the clamp keeps a position the
    caller never commits inside the pages its row holds. It reads nothing
    on the host and gathers nothing, so it captures in a CUDA graph. q:
    [b, s, q_heads, head_dim] -> the same shape."""
    b, s, n_q_heads, head_dim = q.shape
    tables, ctx = rows
    out = paged_attention_dispatch(
        q.reshape(b * s, n_q_heads, head_dim).contiguous(), k_pages,
        v_pages, tables, ctx, scale=scale, k_scales=k_scales,
        v_scales=v_scales)
    return out.reshape(b, s, n_q_heads, head_dim)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens,
                        scale=None, k_scales=None, v_scales=None):
    """Dense-gather decode attention, the plain counterpart of the JAX
    `paged_attention_xla`: gather every mapped page to [kv_h, b, S, d],
    mask positions >= context_lens[b], softmax in f32. A row with context 0
    returns zeros, as the TPU kernel and the CUDA kernel do.

    int8 pages come with their scales and are dequantized as the
    reference's decode kernel does it (`_decode_accumulate`): the K scales
    multiply the score columns after q . k_int8, the V scales the softmax
    weights before p . v_int8 (the normaliser sums the unscaled weights)."""
    b, n_q_heads, head_dim = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    group = n_q_heads // n_kv_heads
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    tables = block_tables.long()
    S = tables.shape[1] * page_size
    k_dense = k_pages[:, tables].reshape(n_kv_heads, b, S, head_dim).float()
    v_dense = v_pages[:, tables].reshape(n_kv_heads, b, S, head_dim).float()
    qf = q.reshape(b, n_kv_heads, group, head_dim).float()
    s = torch.einsum("bhgd,hbsd->bhgs", qf, k_dense) * scale
    if k_scales is not None:
        ks = k_scales[:, tables].reshape(n_kv_heads, b, S).transpose(0, 1)
        s = s * ks[:, :, None, :]
    lens = context_lens.to(q.device).long()
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scales is not None:
        vs = v_scales[:, tables].reshape(n_kv_heads, b, S).transpose(0, 1)
        p = p * vs[:, :, None, :]
    out = torch.einsum("bhgs,hbsd->bhgd", p, v_dense)
    out = torch.where((lens > 0)[:, None, None, None], out, 0.0)
    return out.reshape(b, n_q_heads, head_dim).to(q.dtype)


def query_bucket(group):
    """Queries a unit of the kernel holds: the smallest of 1, 2, 4, 8 that
    takes the group, else QUERY_CHUNK (the group then runs in chunks)."""
    return next(g for g in (1, 2, 4, QUERY_CHUNK) if group <= g or
                g == QUERY_CHUNK)


def split_plan(batch, kv_heads, group, head_dim, page_size, pages_per_seq,
               sms):
    """The kernel's split of every row's table into `n_splits` splits of
    `split_pages` whole pages, from shapes alone (the host never reads the
    context lengths). One full-length row must fill the card by itself (a
    lone long request, or the longest row of a mixed batch, sets the time):
    its kv_heads * chunks * n_splits units come to UNITS_PER_SM a SM, each
    split at least SPLIT_MIN_TOKENS long, at most MAX_SPLITS of them. The
    batch shapes only the grid. Returns dict(split_pages, n_splits,
    chunks, bucket, grid (x, y, z), workspace: the f32 partials' length, 0
    where one split takes a row)."""
    chunks = -(-group // QUERY_CHUNK)
    heads = kv_heads * chunks
    pps = max(pages_per_seq, 1)
    want = max(1, -(-UNITS_PER_SM * sms // heads))
    sp = min(pps, max(-(-SPLIT_MIN_TOKENS // page_size), pps // want,
                      -(-pps // MAX_SPLITS)))
    n_splits = -(-pps // sp)
    bucket = query_bucket(group)
    workspace = 0 if n_splits == 1 else \
        batch * heads * n_splits * bucket * (head_dim + 2)
    return dict(split_pages=sp, n_splits=n_splits, chunks=chunks,
                bucket=bucket, grid=(n_splits, heads, batch),
                workspace=workspace)


def split_bounds(ctx, page_size, split_pages):
    """The page bounds of a row's live units, as the kernel takes them: a
    row of context `ctx` has n_live = ceil(ctx / (split_pages *
    page_size)) live units (at least 1), over which its P live pages are
    spread evenly in whole pages: unit s takes pages [s * P // n_live,
    (s + 1) * P // n_live)."""
    span = split_pages * page_size
    n_live = max(1, -(-ctx // span))
    live = -(-ctx // page_size)
    return [(s * live // n_live, (s + 1) * live // n_live)
            for s in range(n_live)]


def paged_attention_split_ref(q, k_pages, v_pages, block_tables,
                              context_lens, scale=None, k_scales=None,
                              v_scales=None, split_pages=1):
    """The kernel's computation in plain PyTorch: every row's context cut
    into its live units (`split_bounds`: ceil(ctx / (split_pages *
    page_size)) units, the live pages spread evenly over them), each
    unit's f32 partial (its max m, its sum l of exp(s - m), its acc = sum
    of the weights times V, the int8 V scales on the weights and not in l)
    over its own tokens, then the partials combined in split order: out =
    sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M the largest m_s. A
    row with context 0 is zeros."""
    b, n_q_heads, head_dim = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    group = n_q_heads // n_kv_heads
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    pps = block_tables.shape[1]
    S = pps * page_size
    lens = context_lens.to(q.device).long().clamp(0, S)
    # a table entry whose page starts at or past the context is not read
    first = torch.arange(pps, device=q.device) * page_size
    tables = torch.where(first[None, :] < lens[:, None],
                         block_tables.long(), 0)
    k_dense = k_pages[:, tables].reshape(n_kv_heads, b, S, head_dim).float()
    v_dense = v_pages[:, tables].reshape(n_kv_heads, b, S, head_dim).float()
    qf = q.reshape(b, n_kv_heads, group, head_dim).float()
    s = torch.einsum("bhgd,hbsd->bhgs", qf, k_dense) * scale
    if k_scales is not None:
        ks = k_scales[:, tables].reshape(n_kv_heads, b, S).transpose(0, 1)
        s = s * ks[:, :, None, :]
    vw = torch.ones(b, n_kv_heads, S, device=q.device)
    if v_scales is not None:
        vw = v_scales[:, tables].reshape(n_kv_heads, b, S).transpose(0, 1)
    # the unit of every token below its row's context (-1 past it)
    unit = torch.full((b, S), -1, dtype=torch.long, device=q.device)
    n_max = 0
    for row, ctx in enumerate(lens.tolist()):
        bounds = split_bounds(ctx, page_size, split_pages)
        n_max = max(n_max, len(bounds))
        for u, (p0, p1) in enumerate(bounds):
            unit[row, p0 * page_size:min(ctx, p1 * page_size)] = u
    parts = []
    for u in range(n_max):
        sel = (unit == u)[:, None, None, :]  # [b, 1, 1, S]
        m = s.masked_fill(~sel, NEG_INF).amax(dim=-1)
        p = torch.where(sel, torch.exp(s - m[..., None]), 0.0)
        l = p.sum(dim=-1)
        acc = torch.einsum("bhgs,hbsd->bhgd", p * vw[:, :, None, :],
                           v_dense)
        keep = sel.reshape(b, S).any(dim=-1)
        parts.append((m, l, acc, keep[:, None, None]))
    big = torch.full((b, n_kv_heads, group), NEG_INF, device=q.device)
    for m, _, _, keep in parts:
        big = torch.where(keep, torch.maximum(big, m), big)
    num = torch.zeros(b, n_kv_heads, group, head_dim, device=q.device)
    den = torch.zeros(b, n_kv_heads, group, device=q.device)
    for m, l, acc, keep in parts:  # in split order
        w = torch.where(keep, torch.exp(m - big), 0.0)
        num = num + acc * w[..., None]
        den = den + l * w
    out = num / torch.where(den == 0, torch.ones_like(den), den)[..., None]
    out = torch.where((lens > 0)[:, None, None, None], out, 0.0)
    return out.reshape(b, n_q_heads, head_dim).to(q.dtype)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None, k_scales=None, v_scales=None):
    """Single-token decode attention over a paged KV cache.

    q: [batch, num_q_heads, head_dim]
    k_pages/v_pages: [num_kv_heads, n_pages, page_size, head_dim], q's
        dtype, or int8 with k_scales/v_scales [num_kv_heads, n_pages,
        page_size] f32 (`alloc_page_scales`)
    block_tables: [batch, pages_per_seq] int32
    context_lens: [batch] int32, tokens valid in the cache (the current
        token's K/V must already be written)
    -> [batch, num_q_heads, head_dim] in q's dtype
    """
    if (k_scales is None) != (v_scales is None):
        raise ValueError("paged_attention: give both k_scales and v_scales "
                         "(int8 pages) or neither")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, scale, k_scales, v_scales)
    return _paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                 context_lens, scale, k_scales, v_scales)


def supports(head_dim):
    """Whether the per-page decode kernel takes this head_dim (32, 64, 128
    or 256, any query group); the reference takes any."""
    return head_dim in _HEAD_DIMS


def grouped_supports(head_dim, page_size, pages_per_seq):
    """Whether the grouped-fetch decode takes this shape: head_dim 128,
    16-token pages, a table a multiple of 8 pages wide (any query
    group)."""
    return (head_dim == _GROUPED_HEAD_DIM and page_size == _GROUPED_PAGE
            and pages_per_seq > 0 and pages_per_seq % GROUP_PAGES == 0)


def paged_attention_grouped_ref(q, k_pages, v_pages, block_tables,
                                context_lens, scale=None):
    """The grouped decode in plain PyTorch, as the TPU kernel computes it:
    every row walks its pages 8 at a time (128 tokens), folding each group
    into an online softmax in f32 (`_decode_accumulate`), and stops at the
    last group that holds a token below its context. A row with context 0
    returns zeros."""
    b, n_q_heads, head_dim = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    group = n_q_heads // n_kv_heads
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    tables = block_tables.long()
    lens = context_lens.to(q.device).long().clamp(
        max=tables.shape[1] * page_size)
    gtok = GROUP_PAGES * page_size
    qf = q.reshape(b, n_kv_heads, group, head_dim).float()
    m = torch.full((b, n_kv_heads, group, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, n_kv_heads, group, head_dim, device=q.device)
    n_groups = -(-int(lens.max()) // gtok) if b else 0
    for gi in range(n_groups):
        pages = tables[:, gi * GROUP_PAGES:(gi + 1) * GROUP_PAGES]
        first = (gi * GROUP_PAGES + torch.arange(
            GROUP_PAGES, device=q.device)) * page_size
        # a page whose first token is at or past the context is not read
        pages = torch.where(first[None, :] < lens[:, None], pages, 0)
        k = k_pages[:, pages].reshape(n_kv_heads, b, gtok, head_dim)
        v = v_pages[:, pages].reshape(n_kv_heads, b, gtok, head_dim)
        s = torch.einsum("bhgd,hbsd->bhgs", qf, k.float()) * scale
        pos = gi * gtok + torch.arange(gtok, device=q.device)
        live = pos[None, :] < lens[:, None]  # [b, gtok]
        s = s.masked_fill(~live[:, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new) * live[:, None, None, :]
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgs,hbsd->bhgd", p, v.float())
        m = m_new  # unchanged for a row whose context ended earlier
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(b, n_q_heads, head_dim).to(q.dtype)


def paged_attention_grouped(q, k_pages, v_pages, block_tables, context_lens,
                            scale=None):
    """Grouped-fetch decode attention: `paged_attention`'s contract for
    float pages of q's dtype at head_dim 128 and page_size 16, with
    block_tables [batch, pages_per_seq] a multiple of 8 pages wide (raises
    ValueError otherwise, on every device). -> [batch, num_q_heads,
    head_dim] in q's dtype."""
    head_dim = q.shape[-1]
    page_size, pps = k_pages.shape[2], block_tables.shape[1]
    if not grouped_supports(head_dim, page_size, pps):
        raise ValueError(
            f"paged_attention_grouped takes head_dim {_GROUPED_HEAD_DIM}, "
            f"{_GROUPED_PAGE}-token pages and tables a multiple of "
            f"{GROUP_PAGES} pages wide; got head_dim {head_dim}, page "
            f"{page_size}, pages_per_seq {pps}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention_grouped takes float pages of q's "
                        f"dtype, got q {q.dtype}, pages {k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if q.device.type == "cpu":
        return paged_attention_grouped_ref(q, k_pages, v_pages, block_tables,
                                           context_lens, scale)
    return _paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                 context_lens, scale, grouped=True)


def paged_attention_dispatch(q, k_pages, v_pages, block_tables,
                             context_lens, scale=None, k_scales=None,
                             v_scales=None):
    """Decode-attention dispatch (the JAX `paged_attention_dispatch`, which
    `models/paged_step.py` calls): with `FLAGS_autotune` on or readonly,
    the tuner's winner for this decode bucket (per-page or grouped; CPU
    tensors consult the tuner only under a custom timer, as the reference
    does off the TPU); else the grouped kernel when
    `FLAGS_paged_grouped_kernel` is set and the pages are float and the
    shape fits (`grouped_supports`); else `paged_attention`."""
    from ..framework import config as _config
    from . import autotune as _at

    quant = k_scales is not None
    b, n_q_heads, head_dim = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    pps = block_tables.shape[1]
    if _at.enabled() and (q.is_cuda or _at.has_custom_timer()):
        win = _at.choose_paged_decode(b, n_q_heads, n_kv_heads, head_dim,
                                      page_size, pps, k_pages.dtype, quant)
        if win is not None:
            if win.meta["impl"] == "grouped":
                return paged_attention_grouped(q, k_pages, v_pages,
                                               block_tables, context_lens,
                                               scale)
            return paged_attention(q, k_pages, v_pages, block_tables,
                                   context_lens, scale, k_scales, v_scales)
    if not quant and _config.get_flag("FLAGS_paged_grouped_kernel", False) \
            and grouped_supports(head_dim, page_size, pps):
        return paged_attention_grouped(q, k_pages, v_pages, block_tables,
                                       context_lens, scale)
    return paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                           scale, k_scales, v_scales)


def _kernel(quant, grouped=False):
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        lib.paged_attention_decode.argtypes = [
            p, p, p, p, p, p, p, ll, i, i, i, i, i, i, i, i, i, f, i, p]
        lib.paged_attention_decode.restype = ctypes.c_int
        lib.paged_attention_decode_q8.argtypes = [
            p, p, p, p, p, p, p, p, p, ll, i, i, i, i, i, i, i, i, i, f, i,
            p]
        lib.paged_attention_decode_q8.restype = ctypes.c_int
        lib.paged_attention_decode_grouped.argtypes = [
            p, p, p, p, p, p, p, ll, i, i, i, i, i, i, i, i, i, f, i, p]
        lib.paged_attention_decode_grouped.restype = ctypes.c_int
        _lib = lib
    if grouped:
        return _lib.paged_attention_decode_grouped
    return _lib.paged_attention_decode_q8 if quant \
        else _lib.paged_attention_decode


def sm_count(dev):
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev) \
            .multi_processor_count
    return _sms[dev]


def _paged_attention_cuda(q, k_pages, v_pages, block_tables, context_lens,
                          scale, k_scales=None, v_scales=None, grouped=False):
    """The split-KV kernel over float or int8 pages, `grouped` through the
    grouped-fetch entry (float pages): one launch."""
    global launches, q8_launches, grouped_launches
    quant = k_scales is not None
    dev = q.device
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                   block_tables=block_tables, context_lens=context_lens)
    if quant:
        tensors.update(k_scales=k_scales, v_scales=v_scales)
    for name, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"paged_attention: {name} on {t.device}, q on "
                             f"{dev}; all must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    page_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pages.dtype != page_dtype or v_pages.dtype != page_dtype:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16 "
                        f"q with pages of q's dtype, or int8 pages with "
                        f"scales; got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and context_lens "
                        "must be int32")
    b, n_q_heads, head_dim = q.shape
    n_kv_heads, n_pages, page_size, hd = k_pages.shape
    if v_pages.shape != k_pages.shape or hd != head_dim:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)} do not agree")
    if quant and (k_scales.dtype != torch.float32 or
                  v_scales.dtype != torch.float32 or
                  k_scales.shape != k_pages.shape[:3] or
                  v_scales.shape != k_pages.shape[:3]):
        raise ValueError(f"paged_attention: scales {tuple(k_scales.shape)} "
                         f"{k_scales.dtype} / {tuple(v_scales.shape)} "
                         f"{v_scales.dtype}, expected f32 "
                         f"{tuple(k_pages.shape[:3])}")
    if not grouped and not supports(head_dim):
        raise ValueError(f"paged_attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {head_dim}; the reference "
                         f"takes any head_dim, a gap of the port (ROADMAP "
                         f"Queue 2 A)")
    if n_q_heads < n_kv_heads or n_q_heads % n_kv_heads:
        raise ValueError(f"paged_attention kernel takes q_heads = group * "
                         f"kv_heads, got {n_q_heads}/{n_kv_heads}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or \
            context_lens.shape != (b,):
        raise ValueError("paged_attention: block_tables [b, pages] and "
                         "context_lens [b] must match q's batch")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention kernel takes 16-byte aligned "
                         "q and pages")
    group = n_q_heads // n_kv_heads
    pps = block_tables.shape[1]
    plan = split_plan(b, n_kv_heads, group, head_dim, page_size, pps,
                      sm_count(dev))
    if b * plan["grid"][1] > _MAX_GROUPS or plan["grid"][1] > 65535 or \
            b > 65535:
        raise ValueError(f"paged_attention kernel takes at most "
                         f"{_MAX_GROUPS} (row, kv head, query chunk) "
                         f"groups and 65535 rows, got batch {b} x "
                         f"{plan['grid'][1]}")
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    out = torch.empty_like(q)
    ws = torch.empty(plan["workspace"], dtype=torch.float32, device=dev) \
        if plan["workspace"] else None
    fn = _kernel(quant, grouped)
    sizes = (b, n_kv_heads, group, n_pages, page_size, pps, head_dim,
             plan["split_pages"], plan["n_splits"], float(scale),
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(dev).cuda_stream)
    pools = (k_pages.data_ptr(), v_pages.data_ptr()) + (
        (k_scales.data_ptr(), v_scales.data_ptr()) if quant else ())
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), *pools, block_tables.data_ptr(),
                context_lens.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), plan["workspace"],
                *sizes)
    if rc:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    if grouped:
        grouped_launches += 1
    elif quant:
        q8_launches += 1
    else:
        launches += 1
    return out
