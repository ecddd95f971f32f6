"""Paged KV cache ops and the paged decode-attention kernel.

Counterpart of `paddle_tpu/kernels/paged_attention.py`. K and V live in
fixed-size pages `[kv_heads, n_pages, page_size, head_dim]`; each sequence
owns a row of a block table listing its pages.

- `alloc_pages`, `update_paged_kv_cache` and `prefill_paged_kv_cache` are
  plain PyTorch. They write the pools IN PLACE (JAX returns new arrays;
  here the pools are the engine's own buffers) and return them. JAX drops
  masked writes by sending them to an out-of-range index (`mode="drop"`);
  on CUDA that index is a device assert, so these ops select the rows they
  write with an explicit mask instead. The mask is read where it lives: a
  host (CPU) mask costs the device no synchronisation.
- `paged_attention` is the decode attention: the CUDA kernel
  `csrc/paged_attention.cu` for CUDA tensors, `paged_attention_ref` (the
  plain counterpart of `paged_attention_xla`) for CPU tensors. There is no
  crossover dispatch: on CUDA the kernel runs at every context length.
  `launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30  # the TPU kernel's masked-score value

launches = 0

_HEAD_DIMS = (32, 64, 128)
_MAX_GROUP = 16
_lib = None


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


def update_paged_kv_cache(k_pages, v_pages, k_new, v_new, block_tables,
                          context_lens, active=None):
    """Write one new token per sequence into its page.

    k_new/v_new: [batch, kv_heads, head_dim]; context_lens[b] tokens are
    already cached, so the new token lands at that position. active:
    optional [batch] bool; False rows write nothing (their block-table row
    may be stale)."""
    dev = k_pages.device
    page_size = k_pages.shape[2]
    lens = context_lens.to(dev, torch.long)
    if active is None:
        rows = torch.arange(k_new.shape[0], device=dev)
    else:
        (rows,) = _nonzero_on(active, dev)
    pos = lens[rows]
    page_ids = block_tables[rows, pos // page_size].long()
    slots = pos % page_size
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


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens,
                        scale=None):
    """Dense-gather decode attention, the plain counterpart of the JAX
    `paged_attention_xla`: gather every mapped page to [kv_h, b, S, d],
    mask positions >= context_lens[b], softmax in f32. A row with context 0
    returns zeros, as the TPU kernel and the CUDA kernel do."""
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
    lens = context_lens.to(q.device).long()
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,hbsd->bhgd", p, v_dense)
    out = torch.where((lens > 0)[:, None, None, None], out, 0.0)
    return out.reshape(b, n_q_heads, head_dim).to(q.dtype)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None):
    """Single-token decode attention over a paged KV cache.

    q: [batch, num_q_heads, head_dim]
    k_pages/v_pages: [num_kv_heads, n_pages, page_size, head_dim]
    block_tables: [batch, pages_per_seq] int32
    context_lens: [batch] int32, tokens valid in the cache (the current
        token's K/V must already be written)
    -> [batch, num_q_heads, head_dim] in q's dtype
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, scale)
    return _paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                 context_lens, scale)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_decode.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.paged_attention_decode.restype = ctypes.c_int
        _lib = lib
    return _lib.paged_attention_decode


def _paged_attention_cuda(q, k_pages, v_pages, block_tables, context_lens,
                          scale):
    global launches
    dev = q.device
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                   block_tables=block_tables, context_lens=context_lens)
    for name, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"paged_attention: {name} on {t.device}, q on "
                             f"{dev}; all must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16 "
                        f"q and pages of one dtype, got {q.dtype}/"
                        f"{k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and context_lens "
                        "must be int32")
    b, n_q_heads, head_dim = q.shape
    n_kv_heads, n_pages, page_size, hd = k_pages.shape
    if v_pages.shape != k_pages.shape or hd != head_dim:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)} do not agree")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {head_dim}")
    if n_q_heads % n_kv_heads or not 1 <= n_q_heads // n_kv_heads \
            <= _MAX_GROUP:
        raise ValueError(f"paged_attention kernel takes q_heads = group * "
                         f"kv_heads with group <= {_MAX_GROUP}, got "
                         f"{n_q_heads}/{n_kv_heads}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or \
            context_lens.shape != (b,):
        raise ValueError("paged_attention: block_tables [b, pages] and "
                         "context_lens [b] must match q's batch")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention kernel takes 16-byte aligned "
                         "q and pages")
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), context_lens.data_ptr(),
                out.data_ptr(), b, n_kv_heads, n_q_heads // n_kv_heads,
                n_pages, page_size, block_tables.shape[1], head_dim,
                float(scale), int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
