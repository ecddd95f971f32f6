"""Rotary position embedding (counterpart of
`paddle_tpu/nn/functional/rope.py`)."""
from __future__ import annotations

import torch


def rope_tables(seq_len, head_dim, base=10000.0, dtype=torch.float32,
                position_offset=0, device=None):
    """cos/sin tables, computed in f32 and cast to `dtype`.
    position_offset: an int (one offset for every row) -> [seq, head_dim/2]
    tables, or a [batch] tensor (per-row decode positions) -> [batch, seq,
    head_dim/2] tables."""
    if torch.is_tensor(position_offset):
        device = position_offset.device if device is None else device
    inv_freq = 1.0 / (base ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    if torch.is_tensor(position_offset) and position_offset.dim() == 1:
        off = position_offset.to(device=device, dtype=torch.float32)
        t = t[None, :] + off[:, None]  # [b, s]
        freqs = t[..., None] * inv_freq  # [b, s, d/2]
    else:
        off = float(position_offset)
        freqs = torch.outer(t + off, inv_freq)
    return freqs.cos().to(dtype), freqs.sin().to(dtype)


def apply_rope(x, cos, sin, neox=True):
    """x: [batch, seq, heads, head_dim]; cos/sin: [seq, head_dim/2] or
    per-row [batch, seq, head_dim/2]. neox=True rotates halves; False
    rotates interleaved (GPT-J style) pairs."""
    if cos.dim() == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    if neox:
        d2 = x.shape[-1] // 2
        x1, x2 = x[..., :d2], x[..., d2:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                       dim=-1).reshape(x.shape)


def fused_rotary_position_embedding(q, k, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True, name=None):
    """`paddle.incubate.nn.functional.fused_rotary_position_embedding`:
    q, k (and v, rotated too when given) [batch, seq, heads, head_dim].
    Without `sin` / `cos` the tables are `rope_tables(seq, head_dim)` in
    q's dtype; given ones are read as [seq, >= head_dim/2] (the first
    head_dim/2 columns). `position_ids` is unused, as in the reference.
    Returns (q, k, v or None)."""
    seq, hd = q.shape[1], q.shape[3]
    if cos is None or sin is None:
        cos_t, sin_t = rope_tables(seq, hd, dtype=q.dtype, device=q.device)
    else:
        cos_t = cos.reshape(seq, -1)[:, :hd // 2]
        sin_t = sin.reshape(seq, -1)[:, :hd // 2]
    neox = bool(use_neox_rotary_style)
    outs = [apply_rope(t, cos_t, sin_t, neox) for t in (q, k)]
    return outs[0], outs[1], \
        None if v is None else apply_rope(v, cos_t, sin_t, neox)
