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


def apply_rope(x, cos, sin):
    """Rotate-half (neox) rope. x: [batch, seq, heads, head_dim]; cos/sin:
    [seq, head_dim/2] or per-row [batch, seq, head_dim/2]."""
    if cos.dim() == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
