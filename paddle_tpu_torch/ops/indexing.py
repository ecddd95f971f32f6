"""Paddle's `x[idx]` and `x[idx] = value` as functions (counterpart of
`paddle_tpu/ops/indexing.py`). A tensor's own `[]` stays torch's, which
takes the same index expressions; `setitem_` writes in place as
`ops.inplace` does."""
from __future__ import annotations

import numpy as np
import torch

from ..tensor import apply_op, as_array


def _normalize_index(idx, device):
    """Lists in an index expression as tensors on `device`."""
    if isinstance(idx, tuple):
        return tuple(_normalize_index(i, device) for i in idx)
    if isinstance(idx, (list, np.ndarray)):
        return as_array(np.asarray(idx), device)
    return idx


def getitem(x, idx):
    a = as_array(x)
    nidx = _normalize_index(idx, a.device)
    return apply_op(lambda t: t[nidx], a, _name="getitem")


def setitem_(x, idx, value):
    from .inplace import _rebind

    nidx = _normalize_index(idx, x.device)

    def f(a, v):
        out = a.clone()
        out[nidx] = v.to(a.dtype)
        return out

    return _rebind(x, lambda x_: apply_op(f, x_, value, _name="setitem"),
                   _name="setitem_")
