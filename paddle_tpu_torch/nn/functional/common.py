"""Common functionals (counterpart of
`paddle_tpu/nn/functional/common.py`)."""
from __future__ import annotations

import torch

from ...kernels import autotune as _at
from ...kernels import matmul as _kmm


def _matmul(a, w):
    """The linear's matmul with measured dispatch (the reference's
    `_matmul`): with `FLAGS_autotune` off (the default), `torch.matmul`, as
    the JAX package leaves it to XLA. On or readonly, for a 2-D weight of
    a's float dtype and a shape the kernel takes, the tuner's `matmul`
    winner for the shape's bucket: the CUDA kernel at its row tile, or
    `torch.matmul`. CPU tensors consult the tuner only under a custom
    timer, as the reference does off the TPU. A kernel that fails raises."""
    if _at.enabled() and (a.is_cuda or _at.has_custom_timer()) \
            and w.dim() == 2 and a.dtype == w.dtype:
        k, n = w.shape
        m = a.numel() // k if k else 0
        if _kmm.supports(m, k, n, a.dtype):
            win = _at.choose_matmul(m, k, n, a.dtype)
            if win is not None and win.meta["impl"] == "cuda":
                return _kmm.matmul_fused(a, w, win.meta["tile"])
    return torch.matmul(a, w)


def linear(x, weight):
    """Paddle weight layout: weight is [in_features, out_features]."""
    return _matmul(x, weight)


def embedding(ids, weight):
    """Row gather: weight [vocab, hidden], ids [...] -> [..., hidden]."""
    return weight[ids]
