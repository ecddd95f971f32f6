"""Common functionals (counterpart of
`paddle_tpu/nn/functional/common.py`): linear, dropout, embedding. `name`
is accepted and unused, as in the reference."""
from __future__ import annotations

import torch

from ...framework import amp_state as _amp
from ...framework import random as _random
from ...kernels import autotune as _at
from ...kernels import matmul as _kmm


def _matmul(a, w):
    """The linear's matmul with measured dispatch (the reference's
    `_matmul`): with `FLAGS_autotune` off (the default), `torch.matmul`, as
    the JAX package leaves it to XLA. On or readonly, for a 2-D weight of
    a's float dtype and a shape the kernel takes, the tuner's `matmul`
    winner for the shape's bucket: a CUDA kernel variant
    (`kernels.matmul.variants`), or `torch.matmul`. CPU tensors consult the tuner only under a custom
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


def linear(x, weight, bias=None, name=None):
    """Paddle weight layout: weight is [in_features, out_features]; bias
    [out_features] or None. On the auto-cast white list ("linear")."""
    x, weight, bias = _amp.cast_inputs("linear", x, weight, bias)
    out = _matmul(x, weight)
    return out if bias is None else out + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Paddle's dropout. In training, each element (or, with `axis`, each
    index along those axes, shared across the others) is kept with
    probability 1 - p; "upscale_in_train" scales the kept ones by
    1 / (1 - p), "downscale_in_infer" keeps them as they are and scales by
    1 - p out of training instead. The mask is drawn from a generator made
    from the global stream (`paddle_tpu_torch.seed`)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [n if i in axes else 1 for i, n in enumerate(shape)]
    keep = torch.empty(shape, device=x.device).bernoulli_(
        1.0 - p, generator=_random.generator(x.device)).bool()
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    return torch.where(keep, x, torch.zeros_like(x))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Row gather: weight [vocab, hidden], ids x [...] -> [..., hidden]. The
    rows of ids equal to `padding_idx` read 0. `sparse` (a sparse
    gradient) takes only its dense default False."""
    if sparse:
        raise NotImplementedError("embedding(sparse=True): sparse "
                                  "gradients are not ported")
    out = weight[x]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device), out)
    return out
