"""Loss functionals (counterpart of `paddle_tpu/nn/functional/loss.py`):
hard-label cross entropy."""
from __future__ import annotations

import torch


def cross_entropy(input, label, ignore_index=-100, reduction="mean",
                  axis=-1):
    """Softmax cross entropy with integer labels. `label` may carry a
    trailing size-1 class axis. log_softmax stays in the logits' dtype;
    rows whose label is `ignore_index` contribute 0, and "mean" divides by
    the number of the other rows (at least 1)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    lab = label.long()
    if lab.dim() == input.dim():
        lab = lab.squeeze(axis)
    logp = torch.log_softmax(input, dim=axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    nll = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    nll = torch.where(valid, nll, torch.zeros((), dtype=nll.dtype,
                                              device=nll.device))
    if reduction == "mean":
        return nll.sum() / valid.sum().to(nll.dtype).clamp_min(1.0)
    if reduction == "sum":
        return nll.sum()
    return nll
