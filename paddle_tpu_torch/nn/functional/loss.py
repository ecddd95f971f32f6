"""Loss functionals (counterpart of `paddle_tpu/nn/functional/loss.py`):
softmax cross entropy with hard or soft labels."""
from __future__ import annotations

import torch

from ...framework import amp_state as _amp


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """The reference's cross entropy. log_softmax (or, without
    `use_softmax`, log(max(input, 1e-30))) stays in the input's dtype.

    Hard labels (`label` integer, may carry a trailing size-1 class axis):
    rows whose label is `ignore_index` contribute 0; `label_smoothing` e
    mixes (1 - e) * nll with e * the mean of -log p over the classes;
    `weight` [classes] scales each row by its class's weight, and "mean"
    then divides by the valid rows' summed weights (at least 1e-12), else
    by the number of valid rows (at least 1).

    Soft labels (`soft_label`, `label` a distribution over the classes,
    smoothed to (1 - e) * label + e / classes): -sum(label * log p), times
    sum(label * weight) with a weight; "mean" over all rows.

    On the auto-cast black list ("cross_entropy"). `name` is unused."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    input, label, weight = _amp.cast_inputs("cross_entropy", input, label,
                                            weight)
    logp = torch.log_softmax(input, dim=axis) if use_softmax \
        else torch.log(torch.clamp_min(input, 1e-30))
    if soft_label:
        lab = label
        if label_smoothing > 0:
            lab = (1 - label_smoothing) * lab \
                + label_smoothing / input.shape[axis]
        out = -(lab * logp).sum(dim=axis)
        if weight is not None:
            out = out * (lab * weight).sum(dim=axis)
        return _reduce(out, reduction)
    lab = label.long()
    if lab.dim() == input.dim():
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    nll = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        smooth = -logp.mean(dim=axis)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    zero = torch.zeros((), dtype=nll.dtype, device=nll.device)
    if weight is not None:
        cw = weight[safe]
        nll = torch.where(valid, nll * cw, zero)
        if reduction == "mean":
            return nll.sum() / torch.where(valid, cw, zero).sum() \
                .clamp_min(1e-12)
        return _reduce(nll, reduction)
    nll = torch.where(valid, nll, zero)
    if reduction == "mean":
        return nll.sum() / valid.sum().to(nll.dtype).clamp_min(1.0)
    return _reduce(nll, reduction)
