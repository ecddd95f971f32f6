"""Gradient clipping (counterpart of `paddle_tpu/nn/clip.py`):
`ClipGradByValue`, `ClipGradByNorm` and `ClipGradByGlobalNorm`, called on
a list of (parameter, gradient) pairs as the optimizers' `grad_clip`, and
`clip_grad_norm_` / `clip_grad_value_` over parameters' `.grad`.

`ClipGradByGlobalNorm` computes each gradient's sum of squares in f32 on
the device (its f32 norm, squared) and sums them in one reduction there:
the scale stays a device tensor, nothing is read back to the host.
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    """Each gradient element clipped to [min, max] (min defaults to
    -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _clip(self, params_grads):
        return [(p, g if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by min(clip_norm / max(||g||, 1e-12), 1), its
    own L2 norm in its dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is not None:
                n = g.square().sum().sqrt()
                scale = torch.clamp(self.clip_norm / n.clamp_min(1e-12),
                                    max=1.0)
                g = g * scale
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by clip_norm / max(global norm, clip_norm), the
    global norm the square root of the sum of the gradients' f32 sums of
    squares; each scaled in f32 and cast back to its dtype. `group_name`
    and `auto_skip_clip` are accepted and unused, as in the reference."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm(self, grads):
        """The global norm (an f32 device scalar) of `grads`, or None when
        there are none."""
        sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
              for g in grads if g is not None]
        if not sq:
            return None
        return torch.stack(sq).sum().sqrt()

    def _params_norm(self, params_grads):
        """The global norm of (parameter, gradient) pairs."""
        return self.global_norm([g for _, g in params_grads])

    def _clip(self, params_grads):
        gn = self._params_norm(params_grads)
        if gn is None:
            return params_grads
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return [(p, g if g is None else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the parameters' gradients by min(max_norm / max(total,
    1e-6), 1), total the norm_type-norm over all of them (inf: the largest
    magnitude); returns total."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    grads = [p.grad for p in params]
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = sum(g.abs().pow(norm_type).sum() for g in grads) \
            .pow(1.0 / norm_type)
    scale = torch.clamp(max_norm / total.clamp_min(1e-6), max=1.0)
    for p in params:
        p.grad = p.grad * scale
    return total


def clip_grad_value_(parameters, clip_value):
    """Clip every gradient element to [-clip_value, clip_value]."""
    for p in parameters:
        if p.grad is not None:
            p.grad = p.grad.clamp(-clip_value, clip_value)
