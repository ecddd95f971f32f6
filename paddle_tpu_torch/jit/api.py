"""`train_step` (counterpart of `paddle_tpu/jit/api.py::train_step`), on one
card and eager: the reference compiles forward, loss, gradients and the
update into one XLA program; here they run as PyTorch operations and the
port's kernels, in the same order and with the same arithmetic.

The step matches the reference's compiled step, which differs from its
eager `Optimizer.step()`:
- the update is `optimizer.apply_gradients` (the reference's
  `apply_gradients_functional`): no `grad_clip`, no `optimize_attr`
  learning-rate scale;
- AdamW's `apply_decay_param_fun` receives each parameter's structured
  name (`llama.layers.0.input_layernorm.weight`), where the eager step
  passes the parameter's `name` ('' for a layer's parameters);
- the learning rate is an f32 scalar (the reference passes a
  `jnp.float32`), read from the optimizer at each call;
- every parameter is updated, one that took no gradient with a zero
  gradient (the reference differentiates every parameter);
- gradient merge (`gradient_merge_steps` k > 1): each call adds its
  gradients to f32 accumulators; the k-th call casts accum * (1 / k) (or
  accum, without `gradient_merge_avg`) to each parameter's dtype, applies
  it and zeroes the accumulators. `optimizer._step_count` counts every
  call; the optimizer's state (Adam's beta powers) advances only when a
  merged gradient is applied.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def train_step(model, criterion: Callable, optimizer, donate=True,
               model_call: Optional[Callable] = None, sharding_stage=0,
               mesh=None, gradient_merge_steps: int = 1,
               gradient_merge_avg: bool = True):
    """step(inputs, *labels) -> loss (a detached tensor): loss =
    criterion(model_call(model, inputs), *labels) (`model_call` defaults
    to model(inputs)), its gradients, one update; the gradients are
    cleared. `donate` is accepted (PyTorch updates in place anyway).
    `sharding_stage` (0 or 1: replicated) and `mesh` (None) take their
    single-card values; any other raises."""
    if mesh is not None or sharding_stage not in (None, 0, 1):
        raise NotImplementedError(
            "train_step: a mesh and ZeRO sharding stages 2-3 are not ported "
            f"(mesh={mesh!r}, sharding_stage={sharding_stage!r})")
    call = model_call or (lambda m, x: m(x))
    k_merge = max(int(gradient_merge_steps), 1)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    merge = {"accum": None, "count": 0}

    def grad_of(p):
        return p.grad if p.grad is not None else torch.zeros_like(p)

    @torch.no_grad()
    def apply(lr):
        if k_merge == 1:
            optimizer.apply_gradients(
                [(n, p, grad_of(p)) for n, p in named], lr)
            return
        if merge["accum"] is None:
            merge["accum"] = [torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device) for _, p in named]
        for a, (_, p) in zip(merge["accum"], named):
            if p.grad is not None:
                a.add_(p.grad.float())
                p.grad = None
        merge["count"] += 1
        if merge["count"] < k_merge:
            return
        scale = float(np.float32(1.0 / k_merge if gradient_merge_avg
                                 else 1.0))
        # one merged gradient at a time (a generator): no second copy of
        # every gradient is alive at once
        optimizer.apply_gradients(
            ((n, p, (a * scale).to(p.dtype))
             for a, (n, p) in zip(merge["accum"], named)), lr)
        for a in merge["accum"]:
            a.zero_()
        merge["count"] = 0

    def step(*args, **kwargs):
        lr = np.float32(optimizer.get_lr())
        out = call(model, args[0])
        loss = criterion(out, *args[1:], **kwargs)
        loss.backward()
        apply(lr)
        for _, p in named:
            p.grad = None
        optimizer._step_count += 1
        return loss.detach()

    step._merge = merge
    return step
