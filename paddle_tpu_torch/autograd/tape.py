"""Eager autograd (counterpart of `paddle_tpu/autograd/tape.py`) over
torch's autograd: Paddle's grad-mode guards, `backward` and `grad`.

Where the reference records a tape of `jax.vjp` closures, the port's
tensors carry torch's graph; these functions give it Paddle's meaning. A
non-scalar output given no gradient is seeded with ones (torch raises).
`grad` returns the gradients and stores none: Paddle's meaning, where the
reference's walk also accumulates into every other leaf's `.grad` (ROADMAP,
facts about the reference). Its `no_grad_vars` stop the gradient at those
tensors (the reference takes the argument and ignores it).
"""
from __future__ import annotations

import functools

import torch


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


class no_grad:
    """paddle.no_grad: a context manager and a decorator that turn
    gradient recording off."""

    _mode = False

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with type(self)():
                return fn(*args, **kwargs)

        return wrapper


class enable_grad(no_grad):
    _mode = True


class set_grad_enabled:
    """Gradient recording on or off inside the `with` block."""

    def __init__(self, mode: bool):
        self.mode = bool(mode)

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self.mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False


def _as_list(xs):
    if xs is None:
        return None
    return [xs] if isinstance(xs, torch.Tensor) else list(xs)


def _seeds(tensors, grad_tensors):
    grads = _as_list(grad_tensors) or [None] * len(tensors)
    return [torch.ones_like(t) if g is None else g
            for t, g in zip(tensors, grads)]


def backward(tensors, grad_tensors=None, retain_graph=False,
             create_graph=False):
    """paddle.autograd.backward: accumulate the gradients of `tensors`
    into the `.grad` of the leaves that need them. A tensor given no
    gradient (None) is seeded with ones, whatever its shape."""
    tensors = _as_list(tensors)
    for t in tensors:
        if not t.requires_grad:
            raise RuntimeError(
                "backward() called on a tensor with stop_gradient=True and "
                "no recorded graph")
    torch.autograd.backward(tensors, _seeds(tensors, grad_tensors),
                            retain_graph=retain_graph or create_graph,
                            create_graph=create_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`,
    returned (a tensor for a tensor, a list for a list) and stored
    nowhere. A missing `grad_outputs` entry is ones; with `create_graph`
    the gradients can be differentiated again; `no_grad_vars` pass no
    gradient through; an input that `outputs` do not reach raises unless
    `allow_unused` (then None)."""
    single = isinstance(inputs, torch.Tensor)
    outs, ins = _as_list(outputs), _as_list(inputs)
    if retain_graph is None:
        retain_graph = create_graph
    handles = [v.register_hook(torch.zeros_like)
               for v in _as_list(no_grad_vars) or ()
               if v.requires_grad]
    try:
        gs = torch.autograd.grad(outs, ins, _seeds(outs, grad_outputs),
                                 retain_graph=retain_graph,
                                 create_graph=create_graph,
                                 allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    if not allow_unused and any(g is None for g in gs):
        raise RuntimeError(
            "One of the differentiated tensors appears to not have been "
            "used in the graph; set allow_unused=True to allow.")
    return gs[0] if single else list(gs)
