"""PyLayer: a user's autograd op (counterpart of
`paddle_tpu/autograd/py_layer.py`), a `torch.autograd.Function` underneath.

The user's static `forward(ctx, *args, **kwargs)` runs without recording a
graph; its outputs take `backward(ctx, *grads)` as their gradient, which
returns one gradient (or None) for each tensor argument, in order.
`ctx.save_for_backward` / `ctx.saved_tensor` hold tensors through
torch's saved-tensor machinery (so `saved_tensors_hooks` and in-place
checks apply to them); `ctx.mark_non_differentiable` marks outputs that
take no gradient.
"""
from __future__ import annotations

import torch


class _Saved(list):
    def __call__(self):
        return self


class PyLayerContext:
    def __init__(self):
        self._fn_ctx = None  # the torch Function's ctx, set by _Function
        self.non_differentiable = set()

    def save_for_backward(self, *tensors):
        self._fn_ctx.save_for_backward(*tensors)

    @property
    def saved_tensor(self):
        """The saved tensors: the reference's property, callable too as
        Paddle's method `saved_tensor()`."""
        return _Saved(self._fn_ctx.saved_tensors)

    def saved_tensors(self):
        return list(self._fn_ctx.saved_tensors)

    def mark_non_differentiable(self, *tensors):
        self.non_differentiable.update(id(t) for t in tensors)
        self._fn_ctx.mark_non_differentiable(*tensors)


class _Function(torch.autograd.Function):
    """One PyLayer call: forward(ctx, layer, kwargs, *args)."""

    @staticmethod
    def forward(fn_ctx, layer, kwargs, *args):
        ctx = PyLayerContext()
        ctx._fn_ctx = fn_ctx
        fn_ctx.layer, fn_ctx.pyctx = layer, ctx
        fn_ctx.tensor_args = [isinstance(a, torch.Tensor) for a in args]
        out = layer.forward(ctx, *args, **kwargs)
        fn_ctx.multi = isinstance(out, (tuple, list))
        return tuple(out) if fn_ctx.multi else out

    @staticmethod
    def backward(fn_ctx, *grads):
        with torch.no_grad():
            gres = fn_ctx.layer.backward(fn_ctx.pyctx, *grads)
        if not isinstance(gres, (tuple, list)):
            gres = (gres,)
        it = iter(gres)
        return (None, None, *(next(it, None) if is_t else None
                              for is_t in fn_ctx.tensor_args))


class PyLayerMeta(type):
    pass


class PyLayer(metaclass=PyLayerMeta):
    @staticmethod
    def forward(ctx, *args, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):  # pragma: no cover - abstract
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _Function.apply(cls, kwargs, *args)
