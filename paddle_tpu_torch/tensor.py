"""Tensors (counterpart of `paddle_tpu/tensor.py`): `to_tensor`,
`Parameter`, and `apply_op`, through which the core's functions run.

The port's tensor is `torch.Tensor` itself: no wrapper class, and nothing
patched onto torch's classes, so every ported slice keeps taking and
returning torch tensors. Paddle's conversion rules are the reference's
`Tensor.__init__`: a float64 numpy array or a Python float becomes the
default dtype (`set_default_dtype`), a Python int int64, an
`ml_dtypes.bfloat16` array bfloat16; `stop_gradient` is the inverse of
`requires_grad`. A tensor made with no place lands where
`framework.device.resolve_device(None)` says: the place `set_device`
chose, else the current CUDA device (no CUDA: it raises).

Where a Paddle method shares its name with a torch method of another
meaning (`x.sum(axis=...)`, `x.numpy()` on a tensor that needs grad,
`x.shape`, `x.reshape`, `x.split`, `x.stop_gradient`), the method stays
torch's and the function (`paddle.sum(x, axis=...)`) carries Paddle's
meaning (ROADMAP, deliberate differences).
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from .framework import amp_state as _amp
from .framework import config as _config
from .framework import device as _device
from .framework import dtype as _dtype

Tensor = torch.Tensor


def _default_float():
    return _dtype.to_torch_dtype(_config.get_default_dtype())


def _numpy_to_torch(arr: np.ndarray, dtype) -> torch.Tensor:
    """A numpy array as a CPU tensor of `dtype` (None: the reference's
    rule), bfloat16 and fp8 arrays crossing by their bits."""
    name = arr.dtype.name
    if name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        bits = np.int16 if name == "bfloat16" else np.int8
        t = torch.from_numpy(np.array(arr, order="C").view(bits)).view(
            _dtype.to_torch_dtype(name))
    else:
        if dtype is None and arr.dtype == np.float64:
            dtype = _default_float()
        # a copy in native byte order: the tensor never aliases `arr`
        t = torch.from_numpy(
            np.array(arr, dtype=arr.dtype.newbyteorder("="), order="C"))
    return t if dtype is None else t.to(dtype)


def _resolve_place(place):
    if place is None:
        return _device.resolve_device(None)
    return _device.resolve_device(place)


def as_array(x, device=None) -> torch.Tensor:
    """A tensor, numpy array, list or Python scalar as a tensor (the
    reference's `as_array`, whose raw value is a jax array): a tensor as it
    is, anything else by the conversion rules of `to_tensor` on `device`
    (None: `resolve_device(None)`)."""
    if isinstance(x, torch.Tensor):
        return x
    return _numpy_to_torch(np.asarray(x), None).to(_resolve_place(device))


def as_tensor_list(xs):
    return [as_array(x) for x in xs]


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: `data` (a tensor, numpy array, list or scalar) as
    a new tensor of `dtype` on `place`. From a tensor: with
    `stop_gradient=False` the result stays in the source's graph (a leaf
    source gives a new leaf that needs grad), else it is detached."""
    dt = _dtype.to_torch_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data if dt is None else data.to(dt)
        if place is not None:
            t = t.to(_resolve_place(place))
        if stop_gradient or t.grad_fn is None:
            t = t.detach()
            if t.data_ptr() == data.data_ptr():  # never alias the source
                t = t.clone()
            return t.requires_grad_(not stop_gradient)
        return t.view_as(t) if t is data else t
    t = _numpy_to_torch(np.asarray(data), dt).to(_resolve_place(place))
    return t.requires_grad_(not stop_gradient)


class Parameter(torch.nn.Parameter):
    """A trainable tensor (`stop_gradient=False` unless `trainable` is
    False): torch's `nn.Parameter` with the reference's constructor, so a
    layer registers it as its own. A torch tensor has no settable name, so
    `name` is not kept (ROADMAP, deliberate differences)."""

    def __new__(cls, data, dtype=None, name=None, trainable=True):
        t = data if isinstance(data, torch.Tensor) else to_tensor(data)
        dt = _dtype.to_torch_dtype(dtype)
        if dt is not None:
            t = t.to(dt)
        return super().__new__(cls, t.detach(), bool(trainable))

    def __init__(self, data, dtype=None, name=None, trainable=True):
        pass  # all done in __new__

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, v):
        self.requires_grad_(bool(v))


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def numel(x, name=None):
    """The number of elements of `x` as a 0-d int64 tensor on its
    device."""
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def _device_of(inputs):
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def apply_op(fn, *inputs, _name: str = "", **static_kwargs):
    """`fn(*tensors, **static_kwargs)` with the reference's `_apply_op`
    rules around it (`paddle_tpu/tensor.py:425`): every operand becomes a
    tensor (a Python scalar takes the dtype torch's own promotion gives it
    beside the first tensor operand, a numpy array or list the conversion
    rules of `to_tensor`, both on the first tensor operand's device);
    under `amp.auto_cast` the operands are cast by the reference's op
    lists (`framework.amp_state.cast_inputs`); under FLAGS_benchmark the
    op's name is recorded (`framework.op_stats`). Gradients are torch's
    autograd: the differentiable operands are the tensors among
    `inputs`."""
    dev = _device_of(inputs)
    first = next((x for x in inputs if isinstance(x, torch.Tensor)), None)
    tensors = []
    for x in inputs:
        if isinstance(x, torch.Tensor) or x is None:
            tensors.append(x)
        elif isinstance(x, (bool, numbers.Number)) and first is not None:
            tensors.append(torch.tensor(
                x, dtype=torch.result_type(first, x), device=dev))
        else:
            tensors.append(as_array(x, dev))
    name = _name or getattr(fn, "__name__", "")
    if _amp.enabled:
        tensors = _amp.cast_inputs(name, *tensors)
    if _config.get_flag("FLAGS_benchmark"):
        from .framework import op_stats

        op_stats.record(name)
    return fn(*tensors, **static_kwargs)
