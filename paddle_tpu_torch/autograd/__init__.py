"""Autograd (counterpart of `paddle_tpu/autograd/__init__.py`): the
grad-mode guards, `backward` and `grad` over torch's autograd; `PyLayer`;
the functional transforms; `saved_tensors_hooks` (torch's: its pack hook
runs on every tensor an op saves for its backward, its unpack hook when the
backward reads it)."""
from torch.autograd.graph import saved_tensors_hooks  # noqa: F401

from .functional import hessian, jacobian, jvp, vjp  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401
from .tape import (  # noqa: F401
    backward,
    enable_grad,
    grad,
    is_grad_enabled,
    no_grad,
    set_grad_enabled,
)
