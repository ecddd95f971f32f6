"""The functional ops (counterpart of `paddle_tpu/ops/__init__.py`).

The reference installs its ops as methods of its own Tensor class; the
port's tensor is `torch.Tensor`, whose methods stay torch's, so the ops
are functions only (`paddle.sum(x, axis=1)`, not `x.sum(axis=1)`).
"""
from . import (  # noqa: F401
    activation,
    creation,
    indexing,
    inplace,
    linalg,
    logic,
    manipulation,
    math,
    random_ops,
    reduction,
    search,
)
