"""PyTorch/CUDA port of `paddle_tpu`, for NVIDIA Hopper (H100)
(usage: ``import paddle_tpu_torch as paddle``).

The layout mirrors `paddle_tpu/`: a module here has its counterpart at the
same path there. The package imports `torch`, never `jax` and nothing of
`paddle_tpu`. Its tensor is `torch.Tensor` and its layers are
`torch.nn.Module`s; the root carries Paddle's core over them, as the
reference's root does: `to_tensor`, the dtypes and places (`set_device`),
`backward` / `grad` / `no_grad`, and the ops of `ops/` as functions with
Paddle's names, arguments and meanings. Entry points and new tensors run
on CUDA unless the caller asks for the CPU (`set_device("cpu")`,
`device="cpu"` or a CPU place); with no CUDA present they raise. Every TPU
kernel on the ported path is a hand-written CUDA C++ kernel for `sm_90a`
under `kernels/csrc/`, built by `nvcc` at first use (`kernels._build`). A
wrapper runs its kernel's plain PyTorch version only for CPU tensors; for
a CUDA tensor it launches the kernel or raises. `set_flags` and
`get_flags` read and set the `FLAGS_*` registry (`framework.config`);
`seed` restarts the global random stream (`framework.random`) that
dropout, the layers' initial weights and the random ops draw from. `save`
and `load` write and read checkpoints that the JAX package reads and
writes too (`framework.io`).
"""
__version__ = "0.1.0"

import torch as _torch

# --- framework core ---
from .framework import config as _config
from .framework import device as _device_mod
from .framework import dtype as _dtype_mod
from .framework.config import (
    get_default_dtype,
    get_flags,
    set_default_dtype,
    set_flags,
)
from .framework.device import (
    CPUPlace,
    CUDAPlace,
    Place,
    TPUPlace,
    get_device,
    is_compiled_with_cuda,
    is_compiled_with_xpu,
    is_compiled_with_rocm,
    is_compiled_with_custom_device,
    get_cudnn_version,
    is_compiled_with_distribute,
    is_compiled_with_tpu,
    set_device,
)
from .framework.dtype import (  # noqa: F401
    DType,
    bfloat16,
    bool_ as bool,  # noqa: A001  (paddle exports paddle.bool)
    complex64,
    complex128,
    float16,
    float32,
    float64,
    int8,
    int16,
    int32,
    int64,
    uint8,
)
from .framework.random import get_rng_state, get_seed, seed, set_rng_state

# --- tensor + autograd ---
from .tensor import Parameter, Tensor, is_tensor, numel, to_tensor
from .autograd.tape import (
    enable_grad,
    grad,
    is_grad_enabled,
    no_grad,
    set_grad_enabled,
)

# --- ops: the paddle.* op surface ---
from . import ops as _ops
from .ops.activation import *  # noqa: F401,F403
from .ops.creation import (  # noqa: F401
    arange,
    assign,
    clone,
    complex,  # noqa: A001
    diag,
    diag_embed,
    diagflat,
    empty,
    empty_like,
    eye,
    full,
    full_like,
    linspace,
    logspace,
    meshgrid,
    one_hot,
    ones,
    ones_like,
    polar,
    tril,
    tril_indices,
    triu,
    triu_indices,
    vander,
    zeros,
    zeros_like,
)
from .ops.math import *  # noqa: F401,F403
from .ops.reduction import *  # noqa: F401,F403
from .ops.manipulation import *  # noqa: F401,F403
from .ops.logic import *  # noqa: F401,F403
from .ops.search import *  # noqa: F401,F403
from .ops.linalg import (  # noqa: F401
    bincount,
    bmm,
    cdist,
    corrcoef,
    cov,
    cross,
    dist,
    dot,
    einsum,
    histogram,
    histogram_bin_edges,
    histogramdd,
    lu,
    lu_unpack,
    matmul,
    matrix_transpose,
    mm,
    multi_dot,
    mv,
    norm,
    pdist,
    tensordot,
    vecdot,
)
from .ops.inplace import *  # noqa: F401,F403 (the paddle `op_` family)
from .ops.random_ops import (  # noqa: F401
    bernoulli,
    binomial,
    geometric_,
    multinomial,
    normal,
    poisson,
    rand,
    randint,
    randint_like,
    randn,
    randperm,
    standard_gamma,
    standard_normal,
    uniform,
)
from .tensor import is_tensor  # noqa: F811 (logic.py's, the same test)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """paddle.set_printoptions: torch's print options."""
    _torch.set_printoptions(precision=precision, threshold=threshold,
                            edgeitems=edgeitems, linewidth=linewidth,
                            sci_mode=sci_mode)


class LazyGuard:
    """paddle.LazyGuard: the reference's guard does nothing (parameters are
    made at once); so does the port's."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# --- subsystems ---
from . import amp  # noqa: F401,E402
from . import autograd  # noqa: F401,E402
from . import device  # noqa: F401,E402
from . import distributed  # noqa: F401,E402
from . import framework  # noqa: F401,E402
from . import incubate  # noqa: F401,E402
from . import inference  # noqa: F401,E402
from . import io  # noqa: F401,E402
from . import jit  # noqa: F401,E402
from . import linalg  # noqa: F401,E402
from . import nn  # noqa: F401,E402
from . import optimizer  # noqa: F401,E402
from . import tensor  # noqa: F401,E402

from .distributed.parallel import DataParallel  # noqa: F401,E402
from .framework.io import load, save  # noqa: F401,E402


def get_cuda_rng_state():
    return get_rng_state()


def set_cuda_rng_state(state):
    set_rng_state(state)


def in_dynamic_mode():
    """Always True: the port runs eagerly (`jit.to_static` is not ported,
    ROADMAP Queue 1 item 8 B)."""
    return True


def device_count():
    return _device_mod.device_count()


def version():
    return __version__


class _FInfo:
    pass


def finfo(dtype):
    """Float type limits (min, max, eps, tiny, smallest_normal,
    resolution, bits, dtype), torch's `finfo` under Paddle's names."""
    dt = _dtype_mod.to_torch_dtype(dtype)
    info = _torch.finfo(dt)
    out = _FInfo()
    out.min, out.max, out.eps = float(info.min), float(info.max), \
        float(info.eps)
    out.tiny = out.smallest_normal = float(info.tiny)
    # numpy's resolution is a value of the dtype (10^-precision rounded)
    out.resolution = float(_torch.tensor(info.resolution, dtype=dt))
    out.bits = int(info.bits)
    out.dtype = _dtype_mod.dtype_name(dt)
    return out


def iinfo(dtype):
    """Integer type limits (min, max, bits, dtype)."""
    dt = _dtype_mod.to_torch_dtype(dtype)
    info = _torch.iinfo(dt)
    out = _FInfo()
    out.min, out.max, out.bits = int(info.min), int(info.max), \
        int(info.bits)
    out.dtype = _dtype_mod.dtype_name(dt)
    return out
