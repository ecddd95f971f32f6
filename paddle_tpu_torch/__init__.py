"""PyTorch/CUDA port of `paddle_tpu`, for NVIDIA Hopper (H100).

The layout mirrors `paddle_tpu/`: a module here has its counterpart at the
same path there. The package imports `torch`, never `jax` and nothing of
`paddle_tpu`. Entry points run on CUDA unless the caller passes
`device="cpu"` (`framework.device.resolve_device`). Every TPU kernel on the
ported path is a hand-written CUDA C++ kernel for `sm_90a` under
`kernels/csrc/`, built by `nvcc` at first use (`kernels._build`). A wrapper
runs its kernel's plain PyTorch version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises. `set_flags` and `get_flags` read
and set the `FLAGS_*` registry (`framework.config`), which is seeded from
the environment at import; `seed` restarts the global random stream
(`framework.random`) that dropout and the layers' initial weights draw
from.
"""
__version__ = "0.1.0"

from .framework.config import get_flags, set_flags
from .framework.random import get_rng_state, get_seed, seed, set_rng_state

__all__ = ["get_flags", "get_rng_state", "get_seed", "seed", "set_flags",
           "set_rng_state"]
