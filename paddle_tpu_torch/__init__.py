"""PyTorch/CUDA port of `paddle_tpu`, for NVIDIA Hopper (H100).

The layout mirrors `paddle_tpu/`: a module here has its counterpart at the
same path there. The package imports `torch`, never `jax` and nothing of
`paddle_tpu`. Entry points run on CUDA unless the caller passes
`device="cpu"` (`framework.device.resolve_device`). Every TPU kernel on the
ported path is a hand-written CUDA C++ kernel for `sm_90a` under
`kernels/csrc/`, built by `nvcc` at first use (`kernels._build`). A wrapper
runs its kernel's plain PyTorch version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises.
"""
__version__ = "0.1.0"
