"""RMSNorm forward: the CUDA kernel `csrc/rms_norm.cu` and its plain
PyTorch version.

Counterpart of `paddle_tpu/kernels/rms_norm.py` (the Pallas forward `_fwd`).
`rms_norm` runs `rms_norm_ref` for CPU tensors and the kernel for CUDA
tensors; a CUDA input the kernel does not take raises. `launches` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte load
_MAX_VECS = 8 * 512  # 8 vectors per thread, 512 threads per row
_lib = None


def rms_norm_ref(x, weight, eps=1e-6):
    """y = x * rsqrt(mean(x^2) + eps) * w, statistics in f32, y in x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rms_norm(x, weight, eps=1e-6):
    """x: [..., cols]; weight: [cols]."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps)
    return _rms_norm_cuda(x, weight, eps)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("rms_norm")
        lib.rms_norm_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.rms_norm_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib.rms_norm_fwd


def _rms_norm_cuda(x, weight, eps):
    global launches
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"rms_norm: x on {x.device} and weight on "
                         f"{weight.device}; both must be on one CUDA device")
    if x.dtype not in _VEC or weight.dtype != x.dtype:
        raise TypeError(f"rms_norm kernel takes float32 or bfloat16 x and "
                        f"weight of one dtype, got {x.dtype}/{weight.dtype}")
    cols = x.shape[-1]
    if weight.shape != (cols,):
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} does not "
                         f"match the last dim {cols} of x")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel takes contiguous tensors")
    vec = _VEC[x.dtype]
    if cols % vec or cols // vec > _MAX_VECS:
        raise ValueError(f"rms_norm kernel takes cols divisible by {vec} "
                         f"and at most {vec * _MAX_VECS}, got {cols}")
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("rms_norm kernel takes 16-byte aligned tensors")
    y = torch.empty_like(x)
    rows = x.numel() // cols if cols else 0
    fn = _kernel()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), weight.data_ptr(), y.data_ptr(), rows, cols,
                float(eps), int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {rc}")
    launches += 1
    return y
