"""RMSNorm forward and backward: the CUDA kernels `csrc/rms_norm.cu` and
their plain PyTorch versions.

Counterpart of `paddle_tpu/kernels/rms_norm.py` (the Pallas forward `_fwd`
and backward `_rms_bwd`). `rms_norm` and `rms_norm_bwd` run the plain
version for CPU tensors and the kernel for CUDA tensors; a CUDA input the
kernel does not take raises. `RMSNormFunction` is the differentiable op the
training path uses (forward with rstd, backward by the backward kernel).
`launches` and `bwd_launches` count the kernels' launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
bwd_launches = 0

_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte load
_MAX_VECS = 8 * 512  # forward: 8 vectors per thread, 512 threads per row
_MAX_BWD_VECS = 8 * 256  # backward: 8 vectors per thread, 256 threads
_lib = None


def rms_norm_ref(x, weight, eps=1e-6, with_rstd=False):
    """y = x * rsqrt(mean(x^2) + eps) * w, statistics in f32, y in x.dtype.
    with_rstd: also return rstd, f32 of x's leading shape."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1) + eps)
    y = (xf * rstd[..., None] * weight.float()).to(x.dtype)
    return (y, rstd) if with_rstd else y


def rms_norm_bwd_ref(x, weight, rstd, g):
    """(dx, dw) of y = rms_norm(x) * w for x, g [rows, cols] and the
    forward's rstd [rows]: with xh = x * rstd and wg = g * w,
    dx = rstd * (wg - xh * mean(wg * xh)), dw = sum over rows of g * xh;
    f32 arithmetic, dx in x.dtype, dw in weight.dtype."""
    xh = x.float() * rstd[:, None]
    gf = g.float()
    wg = gf * weight.float()
    mean = (wg * xh).mean(dim=-1, keepdim=True)
    dx = rstd[:, None] * (wg - xh * mean)
    return dx.to(x.dtype), (gf * xh).sum(dim=0).to(weight.dtype)


def rms_norm(x, weight, eps=1e-6, with_rstd=False):
    """x: [..., cols]; weight: [cols]. with_rstd: also return rstd
    ([...] f32, what the backward needs)."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps, with_rstd)
    return _rms_norm_cuda(x, weight, eps, with_rstd)


def rms_norm_bwd(x, weight, rstd, g):
    """(dx, dw) for x, g [rows, cols], rstd [rows] f32 (see
    `rms_norm_bwd_ref`)."""
    if x.device.type == "cpu":
        return rms_norm_bwd_ref(x, weight, rstd, g)
    return _rms_norm_bwd_cuda(x, weight, rstd, g)


def supports(x, weight):
    """Whether the kernels take this input: float32 or bfloat16 x and
    weight of one dtype, weight [cols], cols a multiple of the 16-byte
    vector and within both kernels' per-row limit, at least one row."""
    vec = _VEC.get(x.dtype)
    cols = x.shape[-1] if x.dim() else 0
    return (vec is not None and weight.dtype == x.dtype
            and tuple(weight.shape) == (cols,) and cols > 0
            and cols % vec == 0 and cols // vec <= _MAX_BWD_VECS
            and x.numel() > 0)


class RMSNormFunction(torch.autograd.Function):
    """Differentiable RMSNorm over x [rows, cols] (contiguous): the forward
    saves rstd, the backward is `rms_norm_bwd`."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        y, rstd = rms_norm(x, weight, eps, with_rstd=True)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, rstd, g.contiguous())
        return dx, dw, None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("rms_norm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rms_norm_fwd.argtypes = [p, p, p, p, i, i, ctypes.c_float, i, p]
        lib.rms_norm_fwd.restype = ctypes.c_int
        lib.rms_norm_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        lib.rms_norm_bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, x, weight, max_vecs, *others):
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (weight, *others)):
        raise ValueError(f"{name}: x on {x.device}, weight on "
                         f"{weight.device}; all must be on one CUDA device")
    if x.dtype not in _VEC or weight.dtype != x.dtype:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 x and "
                        f"weight of one dtype, got {x.dtype}/{weight.dtype}")
    cols = x.shape[-1]
    if weight.shape != (cols,):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} does not "
                         f"match the last dim {cols} of x")
    if not all(t.is_contiguous() for t in (x, weight, *others)):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    vec = _VEC[x.dtype]
    if cols % vec or cols // vec > max_vecs:
        raise ValueError(f"{name} kernel takes cols divisible by {vec} "
                         f"and at most {vec * max_vecs}, got {cols}")
    if any(t.data_ptr() % 16 for t in (x, weight, *others)):
        raise ValueError(f"{name} kernel takes 16-byte aligned tensors")
    return cols


def _rms_norm_cuda(x, weight, eps, with_rstd=False):
    global launches
    cols = _check("rms_norm", x, weight, _MAX_VECS)
    y = torch.empty_like(x)
    rows = x.numel() // cols if cols else 0
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device) \
        if with_rstd else None
    fn = _kernel().rms_norm_fwd
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), weight.data_ptr(), y.data_ptr(),
                None if rstd is None else rstd.data_ptr(), rows, cols,
                float(eps), int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {rc}")
    launches += 1
    return (y, rstd) if with_rstd else y


def _rms_norm_bwd_cuda(x, weight, rstd, g):
    global bwd_launches
    cols = _check("rms_norm_bwd", x, weight, _MAX_BWD_VECS, rstd, g)
    rows = x.numel() // cols
    if x.dim() != 2 or g.shape != x.shape or rstd.shape != (rows,) \
            or rstd.dtype != torch.float32 or g.dtype != x.dtype or rows < 1:
        raise ValueError(f"rms_norm_bwd: x {tuple(x.shape)} [rows, cols], g "
                         f"{tuple(g.shape)} {g.dtype}, rstd "
                         f"{tuple(rstd.shape)} {rstd.dtype} (want [rows] "
                         "float32) do not agree")
    # two blocks per SM, each walking rows with a stride of n_part
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_part = min(rows, 2 * sms)
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    part = torch.empty(n_part, cols, dtype=torch.float32, device=x.device)
    fn = _kernel().rms_norm_bwd
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), weight.data_ptr(), rstd.data_ptr(),
                g.data_ptr(), dx.data_ptr(), dw.data_ptr(), part.data_ptr(),
                rows, cols, n_part, int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rms_norm_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    bwd_launches += 1
    return dx, dw
