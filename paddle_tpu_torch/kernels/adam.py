"""The Adam / AdamW parameter update in one pass: the CUDA kernel
`csrc/adam.cu` and its plain PyTorch version.

The reference has no Pallas kernel here: its compiled train step runs
`paddle_tpu/optimizer/optimizer.py::Adam._update_param` as one XLA fusion
per parameter. `adam_update` runs the plain version `adam_update_ref` for
CPU tensors (the CPU tests hold it bit for bit against the reference in
bf16) and the kernel for CUDA tensors, one launch a parameter; a CUDA input
the kernel does not take raises. `launches` counts the kernel's launches.

Both update p, m1, m2 and the master weight in place, in the reference's
order: g = f32(grad) (+ wd * work, Adam's L2), m1 = beta1 m1 + (1 - beta1)
g, m2 = beta2 m2 + (1 - beta2) g^2, work *= 1 - lr * coeff (AdamW), work -=
lr (m1 / bc1) / (sqrt(m2 / bc2) + eps), p = work in p's dtype; bc1 and bc2
(1 - beta^t) are f32 host scalars, so neither reads the device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None
_sms: dict = {}


def adam_update_ref(p, g, m1, m2, master, beta1, beta2, eps, lr, coeff, wd,
                    bc1, bc2):
    """The plain update (see the module's docstring), each f32 operation
    rounded on its own, in the kernel's order. p: the parameter
    (updated in place; for an f32 p without a master the working copy is p
    itself); g: its gradient; m1, m2: f32 moments; master: the f32 master
    weight or None; coeff: AdamW's decoupled decay (0: none); wd: Adam's L2
    coefficient (0: none)."""
    work = master if master is not None else p.detach().float()
    g = g.float()
    if wd:
        g = g + wd * work
    m1.mul_(beta1).add_(g * (1 - beta1))
    m2.mul_(beta2).add_(g.square().mul_(1 - beta2))
    if coeff:
        work.mul_(1 - lr * coeff)
    # true divisions by bc1 and bc2: divided by a host scalar, PyTorch's
    # CUDA kernel multiplies by its reciprocal instead
    bc1, bc2 = (torch.tensor(float(b), dtype=torch.float32, device=m1.device)
                for b in (bc1, bc2))
    denom = (m2 / bc2).sqrt_().add_(eps)
    work.sub_((m1 / bc1).mul_(lr).div_(denom))
    if work.data_ptr() != p.data_ptr():  # else f32 p was updated in place
        p.detach().copy_(work)  # the cast back to p's dtype


def adam_update(p, g, m1, m2, master, beta1, beta2, eps, lr, coeff, wd, bc1,
                bc2):
    """`adam_update_ref` for CPU tensors; the kernel for CUDA tensors."""
    if p.device.type == "cpu":
        return adam_update_ref(p, g, m1, m2, master, beta1, beta2, eps, lr,
                               coeff, wd, bc1, bc2)
    return _adam_update_cuda(p, g, m1, m2, master, beta1, beta2, eps, lr,
                             coeff, wd, bc1, bc2)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("adam")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.adam_update.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i,
                                    i, f, f, f, f, f, f, f, f, f, f, i, i, p]
        lib.adam_update.restype = i
        _lib = lib
    return _lib


def _sm_count(dev):
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev) \
            .multi_processor_count
    return _sms[dev]


def _adam_update_cuda(p, g, m1, m2, master, beta1, beta2, eps, lr, coeff,
                      wd, bc1, bc2):
    global launches
    g = g.contiguous()
    arrays = [t for t in (p, g, m1, m2, master) if t is not None]
    if any(t.device != p.device for t in arrays):
        raise ValueError("adam_update: p, g, the moments and the master "
                         "weight must be on one CUDA device")
    if p.dtype not in _DTYPE or g.dtype not in (p.dtype, torch.float32) \
            or any(t.dtype != torch.float32 for t in (m1, m2) +
                   (() if master is None else (master,))) \
            or (master is not None and p.dtype == torch.float32):
        raise TypeError(f"adam_update kernel takes float32, bfloat16 or "
                        f"float16 p, a gradient of p's dtype or float32 and "
                        f"float32 moments and master weight (none for "
                        f"float32 p), got p {p.dtype}, g {g.dtype}")
    if any(t.shape != p.shape for t in arrays):
        raise ValueError("adam_update: p, g, the moments and the master "
                         "weight must have one shape")
    if not all(t.is_contiguous() for t in arrays):
        raise ValueError("adam_update kernel takes contiguous tensors")
    vectors = int(all(t.data_ptr() % 16 == 0 for t in arrays))
    decay = 1 - lr * coeff
    with torch.cuda.device(p.device):
        rc = _kernel().adam_update(
            p.data_ptr(), g.data_ptr(), m1.data_ptr(), m2.data_ptr(),
            None if master is None else master.data_ptr(), p.numel(),
            _DTYPE[p.dtype], int(g.dtype != p.dtype), int(bool(coeff)),
            float(beta1), float(1 - beta1), float(beta2), float(1 - beta2),
            float(eps), float(lr), float(decay), float(wd), float(bc1),
            float(bc2), vectors, _sm_count(p.device),
            torch.cuda.current_stream(p.device).cuda_stream)
    if rc:
        raise RuntimeError(f"adam_update kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
