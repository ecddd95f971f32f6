"""RMSNorm forward and backward: the CUDA kernels `csrc/rms_norm.cu` and
their plain PyTorch versions.

Counterpart of `paddle_tpu/kernels/rms_norm.py` (the Pallas forward `_fwd`
and backward `_rms_bwd`). `rms_norm` and `rms_norm_bwd` run the plain
version for CPU tensors and a kernel for CUDA tensors, one launch a call;
a CUDA input no kernel takes (an integer x, a weight of another shape)
raises. `RMSNormFunction` is the differentiable op the training path uses
(forward with rstd, backward by the backward kernel). `launches` and
`bwd_launches` count the kernels' launches.

x is float32, bfloat16 or float16 [..., cols], any cols >= 1; the weight
[cols] is in x's dtype or float32, or None (a scale of 1, and no dw). Each
direction has three instances (`route`): for arrays whose every row is
16-byte aligned and at most 2048 16-byte vectors wide, "ring", which
streams rows through shared memory by bulk copies, or "direct", one row a
block straight into registers where there are no more rows than SMs
(decode); for any other width or alignment, "stream", which reads device
memory directly.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
bwd_launches = 0

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None
_plans: dict = {}  # (device, bwd, mode, cols, dtype, w_f32) -> plan
_sms: dict = {}  # device -> its SM count
_tickets: dict = {}  # device -> the backward's ticket (one int32, 0)


def rms_norm_ref(x, weight=None, eps=1e-6, with_rstd=False):
    """y = x * rsqrt(mean(x^2) + eps) * w (no w: no scale), statistics in
    f32, y in x.dtype. with_rstd: also return rstd, f32 of x's leading
    shape."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1) + eps)
    y = xf * rstd[..., None]
    if weight is not None:
        y = y * weight.float()
    y = y.to(x.dtype)
    return (y, rstd) if with_rstd else y


def rms_norm_bwd_ref(x, weight, rstd, g):
    """(dx, dw) of y = rms_norm(x) * w for x, g [rows, cols] and the
    forward's rstd [rows]: with xh = x * rstd and wg = g * w,
    dx = rstd * (wg - xh * mean(wg * xh)), dw = sum over rows of g * xh;
    f32 arithmetic, dx in x.dtype, dw in weight.dtype (None without a
    weight, and then wg = g)."""
    xh = x.float() * rstd[:, None]
    gf = g.float()
    wg = gf if weight is None else gf * weight.float()
    mean = (wg * xh).mean(dim=-1, keepdim=True)
    dx = rstd[:, None] * (wg - xh * mean)
    dw = None if weight is None else (gf * xh).sum(dim=0).to(weight.dtype)
    return dx.to(x.dtype), dw


def rms_norm(x, weight=None, eps=1e-6, with_rstd=False):
    """x: [..., cols]; weight: [cols] or None. with_rstd: also return rstd
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


def supports(x, weight=None):
    """Whether the kernels take this input: float32, bfloat16 or float16 x
    with at least one row and one column, and a weight that is None or
    [cols] in x's dtype or float32."""
    if x.dtype not in _DTYPE or x.dim() == 0 or x.numel() == 0:
        return False
    return weight is None or (
        tuple(weight.shape) == (x.shape[-1],)
        and weight.dtype in (x.dtype, torch.float32))


def ring_aligned(tensors, cols, elt):
    """Whether every row of every tensor starts on a 16-byte boundary (the
    ring instances' bulk copies need it): each tensor 16-byte aligned and
    a row a whole number of 16 bytes."""
    return (cols * elt) % 16 == 0 and all(t.data_ptr() % 16 == 0
                                          for t in tensors)


class RMSNormFunction(torch.autograd.Function):
    """Differentiable RMSNorm over x [rows, cols] (contiguous), weight
    [cols] or None: the forward saves rstd, the backward is
    `rms_norm_bwd`."""

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
        lib.rms_norm_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
        lib.rms_norm_plan.restype = i
        lib.rms_norm_fwd.argtypes = [p, p, p, p, i, i, ctypes.c_float, i, i,
                                     i, i, i, i, i, p]
        lib.rms_norm_fwd.restype = i
        lib.rms_norm_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                     i, i, i, i, p]
        lib.rms_norm_bwd.restype = i
        _lib = lib
    return _lib


_MODES = {"stream": 0, "ring": 1, "direct": 2}


def _plan(dev, bwd, mode, cols, dtype, w_f32):
    """(threads, stages, smem, blocks the card holds) of an instance, or
    None where it does not take `cols`."""
    key = (dev, bwd, mode, cols, dtype, w_f32)
    if key not in _plans:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            rc = _kernel().rms_norm_plan(int(bwd), _MODES[mode], cols,
                                         _DTYPE[dtype], int(w_f32), out)
        if rc:
            raise RuntimeError(f"rms_norm plan failed: CUDA error {rc}")
        _plans[key] = (out[0], out[1], out[2], out[3] * _sm_count(dev)) \
            if out[0] else None
    return _plans[key]


def _sm_count(dev):
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev) \
            .multi_processor_count
    return _sms[dev]


def route(x, weight, bwd, *others):
    """The instance a launch on CUDA tensors takes, as a dict: "route",
    "grid" (persistent blocks: at most one a row and the blocks the card
    holds at once), "threads", "stages", "smem". Where every row of x and
    `others` (the other arrays whose rows the kernel reads or writes) is
    16-byte aligned and at most 2048 vectors wide: "direct" (one row a
    block, no ring) for at most one row an SM and a 16-byte aligned weight
    (or none), else "ring"; otherwise "stream"."""
    cols = x.shape[-1]
    rows = x.numel() // cols
    dev = x.device.index
    w_f32 = weight is not None and weight.dtype != x.dtype
    mode, plan = "stream", None
    if ring_aligned((x, *others), cols, x.element_size()):
        direct = rows <= _sm_count(dev) and (
            weight is None or weight.data_ptr() % 16 == 0)
        mode = "direct" if direct else "ring"
        plan = _plan(dev, bwd, mode, cols, x.dtype, w_f32)
    if plan is None:
        mode = "stream"
        plan = _plan(dev, bwd, mode, cols, x.dtype, w_f32)
    threads, stages, smem, cap = plan
    if cap < 1:
        raise RuntimeError(f"rms_norm: no block of {threads} threads fits "
                           "an SM")
    grid = min(rows, cap)
    return dict(route=mode, grid=grid, threads=threads, stages=stages,
                smem=smem)


def _check(name, x, weight, *others):
    if x.device.type != "cuda" or any(
            t.device != x.device
            for t in (*others, *(() if weight is None else (weight,)))):
        raise ValueError(f"{name}: x on {x.device}, weight on "
                         f"{None if weight is None else weight.device}; "
                         "all must be on one CUDA device")
    if x.dtype not in _DTYPE or (weight is not None and weight.dtype not in
                                 (x.dtype, torch.float32)):
        raise TypeError(f"{name} kernel takes float32, bfloat16 or float16 "
                        "x and a weight of x's dtype or float32, got "
                        f"{x.dtype}/{None if weight is None else weight.dtype}")
    cols = x.shape[-1] if x.dim() else 0
    if weight is not None and tuple(weight.shape) != (cols,):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} does not "
                         f"match the last dim {cols} of x")
    if not all(t.is_contiguous() for t in (
            x, *others, *(() if weight is None else (weight,)))):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    return cols


def _ptr(t):
    return None if t is None else t.data_ptr()


def _rms_norm_cuda(x, weight, eps, with_rstd=False):
    global launches
    cols = _check("rms_norm", x, weight)
    y = torch.empty_like(x)
    rows = x.numel() // cols if cols else 0
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device) \
        if with_rstd else None
    if rows == 0:
        return (y, rstd) if with_rstd else y
    r = route(x, weight, False, y)
    fn = _kernel().rms_norm_fwd
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), _ptr(weight), y.data_ptr(), _ptr(rstd), rows,
                cols, float(eps), _DTYPE[x.dtype],
                int(weight is not None and weight.dtype != x.dtype),
                _MODES[r["route"]], r["grid"], r["threads"], r["stages"],
                r["smem"], torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {rc}")
    launches += 1
    return (y, rstd) if with_rstd else y


def _ticket(dev):
    """The backward's ticket on `dev`: one int32, 0 between launches (the
    kernel resets it), made once a device."""
    t = _tickets.get(dev)
    if t is None:
        t = _tickets[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def _rms_norm_bwd_cuda(x, weight, rstd, g):
    global bwd_launches
    cols = _check("rms_norm_bwd", x, weight, rstd, g)
    rows = x.numel() // cols
    if x.dim() != 2 or g.shape != x.shape or rstd.shape != (rows,) \
            or rstd.dtype != torch.float32 or g.dtype != x.dtype or rows < 1:
        raise ValueError(f"rms_norm_bwd: x {tuple(x.shape)} [rows, cols], g "
                         f"{tuple(g.shape)} {g.dtype}, rstd "
                         f"{tuple(rstd.shape)} {rstd.dtype} (want [rows] "
                         "float32) do not agree")
    dx = torch.empty_like(x)
    r = route(x, weight, True, g, dx)
    dw = part = ticket = None
    if weight is not None:
        dw = torch.empty_like(weight)
        part = torch.empty(r["grid"], cols, dtype=torch.float32,
                           device=x.device)
        ticket = _ticket(x.device)
    fn = _kernel().rms_norm_bwd
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), _ptr(weight), rstd.data_ptr(), g.data_ptr(),
                dx.data_ptr(), _ptr(dw), _ptr(part), _ptr(ticket), rows, cols,
                _DTYPE[x.dtype],
                int(weight is not None and weight.dtype != x.dtype),
                _MODES[r["route"]], r["grid"], r["threads"], r["stages"],
                r["smem"],
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rms_norm_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    bwd_launches += 1
    return dx, dw
