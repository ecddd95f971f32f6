"""Dense matmul: the CUDA kernel `csrc/matmul.cu` and its plain PyTorch
version.

Counterpart of `paddle_tpu/kernels/matmul.py` (the Pallas body `_mm_kernel`,
launched by `_fused_call`): y [m, n] = x [m, k] @ w [k, n] in x's dtype,
summed in f32. The weight is Paddle's [in, out] layout.

- `matmul_ref` is the plain version (`torch.matmul`, the counterpart of
  `matmul_xla`).
- `matmul_fused` runs the plain version for CPU tensors and the kernel for
  CUDA tensors; a CUDA input the kernel does not take (`supports`) raises.
  `tile` picks the kernel's row tile (`tiles`), the tuner's candidates;
  None picks by m. `launches` counts the kernel's launches.
- `MatmulFunction` makes it differentiable in both operands; its backward is
  the two transposed `torch.matmul`s, which the reference computes outside
  Pallas too (`_fused_bwd`).

`supports` takes every shape the reference's `supports` takes (k and n
multiples of 128) and more: k a multiple of 64, n of 128, any m >= 1 (the
kernel masks the m tail where the reference pads x by a copy).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_K_MULTIPLE = 64   # the kernel's k tile (bf16; f32 takes 32)
_N_MULTIPLE = 128  # the kernel's n tile
_TILES = {torch.bfloat16: (16, 64, 128), torch.float32: (16, 64)}
_lib = None
_slots: dict = {}  # (device, row tile, bf16) -> blocks the card holds


def matmul_ref(x, w):
    """x @ w by `torch.matmul` (the plain counterpart of `matmul_xla`)."""
    return torch.matmul(x, w)


def tiles(dtype):
    """The kernel's row tiles for x's dtype: 16 rows (decode's m of 1-16),
    64 and 128; bf16 runs on the tensor cores, f32 on the CUDA cores."""
    return _TILES.get(dtype, ())


def supports(m, k, n, dtype=torch.bfloat16):
    """Whether the kernel takes this shape: m >= 1, k a multiple of 64, n a
    multiple of 128, float32 or bfloat16 operands of one dtype."""
    return (m >= 1 and k > 0 and n > 0 and k % _K_MULTIPLE == 0
            and n % _N_MULTIPLE == 0 and dtype in _TILES)


def default_tile(m, dtype=torch.bfloat16):
    return 16 if m <= 16 else max(tiles(dtype))


def matmul_fused(x, w, tile=None):
    """x [..., k] @ w [k, n] -> [..., n] in x's dtype, by the kernel on CUDA
    (raising on what it does not take) and by `matmul_ref` on the CPU.
    Differentiable in x and w."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MatmulFunction.apply(x, w, tile)
    return _forward(x, w, tile)


def _forward(x, w, tile):
    lead, k = x.shape[:-1], x.shape[-1]
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"matmul: weight {tuple(w.shape)} does not take "
                         f"x of in features {k}")
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    y = _matmul_cuda(x.reshape(-1, k), w, tile)
    return y.reshape(*lead, w.shape[1])


class MatmulFunction(torch.autograd.Function):
    """y = x @ w; the backward gives dx = g @ w^T and dw = x^T @ g by
    `torch.matmul`, as the reference's `_fused_bwd` does by XLA."""

    @staticmethod
    def forward(ctx, x, w, tile):
        ctx.save_for_backward(x, w)
        return _forward(x, w, tile)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k, n = w.shape
        dx = torch.matmul(g, w.t()).to(x.dtype) \
            if ctx.needs_input_grad[0] else None
        dw = torch.matmul(x.reshape(-1, k).t(), g.reshape(-1, n)) \
            .to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.matmul.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.matmul.restype = ctypes.c_int
        lib.matmul_blocks_per_sm.argtypes = [i, i]
        lib.matmul_blocks_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


def _splits(m, k, n, tile, bf16, dev):
    """k splits of the grid: at decode's small m the n / 128 column blocks
    alone leave most SMs idle, so k is split until the blocks fill one
    wave of resident blocks; 1 where the m and n blocks already do."""
    key = (dev, tile, bf16)
    if key not in _slots:
        with torch.cuda.device(dev):
            per_sm = _kernel().matmul_blocks_per_sm(tile, int(bf16))
        if per_sm < 1:
            raise RuntimeError(f"matmul kernel cannot be resident "
                               f"(occupancy query returned {per_sm})")
        _slots[key] = per_sm * torch.cuda.get_device_properties(dev) \
            .multi_processor_count
    blocks = (n // _N_MULTIPLE) * -(-m // tile)
    bk = _K_MULTIPLE if bf16 else _K_MULTIPLE // 2
    return max(1, min(k // bk, _slots[key] // blocks))


def _matmul_cuda(x, w, tile=None):
    global launches
    dev = x.device
    for name, t in (("x", x), ("w", w)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"matmul: {name} on {t.device}, x on {dev}; "
                             f"both must be on one CUDA device")
    if x.dtype != w.dtype or x.dtype not in _TILES:
        raise TypeError(f"matmul kernel takes float32 or bfloat16 x and w "
                        f"of one dtype, got {x.dtype} and {w.dtype}")
    m, k = x.shape
    n = w.shape[1]
    if not supports(m, k, n, x.dtype):
        raise ValueError(f"matmul kernel does not take m={m} k={k} n={n}: "
                         f"see matmul.supports")
    if tile is None:
        tile = default_tile(m, x.dtype)
    if tile not in tiles(x.dtype):
        raise ValueError(f"matmul kernel has row tiles {tiles(x.dtype)} for "
                         f"{x.dtype}, not {tile}")
    x = x.contiguous()
    if not w.is_contiguous():
        raise ValueError("matmul kernel takes a contiguous weight")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("matmul kernel takes 16-byte aligned x and w")
    bf16 = x.dtype == torch.bfloat16
    splits = _splits(m, k, n, tile, bf16, dev)
    out = torch.empty(m, n, dtype=x.dtype, device=dev)
    part = torch.empty(splits, m, n, dtype=torch.float32, device=dev) \
        if splits > 1 else None
    with torch.cuda.device(dev):
        rc = _kernel().matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), m, k, n, tile,
            splits, int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
