"""Weight-only dequant matmul: the CUDA kernel `csrc/quant_matmul.cu` and its
plain PyTorch version.

Counterpart of `paddle_tpu/kernels/quant_matmul.py` (the Pallas kernel
`_qmm_kernel`, launched by `_fused_call`). y = x @ dequant(qw): the weight
is int8 [k, n], or int4 packed two rows to a byte along k ([k // 2, n],
low nibble = even row), with f32 scales [n] (per channel) or [k / g, n]
(groups of g rows along k). The layouts are `nn.quant.weight_quantize`'s.

- `unpack_int4`, `dequantize` and `quant_matmul_ref` (the counterpart of
  `quant_matmul_xla`: dequantize to x.dtype, then `torch.matmul`) are the
  plain versions.
- `quant_matmul` runs the plain version for CPU tensors and a kernel for
  CUDA tensors, at every m (the reference caps its single m block at 1024
  and gives larger m to XLA; the kernels tile m), one launch per call for
  bf16 x: at m > 16 the persistent wgmma kernel (`quant_matmul_prefill`,
  its walk over the output tiles from `prefill_schedule`), at decode's m
  <= 16 the streaming decode kernel (`quant_matmul_decode`, its split of
  the weight from `matmul.decode_schedule`, reduced in the same launch);
  float32 x goes to the split kernel (`quant_matmul`, its k split from
  `_splits`, summed by a second kernel). A CUDA input the kernels do not
  take (`supports`) raises. `launches` counts the calls that launched a
  kernel, `kernel_launches` those of each kernel ("prefill", "decode",
  "split"; `reset_launches` zeroes both). With a gradient,
  `QuantMatmulFunction` gives dx only, by the plain transposed product, as
  the reference's `_fused_bwd` does.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._tiles import refuse_tiles
from . import matmul as _mm

launches = 0
kernel_launches = {"prefill": 0, "decode": 0, "split": 0}

GROUP_SIZES = (-1, 64, 128)
_K_MULTIPLE = 64   # the kernels' k tile (bf16 inputs)
_N_MULTIPLE = 128  # the kernels' n tile
_SMALL_M = 16      # decode: the decode kernel's rows (bf16)
PREFILL_TILE = 128  # the prefill kernel's output tile, rows and columns
_BAND_BYTES = _mm._BAND_BYTES  # the x band the prefill walk keeps in L2
_lib = None
_slots: dict = {}  # (device, row tile, int4) -> blocks the card holds


def reset_launches():
    global launches
    launches = 0
    for kind in kernel_launches:
        kernel_launches[kind] = 0


def unpack_int4(qw):
    """[k // 2, n] nibble-packed int8 -> [k, n] int8 in [-8, 7]: byte row r
    holds row 2r in its low nibble and row 2r + 1 in its high nibble, each
    a two's-complement 4-bit value."""
    b = qw.to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    k2, n = qw.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * k2, n).to(torch.int8)


def dequantize(qw, scales, weight_dtype="int8", out_dtype=torch.float32):
    """The [k, n] weight in `out_dtype`: q and the scales are each cast to
    `out_dtype` and multiplied there, as the reference does. scales: [n] or
    [groups, n]."""
    q = unpack_int4(qw) if weight_dtype == "int4" else qw
    k, n = q.shape
    s = scales if scales.dim() == 2 else scales[None, :]
    groups = s.shape[0]
    w = q.reshape(groups, k // groups, n).to(out_dtype) \
        * s[:, None, :].to(out_dtype)
    return w.reshape(k, n)


def quant_matmul_ref(x, qw, scales, weight_dtype="int8"):
    """y = x @ dequantize(qw, scales) in x.dtype (the plain counterpart of
    the reference's `quant_matmul_xla`)."""
    return torch.matmul(x, dequantize(qw, scales, weight_dtype, x.dtype))


def supports(m, k, n, weight_dtype="int8", group_size=-1, block_n=None,
             block_k=None):
    """Whether the kernel takes this shape: m >= 1, k a multiple of 64 and
    of the group, n a multiple of 128, int8 or int4, per-channel scales or
    groups of 64 or 128 rows. `block_n` / `block_k` are the reference's TPU
    tile sizes: None."""
    refuse_tiles("quant_matmul.supports", block_n=block_n, block_k=block_k)
    return (m >= 1 and k > 0 and n > 0 and k % _K_MULTIPLE == 0
            and n % _N_MULTIPLE == 0 and weight_dtype in ("int8", "int4")
            and group_size in GROUP_SIZES
            and (group_size == -1 or k % group_size == 0))


def quant_matmul(x, qw, scales, weight_dtype="int8", group_size=-1):
    """x [..., k] float32 or bfloat16; qw int8 [k, n] (int4: [k // 2, n]);
    scales f32 [n] (group_size -1) or [k // group_size, n]. Returns
    [..., n] in x.dtype. Differentiable in x."""
    if torch.is_grad_enabled() and x.requires_grad:
        return QuantMatmulFunction.apply(x, qw, scales, weight_dtype,
                                         group_size)
    return _forward(x, qw, scales, weight_dtype, group_size)


def _forward(x, qw, scales, weight_dtype, group_size):
    lead, k = x.shape[:-1], x.shape[-1]
    _check_layout(k, qw, scales, weight_dtype, group_size)
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        y = quant_matmul_ref(x2, qw, scales, weight_dtype)
    else:
        y = _quant_matmul_cuda(x2, qw, scales, weight_dtype, group_size)
    return y.reshape(*lead, qw.shape[1])


class QuantMatmulFunction(torch.autograd.Function):
    """y = x @ dequant(qw); the backward gives dx = g @ dequant(qw)^T (plain:
    the reference has no backward kernel) and nothing for the quantized
    storage."""

    @staticmethod
    def forward(ctx, x, qw, scales, weight_dtype, group_size):
        ctx.save_for_backward(qw, scales)
        ctx.weight_dtype = weight_dtype
        return _forward(x, qw, scales, weight_dtype, group_size)

    @staticmethod
    def backward(ctx, g):
        qw, scales = ctx.saved_tensors
        w = dequantize(qw, scales, ctx.weight_dtype, g.dtype)
        return torch.matmul(g, w.t()), None, None, None, None


def _check_layout(k, qw, scales, weight_dtype, group_size):
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be 'int8' or 'int4', got "
                         f"{weight_dtype!r}")
    rows = k // 2 if weight_dtype == "int4" else k
    if qw.dim() != 2 or qw.shape[0] != rows or qw.dtype != torch.int8 or \
            (weight_dtype == "int4" and k % 2):
        raise ValueError(f"quant_matmul: {weight_dtype} weight of in "
                         f"features {k} must be int8 [{rows}, n], got "
                         f"{qw.dtype} {tuple(qw.shape)}")
    n = qw.shape[1]
    if group_size not in GROUP_SIZES or (group_size > 0 and k % group_size):
        raise ValueError(f"quant_matmul: group_size {group_size} does not "
                         f"divide k={k} (take -1, 64 or 128)")
    want = (n,) if group_size == -1 else (k // group_size, n)
    if tuple(scales.shape) != want and not (
            group_size == -1 and tuple(scales.shape) == (1, n)):
        raise ValueError(f"quant_matmul: scales {tuple(scales.shape)}, "
                         f"expected {want} for group_size {group_size}")


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("quant_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.quant_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.quant_matmul.restype = ctypes.c_int
        lib.quant_matmul_blocks_per_sm.argtypes = [i, i]
        lib.quant_matmul_blocks_per_sm.restype = ctypes.c_int
        lib.quant_matmul_decode.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            p]
        lib.quant_matmul_decode.restype = ctypes.c_int
        lib.quant_matmul_prefill.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                             p]
        lib.quant_matmul_prefill.restype = ctypes.c_int
        _lib = lib
    return _lib


def prefill_schedule(m, k, n, sms):
    """The prefill kernel's walk for an [m, k] x [k, n] product on a card
    of `sms` SMs (`matmul.band_schedule` over 128 x 128 output tiles):
    `tiles_m` x `tiles_n` tiles, `grid` persistent blocks, `group_m` row
    tiles a band and `rounds`, the tiles over the grid (6.06 at m = 2512,
    n = 5120 on 132 SMs: the last round holds 8 tiles, a tail that is not
    split)."""
    return _mm.band_schedule(m, k, n, sms, PREFILL_TILE, PREFILL_TILE)


def prefill_tile(t, tiles_m, tiles_n, group_m):
    """(row tile, column tile) of the t-th tile of the prefill walk
    (`matmul.band_tile`)."""
    return _mm.band_tile(t, tiles_m, tiles_n, group_m)


def _splits(m, k, n, int4, dev):
    """k splits of the f32 split kernel's grid: at small m the n / 128
    column blocks alone leave most SMs idle, so split k until the blocks
    fill one wave (every block resident at once, no tail wave); 1 where the
    m and n blocks already fill it."""
    bm = 16 if m <= _SMALL_M else 64
    key = (dev, bm, int4)
    if key not in _slots:
        with torch.cuda.device(dev):
            per_sm = _kernel().quant_matmul_blocks_per_sm(m, int(int4))
        if per_sm < 1:
            raise RuntimeError(f"quant_matmul kernel cannot be resident "
                               f"(occupancy query returned {per_sm})")
        _slots[key] = per_sm * _mm.sm_count(dev)
    blocks = (n // _N_MULTIPLE) * -(-m // bm)
    return max(1, min(k // _K_MULTIPLE, _slots[key] // blocks))


def _quant_matmul_cuda(x, qw, scales, weight_dtype, group_size,
                       splits=None):
    """A kernel on [m, k] x: bf16 at m > 16 the prefill kernel, at m <= 16
    the decode kernel, f32 the split kernel. `splits` (measurement only;
    None sizes the split itself): the decode kernel cuts every column tile
    into that many equal k ranges of stages (a grid of tiles_n * splits
    blocks, `matmul.decode_schedule`); the f32 kernel's k split."""
    global launches
    dev = x.device
    for name, t in (("x", x), ("qw", qw), ("scales", scales)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"quant_matmul: {name} on {t.device}, x on "
                             f"{dev}; all must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_matmul kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"quant_matmul kernel takes float32 scales, got "
                        f"{scales.dtype}")
    m, k = x.shape
    n = qw.shape[1]
    if not supports(m, k, n, weight_dtype, group_size):
        raise ValueError(f"quant_matmul kernel does not take m={m} k={k} "
                         f"n={n} {weight_dtype} group_size={group_size}: "
                         f"see quant_matmul.supports")
    x = x.contiguous()
    if not (qw.is_contiguous() and scales.is_contiguous()):
        raise ValueError("quant_matmul kernel takes a contiguous weight and "
                         "scales")
    if any(t.data_ptr() % 16 for t in (x, qw, scales)):
        raise ValueError("quant_matmul kernel takes 16-byte aligned tensors")
    group_rows = k if group_size == -1 else group_size
    int4, bf16 = weight_dtype == "int4", x.dtype == torch.bfloat16
    out = torch.empty(m, n, dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _kernel()
    if bf16 and m > _SMALL_M:
        if splits is not None:
            raise ValueError("quant_matmul: the prefill kernel (bf16, "
                             "m > 16) takes no k split")
        sch = prefill_schedule(m, k, n, _mm.sm_count(dev))
        with torch.cuda.device(dev):
            rc = lib.quant_matmul_prefill(
                x.data_ptr(), qw.data_ptr(), scales.data_ptr(),
                out.data_ptr(), m, k, n, group_rows, int(int4), sch["grid"],
                sch["group_m"], stream)
        kind = "prefill"
    elif bf16:
        sch = _mm.decode_schedule(k, n, _mm.sm_count(dev), splits)
        part = torch.empty(_mm.decode_part_shape(sch, m),
                           dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.quant_matmul_decode(
                x.data_ptr(), qw.data_ptr(), scales.data_ptr(),
                out.data_ptr(), part.data_ptr(), m, k, n, group_rows,
                int(int4), sch["grid"], stream)
        kind = "decode"
    else:
        if splits is None:
            splits = _splits(m, k, n, int4, dev)
        elif not 1 <= splits <= k // _K_MULTIPLE:
            raise ValueError(f"quant_matmul: splits {splits} outside 1.."
                             f"{k // _K_MULTIPLE}")
        part = torch.empty(splits, m, n, dtype=torch.float32, device=dev) \
            if splits > 1 else None
        with torch.cuda.device(dev):
            rc = lib.quant_matmul(
                x.data_ptr(), qw.data_ptr(), scales.data_ptr(),
                out.data_ptr(), None if part is None else part.data_ptr(),
                m, k, n, group_rows, splits, int(int4), stream)
        kind = "split"
    if rc:
        raise RuntimeError(f"quant_matmul {kind} kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    kernel_launches[kind] += 1
    return out
