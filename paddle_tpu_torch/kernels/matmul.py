"""Dense matmul: the CUDA kernels `csrc/matmul.cu` and their plain PyTorch
version.

Counterpart of `paddle_tpu/kernels/matmul.py` (the Pallas body `_mm_kernel`,
launched by `_fused_call`): y [m, n] = x [m, k] @ w [k, n] in x's dtype,
summed in f32. The weight is Paddle's [in, out] layout.

- `matmul_ref` is the plain version (`torch.matmul`, the counterpart of
  `matmul_xla`).
- `matmul_fused` runs the plain version for CPU tensors and a kernel for
  CUDA tensors; a CUDA input the kernels do not take (`supports`) raises.
  `tile` names the kernel (`variants`, the tuner's candidates); None picks
  `default_variant`. `launches` counts the calls that launched a kernel,
  `variant_launches` the launches of each variant (`reset_launches`
  zeroes both).
- `MatmulFunction` makes it differentiable in both operands; its backward is
  the two transposed `torch.matmul`s, which the reference computes outside
  Pallas too (`_fused_bwd`).

The variants (`csrc/matmul.cu`):

- bf16 "128x256" and "128x128": the persistent TMA + wgmma kernel over
  128 x 256 or 128 x 128 output tiles, walked in the order `band_schedule`
  and `band_tile` give; the default at m > 16 (128x128 where n is not a
  multiple of 256).
- bf16 "skinny" (m <= 16): the one-launch streaming decode kernel, its
  split of the weight's stream from `decode_schedule`; the default at m <=
  16. bf16 "m16" (m <= 16): the 16-row WMMA kernel with a k split and a
  summing kernel.
- f32 "m16" and "m64": CUDA-core FMA with a k split (`_splits`).

`supports` takes every shape the reference's `supports` takes (k and n
multiples of 128) and more: k a multiple of 64, n of 128, any m >= 1 (the
kernels mask the m tail where the reference pads x by a copy).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._tiles import refuse_tiles

launches = 0
variant_launches: dict = {}  # variant -> launches

_K_MULTIPLE = 64   # the kernels' k tile (bf16; f32 takes 32)
_N_MULTIPLE = 128  # the narrowest n tile
_SMALL_M = 16      # the decode kernels' rows
_VARIANTS = {torch.bfloat16: ("skinny", "m16", "128x256", "128x128"),
             torch.float32: ("m16", "m64")}
# bf16: the variants for m <= 16 (the decode kernels) and for m > 16
_BY_M = {torch.bfloat16: (("skinny", "m16"), ("128x256", "128x128"))}
_SPLIT_ROWS = {"m16": 16, "m64": 64}  # the split kernels' row tiles
TILE_ROWS = 128  # the wgmma kernel's output rows
DECODE_TILE = 128  # the decode kernel's stage: 128 k rows of 128 columns
# the x band a persistent walk keeps in the 50 MB L2 while the weight
# columns stream past it
_BAND_BYTES = 24 << 20
_lib = None
_slots: dict = {}  # (device, row tile, bf16) -> blocks the card holds
_sms: dict = {}  # device -> its SM count


def reset_launches():
    global launches
    launches = 0
    variant_launches.clear()


def matmul_ref(x, w):
    """x @ w by `torch.matmul` (the plain counterpart of `matmul_xla`)."""
    return torch.matmul(x, w)


def variants(dtype, m=None):
    """The kernels for x's dtype (all of them, or those for m rows): bf16
    "skinny" and "m16" at m <= 16, "128x256" and "128x128" above; f32
    "m16" and "m64" at any m."""
    if m is None or dtype not in _BY_M:
        return _VARIANTS.get(dtype, ())
    return _BY_M[dtype][m > _SMALL_M]


def supports(m, k, n, block_n=None, block_k=None, *, dtype=torch.bfloat16):
    """Whether the kernels take this shape: m >= 1, k a multiple of 64, n a
    multiple of 128, float32 or bfloat16 operands of one `dtype` (keyword
    only). `block_n` / `block_k` are the reference's TPU tile sizes:
    None."""
    refuse_tiles("matmul.supports", block_n=block_n, block_k=block_k)
    return (m >= 1 and k > 0 and n > 0 and k % _K_MULTIPLE == 0
            and n % _N_MULTIPLE == 0 and dtype in _VARIANTS)


def default_variant(m, n, dtype=torch.bfloat16):
    """bf16: "skinny" at m <= 16, else "128x256" ("128x128" where n is not a
    multiple of 256); f32: "m16" at m <= 16, else "m64"."""
    if dtype != torch.bfloat16:
        return "m16" if m <= _SMALL_M else "m64"
    if m <= _SMALL_M:
        return "skinny"
    return "128x256" if n % 256 == 0 else "128x128"


def band_schedule(m, k, n, sms, bm=TILE_ROWS, bn=256):
    """A persistent kernel's walk over the bm x bn output tiles of an
    [m, k] x [k, n] product on a card of `sms` SMs: `tiles_m` x `tiles_n`
    tiles, `grid` blocks (one per SM, at most one per tile), `group_m`
    (the row tiles of one band: the x rows of a band, at most
    `_BAND_BYTES`, stay in L2 while every column tile of the band uses
    them; the bands made even) and `rounds`, the tiles over the grid."""
    tiles_m = -(-m // bm)
    tiles_n = -(-n // bn)
    tiles = tiles_m * tiles_n
    fit = max(1, _BAND_BYTES // (bm * k * 2))
    bands = -(-tiles_m // min(fit, tiles_m))
    return dict(tiles_m=tiles_m, tiles_n=tiles_n, grid=min(tiles, sms),
                group_m=-(-tiles_m // bands), rounds=tiles / min(tiles, sms))


def band_tile(t, tiles_m, tiles_n, group_m):
    """(row tile, column tile) of the t-th tile of a band walk: bands of
    group_m row tiles (the last band may be shorter), row tiles fastest
    within a band (the kernels' `sm90::tile_of`)."""
    band = t // (group_m * tiles_n)
    first = band * group_m
    rows = min(group_m, tiles_m - first)
    local = t - band * group_m * tiles_n
    return first + local % rows, local // rows


def decode_schedule(k, n, sms, splits=None):
    """The decode kernel's split of the weight: `tiles_n` column tiles of
    128 columns, `kt` stages of 128 k rows each (the last one half empty
    where k % 128 == 64), `units` = tiles_n * kt, and `grid` blocks. By
    default the largest multiple of tiles_n that the SMs hold, so that
    every column tile is cut into the same number of equal k ranges and
    the blocks of one range read the same weight rows at once; one block
    per SM, each a contiguous run of units, where the column tiles
    outnumber the SMs. With `splits`, tiles_n * splits. Block b walks
    units [b * units // grid, (b + 1) * units // grid)
    (`decode_segments`)."""
    kt = -(-k // DECODE_TILE)
    tiles_n = n // DECODE_TILE
    units = tiles_n * kt
    if splits is None:
        grid = tiles_n * min(sms // tiles_n, kt) if tiles_n <= sms \
            else min(sms, units)
    elif not 1 <= splits <= kt:
        raise ValueError(f"splits {splits} outside 1..{kt} (stages of "
                         f"{DECODE_TILE} k rows)")
    else:
        grid = tiles_n * splits
    return dict(kt=kt, tiles_n=tiles_n, units=units, grid=grid)


def decode_part_shape(sch, m):
    """The decode kernel's f32 scratch for m rows: a slot per segment that
    shares its column tile, at most grid + tiles_n."""
    return sch["grid"] + sch["tiles_n"], 1024 if m <= 8 else 2048


def decode_owner(u, units, grid):
    """The block whose range holds unit u (the kernel's `skinny::owner`)."""
    return ((u + 1) * grid - 1) // units


def decode_segments(sch):
    """The decode kernel's segments in the order the blocks walk them:
    (block, column tile, first stage, end stage, partial slot or None).
    A column tile covered by one block is written at once (slot None);
    otherwise each segment goes to slot block + tile, and the last block
    to take the tile's ticket adds the slots in block order."""
    kt, units, grid = sch["kt"], sch["units"], sch["grid"]
    out = []
    for b in range(grid):
        u, end = b * units // grid, (b + 1) * units // grid
        while u < end:
            c = u // kt
            stop = min(end, (c + 1) * kt)
            whole = decode_owner(c * kt, units, grid) == \
                decode_owner((c + 1) * kt - 1, units, grid)
            out.append((b, c, u - c * kt, stop - c * kt,
                        None if whole else b + c))
            u = stop
    return out


def matmul_fused(x, w, block_n=None, block_k=None, *, tile=None):
    """x [..., k] @ w [k, n] -> [..., n] in x's dtype, by a kernel on CUDA
    (raising on what it does not take) and by `matmul_ref` on the CPU.
    Differentiable in x and w. `block_n` / `block_k` are the reference's
    TPU tile sizes: None; `tile` (keyword only) names one of the kernels'
    variants (`variants`), None for the default."""
    refuse_tiles("matmul_fused", block_n=block_n, block_k=block_k)
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
        lib.matmul_wgmma.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.matmul_wgmma.restype = ctypes.c_int
        lib.matmul_decode.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.matmul_decode.restype = ctypes.c_int
        _lib = lib
    return _lib


def sm_count(dev):
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev) \
            .multi_processor_count
    return _sms[dev]


def _splits(m, k, n, tile, bf16, dev):
    """k splits of a split kernel's grid: at small m the n / 128 column
    blocks alone leave most SMs idle, so k is split until the blocks fill
    one wave of resident blocks; 1 where the m and n blocks already do."""
    key = (dev, tile, bf16)
    if key not in _slots:
        with torch.cuda.device(dev):
            per_sm = _kernel().matmul_blocks_per_sm(tile, int(bf16))
        if per_sm < 1:
            raise RuntimeError(f"matmul kernel cannot be resident "
                               f"(occupancy query returned {per_sm})")
        _slots[key] = per_sm * sm_count(dev)
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
    if x.dtype != w.dtype or x.dtype not in _VARIANTS:
        raise TypeError(f"matmul kernel takes float32 or bfloat16 x and w "
                        f"of one dtype, got {x.dtype} and {w.dtype}")
    m, k = x.shape
    n = w.shape[1]
    if not supports(m, k, n, dtype=x.dtype):
        raise ValueError(f"matmul kernel does not take m={m} k={k} n={n}: "
                         f"see matmul.supports")
    if tile is None:
        tile = default_variant(m, n, x.dtype)
    if tile not in variants(x.dtype, m):
        raise ValueError(f"matmul kernel has variants "
                         f"{variants(x.dtype, m)} for {x.dtype} at m={m}, "
                         f"not {tile!r}")
    x = x.contiguous()
    if not w.is_contiguous():
        raise ValueError("matmul kernel takes a contiguous weight")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("matmul kernel takes 16-byte aligned x and w")
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty(m, n, dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if tile in ("128x256", "128x128"):
            bn = int(tile.split("x")[1])
            sch = band_schedule(m, k, n, sm_count(dev), TILE_ROWS, bn)
            rc = _kernel().matmul_wgmma(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, bn,
                sch["grid"], sch["group_m"], stream)
        elif tile == "skinny":
            sch = decode_schedule(k, n, sm_count(dev))
            part = torch.empty(decode_part_shape(sch, m),
                               dtype=torch.float32, device=dev)
            rc = _kernel().matmul_decode(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(),
                m, k, n, sch["grid"], stream)
        else:
            rows = _SPLIT_ROWS[tile]
            splits = _splits(m, k, n, rows, bf16, dev)
            part = torch.empty(splits, m, n, dtype=torch.float32,
                               device=dev) if splits > 1 else None
            rc = _kernel().matmul(
                x.data_ptr(), w.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(), m, k, n, rows,
                splits, int(bf16), stream)
    if rc:
        raise RuntimeError(f"matmul kernel ({tile}) launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    variant_launches[tile] = variant_launches.get(tile, 0) + 1
    return out
