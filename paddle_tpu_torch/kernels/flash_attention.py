"""Flash attention: the CUDA kernels `csrc/flash_attention*.cu` (forward,
dK/dV, dQ, each in four bodies) and their plain PyTorch versions.

Counterpart of `paddle_tpu/kernels/flash_attention.py`: `_flash_fwd`,
`_run_dkv_pass` and `_run_dq_pass` with their plain, segment-id (`_seg`),
dropout (`_drop`) and combined (`_seg_drop`) bodies, the custom VJPs over
[b*h, s, d] (`FlashAttentionFunction`, `FlashAttentionLseFunction`), and
the entry points `flash_attention_bshd`, `flash_attention_with_lse_bshd`
and `flash_attn_unpadded`.

- `Variant` carries what the seg and drop bodies read besides q, k, v:
  segment ids [b, s] int32 (row bh of [b*h, s, d] reads batch bh // heads;
  the reference's [b, 8, s] replication is a TPU tiling rule), and the
  dropout rate and int32 seed. `None` is the plain body.
- `threefry2x32` and `dropout_keep` are the reference's counter-based mask
  (`_threefry2x32`, `_dropout_keep`), bit for bit: keys (seed, b*h),
  counters the global (query, key) positions, so the mask does not depend
  on any tiling; the low 23 bits times 2^-23 are kept when >= rate.
- `flash_fwd_ref`, `flash_bwd_dkv_ref`, `flash_bwd_dq_ref` are the plain
  versions, in f32 over the whole [s_q, s_kv] score matrix (the forward
  follows `_xla_ref_fwd`, the backward and the dropout the Pallas kernels'
  math: the forward's lse sums the undropped p, P V and dV take the dropped
  p times 1 / (1 - rate), dS the undropped p against the dropped, scaled
  dP).
- `flash_fwd`, `flash_bwd_dkv`, `flash_bwd_dq` run the plain version for
  CPU tensors and the kernel for CUDA tensors; a CUDA input the kernel does
  not take raises. `fwd_launches`, `dkv_launches`, `dq_launches` count the
  kernels' launches, and `variant_launches[(pass, variant)]` the launches of
  each body.

Causal masking is bottom-right aligned (query i sees key j when
i + s_kv - s_q >= j); a masked score is the finite NEG_INF and its
probability is zeroed by the mask, so a fully masked row (causal,
s_q > s_kv, or a query whose segment has no key) gives output 0 and lse
-1e30.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as TF

from . import _build

NEG_INF = -1e30  # the TPU kernel's masked-score value

PASSES = ("fwd", "dkv", "dq")
VARIANTS = ("plain", "seg", "drop", "seg_drop")
fwd_launches = 0
dkv_launches = 0
dq_launches = 0
variant_launches = {(p, v): 0 for p in PASSES for v in VARIANTS}

HEAD_DIM = 128  # the kernels' head_dim
BLOCK = 128  # the sequence multiple `supports` asks for (the reference's)
_TILE = 64  # the kernels' own tile: what the CUDA wrappers ask for
# each variant's library: flash_attention.cu built with its macros
_LIBS = {"plain": "flash_attention", "seg": "flash_attention_seg",
         "drop": "flash_attention_drop",
         "seg_drop": "flash_attention_seg_drop"}
_libs: dict = {}


def reset_launches():
    """Set every launch count to 0."""
    global fwd_launches, dkv_launches, dq_launches
    fwd_launches = dkv_launches = dq_launches = 0
    for key in variant_launches:
        variant_launches[key] = 0


def supports(seq_q, seq_kv, head_dim, dtype=torch.float32):
    """Whether `flash_attention_bshd` takes this shape: sequence lengths
    multiples of 128 (the reference's blocks), head_dim 128 (the kernels'
    only width; the reference takes any multiple of 128), float32 or
    bfloat16."""
    return (seq_q % BLOCK == 0 and seq_kv % BLOCK == 0 and seq_q >= BLOCK
            and seq_kv >= BLOCK and head_dim == HEAD_DIM
            and dtype in (torch.float32, torch.bfloat16))


# ---------------------------------------------------------------------------
# the dropout mask (`_threefry2x32`, `_dropout_keep`)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x):
    """int64 tensor of the uint32 value of x (an int or an integer tensor)."""
    return torch.as_tensor(x, dtype=torch.int64) & _M32


def _rotl(x, r):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """The first output word of 20-round threefry2x32 on keys (k0, k1) and
    counters (c0, c1), broadcast together: an int64 tensor holding uint32
    values. uint32 arithmetic (in int64, masked), which the reference's
    wrapping int32 lanes equal bit for bit."""
    k0, k1, c0, c1 = map(_u32, (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for blk in range(5):
        for r in _ROTATIONS[blk % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(blk + 1) % 3]) & _M32
        x1 = (x1 + ks[(blk + 2) % 3] + blk + 1) & _M32
    return x0


def dropout_keep(seed, bh, rows, cols, rate):
    """Boolean keep mask of the (rows, cols) pairs of batch-head row bh
    (ints or integer tensors, broadcast together): the low 23 bits of
    threefry2x32((seed, bh), (row, col)) times 2^-23, kept when >= the f32
    rate."""
    bits = threefry2x32(seed, bh, rows, cols)
    u = (bits & 0x7FFFFF).to(torch.float32) * (1.0 / (1 << 23))
    return u >= torch.tensor(rate, dtype=torch.float32)


def dropout_mask(seed, bh, s_q, s_kv, rate, device=None):
    """The keep mask [bh, s_q, s_kv] of a whole attention call."""
    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    return dropout_keep(seed, ar(bh)[:, None, None], ar(s_q)[None, :, None],
                        ar(s_kv)[None, None, :], rate)


class Variant:
    """What the seg and drop bodies read besides q, k, v.

    seg_q [b, s_q] and seg_k [b, s_kv] int32 segment ids (or None), with
    b * heads rows of q; rate in [0, 1) and an int seed, whose 32 bits key
    the mask. `keep` ([bh, s_q, s_kv] bool) replaces the mask the plain
    versions regenerate from the seed (the kernels always regenerate it)."""

    def __init__(self, seg_q=None, seg_k=None, heads=1, rate=0.0, seed=0,
                 keep=None):
        if (seg_q is None) != (seg_k is None):
            raise ValueError("segment ids need both seg_q and seg_k")
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} is not in [0, 1)")
        self.seg_q, self.seg_k = seg_q, seg_k
        self.heads = int(heads)
        self.rate, self.seed, self.keep = float(rate), int(seed), keep
        self._ranges = None

    @property
    def name(self):
        seg, drop = self.seg_q is not None, self.rate > 0.0
        return {(False, False): "plain", (True, False): "seg",
                (False, True): "drop", (True, True): "seg_drop"}[(seg, drop)]

    @property
    def inv(self):
        return 1.0 / (1.0 - self.rate)

    def keep_mask(self, bh, s_q, s_kv, device):
        if self.keep is not None:
            return self.keep
        return dropout_mask(self.seed, bh, s_q, s_kv, self.rate, device)

    def ranges(self):
        """(min, max) id of each kernel tile: int32 [b, s / 64, 2] for q and
        for k, computed once."""
        if self._ranges is None:
            def rng(seg):
                t = seg.reshape(seg.shape[0], -1, _TILE)
                return torch.stack([t.amin(-1), t.amax(-1)], -1) \
                    .to(torch.int32).contiguous()

            self._ranges = (rng(self.seg_q), rng(self.seg_k))
        return self._ranges


def variant_name(var):
    return "plain" if var is None else var.name


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _causal_mask(s_q, s_kv, device):
    q_pos = torch.arange(s_q, device=device)[:, None]
    k_pos = torch.arange(s_kv, device=device)[None, :]
    return q_pos + (s_kv - s_q) >= k_pos


def _mask(q, k, causal, var):
    """bool [1 or bh, s_q, s_kv] of the pairs attention computes (the
    causal mask and segment equality), or None for all of them."""
    mask = _causal_mask(q.shape[1], k.shape[1], q.device)[None] \
        if causal else None
    if var is not None and var.seg_q is not None:
        sq = var.seg_q.to(q.device).repeat_interleave(var.heads, dim=0)
        sk = var.seg_k.to(q.device).repeat_interleave(var.heads, dim=0)
        seg = sq[:, :, None] == sk[:, None, :]
        mask = seg if mask is None else mask & seg
    return mask


def _keep(q, k, var):
    """The dropout keep mask, or None without dropout."""
    if var is None or var.rate == 0.0:
        return None
    return var.keep_mask(q.shape[0], q.shape[1], k.shape[1], q.device)


def _scores(q, k, scale, mask):
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    return s if mask is None else s.masked_fill(~mask, NEG_INF)


def _probs(q, k, lse, scale, mask):
    """p = exp(s - lse), zeroed where masked (a fully masked row has
    lse == NEG_INF and exp(s - lse) == 1 before the mask)."""
    p = torch.exp(_scores(q, k, scale, mask) - lse[..., None])
    return p if mask is None else p.masked_fill(~mask, 0.0)


def flash_fwd_ref(q, k, v, scale, causal, var=None):
    """q [bh, s_q, d], k/v [bh, s_kv, d] -> (out [bh, s_q, d] in q.dtype,
    lse [bh, s_q] f32). As `_xla_ref_fwd`: f32 scores, p rounded to the
    input dtype before the f32 product with v; with dropout, the lse of
    the undropped scores and the dropped p times 1 / (1 - rate)."""
    mask = _mask(q, k, causal, var)
    s = _scores(q, k, scale, mask)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    keep = _keep(q, k, var)
    if keep is not None:
        p = torch.where(keep, p, 0.0) * var.inv
    out = torch.einsum("bqk,bkd->bqd", p.to(q.dtype).float(), v.float())
    return out.to(q.dtype), lse


def flash_bwd_delta(out, do):
    """delta = rowsum(dO * O) in f32 ([bh, s_q]), the backward's prologue
    (`_bwd_delta`)."""
    return (do.float() * out.float()).sum(dim=-1)


def _grad_terms(q, k, v, do, lse, scale, causal, var):
    """(p, p_d, dp): p undropped, p_d the weights of dV (dropped and scaled
    with dropout, else p), dp = dO v^T (dropped and scaled with dropout)."""
    p = _probs(q, k, lse, scale, _mask(q, k, causal, var))
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    keep = _keep(q, k, var)
    if keep is None:
        return p, p, dp
    return (p, torch.where(keep, p, 0.0) * var.inv,
            torch.where(keep, dp, 0.0) * var.inv)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale, causal, var=None):
    """(dk, dv) in k's / v's dtype: dv = p_d^T dO, dk = ds^T q with
    ds = p * (dp - delta) * scale; f32 arithmetic."""
    p, p_d, dp = _grad_terms(q, k, v, do, lse, scale, causal, var)
    dv = torch.einsum("bqk,bqd->bkd", p_d, do.float())
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, scale, causal, var=None):
    """dq = ds k in q's dtype (ds as in `flash_bwd_dkv_ref`)."""
    p, _, dp = _grad_terms(q, k, v, do, lse, scale, causal, var)
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# dispatch: plain version on the CPU, kernel on CUDA
# ---------------------------------------------------------------------------


def flash_fwd(q, k, v, scale, causal, var=None):
    """(out, lse) of attention over [bh, s, d]; see `flash_fwd_ref`."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, scale, causal, var)
    return _fwd_cuda(q, k, v, scale, causal, var)


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, var=None):
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale, causal, var)
    return _dkv_cuda(q, k, v, do, lse, delta, scale, causal, var)


def flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, var=None):
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, scale, causal, var)
    return _dq_cuda(q, k, v, do, lse, delta, scale, causal, var)


def _backward(q, k, v, out, lse, dout, scale, causal, var, d_lse=None):
    """(dq, dk, dv): delta = rowsum(dO * O), less the lse cotangent where
    there is one (`_bwd_delta`), then the dK/dV and dQ passes."""
    do = dout.contiguous()
    delta = flash_bwd_delta(out, do)
    if d_lse is not None:
        delta = delta - d_lse.float()
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, var)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, var)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable attention over q [bh, s_q, d], k/v [bh, s_kv, d]
    (contiguous), with a `Variant` (segment ids, heads, dropout seed and
    rate) or None: the forward saves (q, k, v, out, lse), the backward
    takes delta = rowsum(dO * O) and runs the dK/dV and dQ passes of the
    same body, which regenerate the forward's dropout mask."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, var=None):
        out, lse = flash_fwd(q, k, v, scale, causal, var)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.var = scale, causal, var
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout, ctx.scale,
                               ctx.causal, ctx.var)
        return dq, dk, dv, None, None, None


class FlashAttentionLseFunction(torch.autograd.Function):
    """(out, lse) over [bh, s, d] through the plain bodies, both
    differentiable: the lse cotangent folds into delta
    (delta - d_lse, `_bwd_delta`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out, lse

    @staticmethod
    def backward(ctx, dout, d_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout, ctx.scale,
                               ctx.causal, None, d_lse)
        return dq, dk, dv, None, None


def _check_shape(q, k):
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    if not supports(s_q, s_kv, d, q.dtype):
        raise ValueError(
            f"flash_attention: unsupported shape seq_q={s_q} seq_kv={s_kv} "
            f"d={d} dtype={q.dtype} (need multiples of {BLOCK}, d "
            f"{HEAD_DIM}, float32 or bfloat16)")
    return b, s_q, h, d, s_kv


def _bhsd(t):
    b, s, h, d = t.shape
    return t.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _seg_ids(ids, b, s, dev, name):
    ids = torch.as_tensor(ids, device=dev).to(torch.int32).contiguous()
    if ids.shape != (b, s):
        raise ValueError(f"flash_attention: {name} {tuple(ids.shape)} is "
                         f"not [batch, seq] = {[b, s]}")
    return ids


def flash_attention_bshd(q, k, v, causal=False, scale=None,
                         segment_ids_q=None, segment_ids_k=None,
                         dropout=0.0, dropout_seed=None):
    """q [batch, s_q, heads, d], k/v [batch, s_kv, heads, d] (Paddle layout)
    -> [batch, s_q, heads, d]; differentiable.

    segment_ids_q / segment_ids_k ([batch, seq], int32) restrict attention
    to pairs with equal ids (packed sequences). dropout > 0 drops the
    softmax weights in the kernels with the threefry mask keyed by
    `dropout_seed`, an int whose 32 bits are used (drawn on the host, so
    passing it never waits on the device): the same seed gives the same
    mask. Raises ValueError for a shape `supports` refuses and for dropout
    without a seed."""
    b, s_q, h, d, s_kv = _check_shape(q, k)
    if dropout and dropout_seed is None:
        raise ValueError("flash_attention: dropout requires dropout_seed")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    var = None
    if segment_ids_q is not None or segment_ids_k is not None or dropout:
        seg_q = seg_k = None
        if segment_ids_q is not None or segment_ids_k is not None:
            if segment_ids_q is None or segment_ids_k is None:
                raise ValueError("flash_attention: segment ids need both "
                                 "segment_ids_q and segment_ids_k")
            seg_q = _seg_ids(segment_ids_q, b, s_q, q.device,
                             "segment_ids_q")
            seg_k = _seg_ids(segment_ids_k, b, s_kv, q.device,
                             "segment_ids_k")
        var = Variant(seg_q, seg_k, heads=h, rate=float(dropout),
                      seed=int(dropout_seed) if dropout else 0)
    out = FlashAttentionFunction.apply(_bhsd(q), _bhsd(k), _bhsd(v),
                                       float(scale), bool(causal), var)
    return out.reshape(b, h, s_q, d).transpose(1, 2)


def flash_attention_with_lse_bshd(q, k, v, causal=False, scale=None):
    """Like `flash_attention_bshd` (plain bodies), also returning the row
    logsumexp [batch, heads, s_q] f32, the merge statistic of ring
    attention; both outputs are differentiable."""
    b, s_q, h, d, _ = _check_shape(q, k)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out, lse = FlashAttentionLseFunction.apply(
        _bhsd(q), _bhsd(k), _bhsd(v), float(scale), bool(causal))
    return (out.reshape(b, h, s_q, d).transpose(1, 2),
            lse.reshape(b, h, s_q))


def _pad_rows(t, n):
    return TF.pad(t, (0, 0, 0, 0, 0, n - t.shape[0]))


def _segments(cu, total, padded, pad_id):
    """Each of `padded` token positions -> the index of its sequence under
    the prefix sums `cu`, and `pad_id` from `total` on."""
    pos = torch.arange(padded, device=cu.device)
    seg = torch.searchsorted(cu[1:], pos, right=True)
    return torch.where(pos < total, seg, pad_id).to(torch.int32)


def flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                        max_seqlen_k, scale=None, dropout=0.0, causal=False,
                        return_softmax=False, dropout_seed=None):
    """Varlen attention over packed sequences (`flash_attn_unpadded`):
    q [total_q, heads, d], k/v [total_k, heads, d], cu_seqlens_* the
    [n_seqs + 1] prefix sums. Returns ([total_q, heads, d], None).

    The packed stream runs as one batch-1 call with per-token segment ids
    (the seg or seg_drop bodies), each stream padded to a multiple of 128
    (under causal to a common length, so that the bottom-right causal
    diagonal stays aligned); padded queries take id -1, padded keys -2, so
    they meet nothing. causal=True needs cu_seqlens_q == cu_seqlens_k
    (checked: it reads the prefix sums). max_seqlen_* are not used."""
    if dropout and dropout_seed is None:
        raise ValueError("flash_attn_unpadded: dropout requires "
                         "dropout_seed")
    total_q, _, _ = q.shape
    total_k = k.shape[0]
    cu_q = torch.as_tensor(cu_seqlens_q, device=q.device).long()
    cu_k = torch.as_tensor(cu_seqlens_k, device=q.device).long()
    if causal:
        if cu_q.shape != cu_k.shape:
            raise ValueError(
                "flash_attn_unpadded(causal=True) needs matching q/k packing")
        if not torch.equal(cu_q, cu_k):
            raise ValueError(
                "flash_attn_unpadded(causal=True) needs cu_seqlens_q == "
                "cu_seqlens_k (global causal positions must align per "
                "sequence)")
    pad_q = -(-total_q // BLOCK) * BLOCK
    pad_k = -(-total_k // BLOCK) * BLOCK
    if causal:
        pad_q = pad_k = max(pad_q, pad_k)
    out = flash_attention_bshd(
        _pad_rows(q, pad_q)[None], _pad_rows(k, pad_k)[None],
        _pad_rows(v, pad_k)[None], causal=causal, scale=scale,
        segment_ids_q=_segments(cu_q, total_q, pad_q, -1)[None],
        segment_ids_k=_segments(cu_k, total_k, pad_k, -2)[None],
        dropout=dropout, dropout_seed=dropout_seed)
    return out[0, :total_q], None


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# after each entry's own tensors: seg_q, seg_k, rng_q, rng_k, bh, s_q, s_kv,
# head_dim, heads, scale, causal, seed, rate, inv, is_bf16, stream
_VARIANT_ARGS = [_P] * 4 + [_I] * 5 + [_F, _I, _I, _F, _F, _I, _P]


def _kernels(name):
    """The loaded library of variant `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(_LIBS[name])
        lib.flash_fwd.argtypes = [_P] * 5 + _VARIANT_ARGS
        lib.flash_bwd_dkv.argtypes = [_P] * 8 + _VARIANT_ARGS
        lib.flash_bwd_dq.argtypes = [_P] * 7 + _VARIANT_ARGS
        for fn in (lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq):
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _check(name, q, k, v, do=None, lse=None, delta=None, var=None):
    """Validate the kernels' contract; returns (bh, s_q, s_kv, d)."""
    dev = q.device
    tensors = dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    if var is not None and var.seg_q is not None:
        tensors.update(seg_q=var.seg_q, seg_k=var.seg_k)
    tensors = {n: t for n, t in tensors.items() if t is not None}
    for n, t in tensors.items():
        if dev.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: {n} on {t.device}, q on {dev}; all "
                             "must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel takes 16-byte aligned tensors")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in (k, v) + (() if do is None else
                                                  (do,))):
        raise TypeError(f"{name} kernel takes float32 or bfloat16 q, k, v"
                        f"{'' if do is None else ', dO'} of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not [bh, s, d] alike")
    bh, s_q, d = q.shape
    s_kv = k.shape[1]
    if d != HEAD_DIM or s_q % _TILE or s_kv % _TILE or not s_q or not s_kv:
        raise ValueError(f"{name} kernel takes head_dim {HEAD_DIM} and "
                         f"sequence lengths that are non-zero multiples of "
                         f"{_TILE}, got s_q={s_q} s_kv={s_kv} d={d}")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"{name}: dO {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    for n, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32
                              or t.shape != (bh, s_q)):
            raise ValueError(f"{name}: {n} must be float32 [bh, s_q] = "
                             f"{[bh, s_q]}, got {t.dtype} {tuple(t.shape)}")
    if var is not None:
        if var.keep is not None:
            raise ValueError(f"{name}: the kernels regenerate the dropout "
                             "mask from the seed; `keep` is for the plain "
                             "versions")
        if var.seg_q is not None:
            b = bh // var.heads if var.heads > 0 else 0
            if b * var.heads != bh or var.seg_q.shape != (b, s_q) or \
                    var.seg_k.shape != (b, s_kv) or \
                    var.seg_q.dtype != torch.int32 or \
                    var.seg_k.dtype != torch.int32:
                raise ValueError(
                    f"{name}: segment ids {tuple(var.seg_q.shape)} / "
                    f"{tuple(var.seg_k.shape)} ({var.seg_q.dtype}) are not "
                    f"int32 [b, s_q] / [b, s_kv] with b * {var.heads} heads "
                    f"= {bh}")
    return bh, s_q, s_kv, d


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _variant_args(var, bh, s_q, s_kv, d, scale, causal, is_bf16, dev):
    """The entry points' arguments after their own tensors (and the
    tensors they point into, to keep alive over the launch)."""
    if var is None:
        var = Variant()
    ptrs, alive = [None] * 4, ()
    if var.seg_q is not None:
        rng_q, rng_k = var.ranges()
        alive = (var.seg_q, var.seg_k, rng_q, rng_k)
        ptrs = [t.data_ptr() for t in alive]
    seed = (var.seed + 2 ** 31) % 2 ** 32 - 2 ** 31  # its 32 bits, as int32
    return alive, ptrs + [bh, s_q, s_kv, d, var.heads, float(scale),
                         int(causal), seed, var.rate,
                         var.inv if var.rate else 1.0, int(is_bf16),
                         _stream(dev)]


def _launch(fn_name, pass_, var, tensors, bh, s_q, s_kv, d, scale, causal,
            q):
    global fwd_launches, dkv_launches, dq_launches
    name = variant_name(var)
    fn = getattr(_kernels(name), fn_name)
    _alive, args = _variant_args(var, bh, s_q, s_kv, d, scale, causal,
                                q.dtype == torch.bfloat16, q.device)
    with torch.cuda.device(q.device):
        rc = fn(*[t.data_ptr() for t in tensors], *args)
    if rc:
        raise RuntimeError(f"{fn_name} ({name}) kernel launch failed: CUDA "
                           f"error {rc}")
    variant_launches[(pass_, name)] += 1
    if pass_ == "fwd":
        fwd_launches += 1
    elif pass_ == "dkv":
        dkv_launches += 1
    else:
        dq_launches += 1


def _fwd_cuda(q, k, v, scale, causal, var=None):
    bh, s_q, s_kv, d = _check("flash_fwd", q, k, v, var=var)
    out = torch.empty_like(q)
    lse = torch.empty(bh, s_q, dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "fwd", var, (q, k, v, out, lse), bh, s_q, s_kv, d,
            scale, causal, q)
    return out, lse


def _dkv_cuda(q, k, v, do, lse, delta, scale, causal, var=None):
    bh, s_q, s_kv, d = _check("flash_bwd_dkv", q, k, v, do, lse, delta, var)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", "dkv", var, (q, k, v, do, lse, delta, dk, dv),
            bh, s_q, s_kv, d, scale, causal, q)
    return dk, dv


def _dq_cuda(q, k, v, do, lse, delta, scale, causal, var=None):
    bh, s_q, s_kv, d = _check("flash_bwd_dq", q, k, v, do, lse, delta, var)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", "dq", var, (q, k, v, do, lse, delta, dq), bh,
            s_q, s_kv, d, scale, causal, q)
    return dq
