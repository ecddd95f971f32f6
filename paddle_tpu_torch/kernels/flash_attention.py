"""Flash attention: the CUDA kernels `csrc/flash_attention.cu` (forward,
dK/dV, dQ) and their plain PyTorch versions.

Counterpart of `paddle_tpu/kernels/flash_attention.py`, its plain path (no
segment ids, no dropout, no differentiable lse): `_flash_fwd`,
`_run_dkv_pass` and `_run_dq_pass`, the custom VJP over [b*h, s, d]
(`FlashAttentionFunction`) and `flash_attention_bshd`.

- `flash_fwd_ref`, `flash_bwd_dkv_ref`, `flash_bwd_dq_ref` are the plain
  versions, in f32 over the whole [s_q, s_kv] score matrix (the forward
  follows `_xla_ref_fwd`, the backward the Pallas kernels' math).
- `flash_fwd`, `flash_bwd_dkv`, `flash_bwd_dq` run the plain version for
  CPU tensors and the kernel for CUDA tensors; a CUDA input the kernel does
  not take raises. `fwd_launches`, `dkv_launches`, `dq_launches` count the
  kernels' launches.

Causal masking is bottom-right aligned (query i sees key j when
i + s_kv - s_q >= j); a masked score is the finite NEG_INF and its
probability is zeroed by the mask, so a fully masked row (causal,
s_q > s_kv) gives output 0 and lse -1e30.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30  # the TPU kernel's masked-score value

fwd_launches = 0
dkv_launches = 0
dq_launches = 0

HEAD_DIM = 128  # the kernels' head_dim
BLOCK = 128  # the sequence multiple `supports` asks for (the reference's)
_TILE = 64  # the kernels' own tile: what the CUDA wrappers ask for
_lib = None


def supports(seq_q, seq_kv, head_dim, dtype=torch.float32):
    """Whether `flash_attention_bshd` takes this shape: sequence lengths
    multiples of 128 (the reference's blocks), head_dim 128 (the kernels'
    only width; the reference takes any multiple of 128), float32 or
    bfloat16."""
    return (seq_q % BLOCK == 0 and seq_kv % BLOCK == 0 and seq_q >= BLOCK
            and seq_kv >= BLOCK and head_dim == HEAD_DIM
            and dtype in (torch.float32, torch.bfloat16))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _causal_mask(s_q, s_kv, device):
    q_pos = torch.arange(s_q, device=device)[:, None]
    k_pos = torch.arange(s_kv, device=device)[None, :]
    return q_pos + (s_kv - s_q) >= k_pos


def _scores(q, k, scale, causal):
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    mask = _causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    return s, mask


def _probs(q, k, lse, scale, causal):
    """p = exp(s - lse), zeroed where masked (a fully masked row has
    lse == NEG_INF and exp(s - lse) == 1 before the mask)."""
    s, mask = _scores(q, k, scale, causal)
    p = torch.exp(s - lse[..., None])
    return p if mask is None else p.masked_fill(~mask, 0.0)


def flash_fwd_ref(q, k, v, scale, causal):
    """q [bh, s_q, d], k/v [bh, s_kv, d] -> (out [bh, s_q, d] in q.dtype,
    lse [bh, s_q] f32). As `_xla_ref_fwd`: f32 scores, p rounded to the
    input dtype before the f32 product with v."""
    s, mask = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    out = torch.einsum("bqk,bkd->bqd", p.to(q.dtype).float(), v.float())
    return out.to(q.dtype), lse


def flash_bwd_delta(out, do):
    """delta = rowsum(dO * O) in f32 ([bh, s_q]), the backward's prologue
    (`_bwd_delta`)."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale, causal):
    """(dk, dv) in k's / v's dtype: dv = p^T dO, dk = ds^T q with
    ds = p * (dO v^T - delta) * scale; f32 arithmetic."""
    p = _probs(q, k, lse, scale, causal)
    dof = do.float()
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, scale, causal):
    """dq = ds k in q's dtype (ds as in `flash_bwd_dkv_ref`)."""
    p = _probs(q, k, lse, scale, causal)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# dispatch: plain version on the CPU, kernel on CUDA
# ---------------------------------------------------------------------------


def flash_fwd(q, k, v, scale, causal):
    """(out, lse) of attention over [bh, s, d]; see `flash_fwd_ref`."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, scale, causal)
    return _fwd_cuda(q, k, v, scale, causal)


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal):
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale, causal)
    return _dkv_cuda(q, k, v, do, lse, delta, scale, causal)


def flash_bwd_dq(q, k, v, do, lse, delta, scale, causal):
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, scale, causal)
    return _dq_cuda(q, k, v, do, lse, delta, scale, causal)


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable attention over q [bh, s_q, d], k/v [bh, s_kv, d]
    (contiguous): the forward saves (q, k, v, out, lse), the backward takes
    delta = rowsum(dO * O) and runs the dK/dV and dQ passes."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        do = dout.contiguous()
        delta = flash_bwd_delta(out, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.scale,
                               ctx.causal)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """q [batch, s_q, heads, d], k/v [batch, s_kv, heads, d] (Paddle layout)
    -> [batch, s_q, heads, d]; differentiable. Raises ValueError for a shape
    `supports` refuses."""
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    if not supports(s_q, s_kv, d, q.dtype):
        raise ValueError(
            f"flash_attention: unsupported shape seq_q={s_q} seq_kv={s_kv} "
            f"d={d} dtype={q.dtype} (need multiples of {BLOCK}, d "
            f"{HEAD_DIM}, float32 or bfloat16)")
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    def bhsd(t):
        return t.transpose(1, 2).reshape(b * h, t.shape[1], d).contiguous()

    out = FlashAttentionFunction.apply(bhsd(q), bhsd(k), bhsd(v),
                                       float(scale), bool(causal))
    return out.reshape(b, h, s_q, d).transpose(1, 2)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, i, i, p]
        lib.flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f,
                                      i, i, p]
        lib.flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, i,
                                     i, p]
        for fn in (lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, q, k, v, do=None, lse=None, delta=None):
    """Validate the kernels' contract; returns (bh, s_q, s_kv, d)."""
    dev = q.device
    tensors = dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
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
    return bh, s_q, s_kv, d


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _fwd_cuda(q, k, v, scale, causal):
    global fwd_launches
    bh, s_q, s_kv, d = _check("flash_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(bh, s_q, dtype=torch.float32, device=q.device)
    fn = _kernels().flash_fwd
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), bh, s_q, s_kv, d, float(scale), int(causal),
                int(q.dtype == torch.bfloat16), _stream(q.device))
    if rc:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    fwd_launches += 1
    return out, lse


def _dkv_cuda(q, k, v, do, lse, delta, scale, causal):
    global dkv_launches
    bh, s_q, s_kv, d = _check("flash_bwd_dkv", q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _kernels().flash_bwd_dkv
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), bh, s_q, s_kv, d, float(scale), int(causal),
                int(q.dtype == torch.bfloat16), _stream(q.device))
    if rc:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: CUDA error "
                           f"{rc}")
    dkv_launches += 1
    return dk, dv


def _dq_cuda(q, k, v, do, lse, delta, scale, causal):
    global dq_launches
    bh, s_q, s_kv, d = _check("flash_bwd_dq", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    fn = _kernels().flash_bwd_dq
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s_q,
                s_kv, d, float(scale), int(causal),
                int(q.dtype == torch.bfloat16), _stream(q.device))
    if rc:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: CUDA error "
                           f"{rc}")
    dq_launches += 1
    return dq
