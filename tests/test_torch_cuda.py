"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the `cuda` marker and skips without an NVIDIA GPU.
This file imports neither JAX nor `paddle_tpu`, so it also runs where JAX is
not installed; on such a machine skip `tests/conftest.py` (which sets up
JAX):

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, in the working dtype: bf16 outputs differ by at most one
rounding of the output, one bf16 ulp (2^-7 relative) at the largest
magnitude; f32 outputs differ by summation order only (1e-5 relative).
The flash outputs are held row by row (a query's out or dQ, a key's dK or
dV): the error's norm over the row's norm, or over a quarter of the rms
row norm where the row is smaller (a row that is 0 but for rounding). The
kernels round P and dS to bf16 before their tensor-core products (the
plain versions keep them in f32), and round the output to bf16, which
alone may reach one ulp (2^-7 relative): bf16 rows are held to 1e-2; float
inputs go through split-TF32 products (about 2^-22 relative each) summed
in the tensor cores, held to 1e-3. The bf16 backward is one kernel
(`flash_bwd`) that sums dQ by atomics in an order that varies between
runs: its f32 sums differ by rounding, a bf16 element by at most one ulp,
well inside the same 1e-2 bar. `chip_smoke.py` shows at full size that
faults (a softmax scale 1 % off, a skipped tile, dQ without one key tile)
exceed these bars. The paged decodes are also held at a multi-query group
(32/1), at 64/2 and at head_dim 256, where both kernels split a group into
chunks of queries.

The dequant-matmul and int8 paged-decode kernels are held row by row too
(`_QUANT_TOL`): kernel and plain version dequantize to the same values and
sum in f32, so they differ by summation order and, in bf16, by the output
rounding of the few elements whose sums straddle a rounding boundary;
bf16 rows are held to 5e-3, f32 rows to 1e-4. Each case also reads a fault
made from the plain version (int4 nibbles swapped, one group's scales
shifted by a group, the K scales left out), which must exceed the bar.
The persistent wgmma kernel that takes bf16 at m > 16 (the prefill) is
held at m 17, 129 and 2512 (ragged last row tiles), k 512 and 13824, n 128,
384 and 5120, every weight and group, beside a ring's faults: the first or
the last 64-deep k tile's contribution missing.

The bf16 flash forward (register-resident scores) is also held in every
body at s_q = 192 over s_kv = 320 causal, a q tile cut short, beside a
diagonal one key late, and over tile-aligned segments, whose tiles it
takes without the segment mask.

The flash segment-id, dropout and combined bodies are held as the plain
ones, against their plain versions given the same segment ids and seed
(the same threefry bits on both sides), bf16 and f32; so are the entry
points that reach them (`flash_attn_unpadded`, dropout SDPA with
`FLAGS_flash_dropout_kernel`, the fused encoder layer, the lse entry).

The dense matmul's variants are held row by row against `torch.matmul`
on the f32 values of its inputs (`_MATMUL_TOL`): bf16 rows differ by the
output's one rounding (2^-9 relative on average, below 5e-3), f32 rows by
summation order (exact f32 products, 1e-5), at the m tails 1, 16, 17,
129 and 4095 and the n tails 256, 384 and 11008. A dropped k tile, and at
an m tail a last row written from the row before it, must exceed the
bar. The decode kernels (bf16, m <= 16: the dequant matmul's and the
GEMM's "skinny" variant) launch one kernel a call (no split-summing
kernel), give bitwise equal results from two calls and from a CUDA graph
of the call, and at the 13B shapes match the plain version beside a
reduce that misses one split partial. The grouped-fetch decode is held as the per-page kernel is (one
output rounding at the largest magnitude), against the plain dense
version and against the per-page kernel.

The GPT family (`-k gpt`): a tiny f32 GPT at head_dim 128 gives the same
greedy streams on the card (burst graphs, shallow and draft-model
speculation, int8 KV, `generate`) as on the CPU, the same training losses
(1e-4 relative) and updates (1e-2 of their norm, the key part of the QKV
bias, zero in exact arithmetic, left out); positions past the table clamp
on the device (no device assert); `FusedMultiTransformer`'s context
forward launches one flash kernel a layer and its decode at `time_step`
equals the context forward's rows (f32 flash bar, 1e-3).

The Adam / AdamW update kernel is held bit for bit against its plain
version, which rounds each f32 operation on its own in the kernel's order,
in bf16 (with and without an f32 master weight), f16 and f32, aligned and
one element off a 16-byte boundary, at whole vectors and odd tails.

The fine-tune's surface on the card: a `decode_burst=8` engine serves
reloaded weights after `refresh_params()` with the graphs it captured on
the old ones; LBFGS on CUDA tensors matches the CPU (1e-4: f32 dot
products in another order); `save` / `load` round-trip CUDA tensors bit
for bit and an AdamW state resumes; the tensor checker names an op.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.kernels import autotune as tat
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import matmul as tmm
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels import quant_matmul as tqm
from paddle_tpu_torch.kernels import rms_norm as trms
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     build_train_step)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.quant import (WeightOnlyLinear,
                                       quantize_for_inference,
                                       weight_quantize)
from paddle_tpu_torch.optimizer import LBFGS, AdamW
from paddle_tpu_torch.weights import (fused_encoder_state_from_numpy,
                                      fused_encoder_state_to_numpy,
                                      gpt_state_to_numpy,
                                      llama_state_to_numpy, load_gpt_state,
                                      load_llama_state)

_TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
        torch.float32: 1e-5}
_FLASH_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}
_QUANT_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-4}
_MATMUL_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest -m cuda "
                    "--noconftest tests/test_torch_cuda.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    return err <= _TOL[dtype] * max(1.0, want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("rows,cols", [(8, 4096), (1000, 4096), (3, 128),
                                       (5, 11008)])
def test_rms_norm_kernel_matches_plain(cuda_device, dtype, rows, cols):
    g = torch.Generator(device=cuda_device).manual_seed(rows + cols)
    x = (torch.randn(rows, cols, generator=g, device=cuda_device) * 2) \
        .to(dtype)
    w = torch.randn(cols, generator=g, device=cuda_device).to(dtype)
    n0 = trms.launches
    got = trms.rms_norm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert trms.launches == n0 + 1
    assert _close(got, trms.rms_norm_ref(x, w, 1e-6), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("rows,cols", [(8, 4096), (4096, 4096), (512, 128),
                                       (5, 8192)])
def test_rms_norm_backward_kernel_matches_plain(cuda_device, dtype, rows,
                                                cols):
    g = torch.Generator(device=cuda_device).manual_seed(rows + cols)
    x = (torch.randn(rows, cols, generator=g, device=cuda_device) * 2) \
        .to(dtype)
    w = torch.randn(cols, generator=g, device=cuda_device).to(dtype)
    gy = torch.randn(rows, cols, generator=g, device=cuda_device).to(dtype)
    n0, b0 = trms.launches, trms.bwd_launches
    y, rstd = trms.rms_norm(x, w, 1e-6, with_rstd=True)
    dx, dw = trms.rms_norm_bwd(x, w, rstd, gy)
    torch.cuda.synchronize()
    assert (trms.launches, trms.bwd_launches) == (n0 + 1, b0 + 1)
    y_ref, rstd_ref = trms.rms_norm_ref(x, w, 1e-6, with_rstd=True)
    assert _close(y, y_ref, dtype)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=0)
    dx_ref, dw_ref = trms.rms_norm_bwd_ref(x, w, rstd_ref, gy)
    assert _close(dx, dx_ref, dtype)
    assert _close(dw, dw_ref, dtype)


def _rms_inputs(dev, rows, cols, dtype, weight, offset, seed):
    """x and g [rows, cols] of `dtype` starting `offset` elements into
    their buffers (offset 1 of a 2-byte dtype: 2 bytes off a 16-byte
    boundary), and the weight: "same" (x's dtype), "f32" or None."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(scale):
        buf = torch.randn(rows * cols + offset, generator=gen, device=dev)
        return (buf * scale).to(dtype)[offset:].view(rows, cols)

    x, g = make(2.0), make(1.0)
    w = None if weight is None else torch.randn(
        cols, generator=gen, device=dev).to(
            dtype if weight == "same" else torch.float32)
    return x, w, g


# rows, cols, dtype, weight, offset: the model widths, odd widths (6, 4100:
# the stream instances' edges), the widest ring rows (16384 bf16, 8192
# f32), rows past the ring (32768, 131072 bf16: the stream instances), a
# float32 weight under bf16 and f16 x, no weight, and x and g 2 bytes
# (bf16) or 4 bytes (f32) off a 16-byte boundary
_RMS_ANY = [
    (8, 5120, torch.bfloat16, "same", 0),
    (2512, 5120, torch.bfloat16, "same", 0),
    (4096, 4096, torch.float16, "same", 0),
    (64, 4096, torch.bfloat16, "f32", 0),
    (64, 4096, torch.float16, "f32", 0),
    (64, 4096, torch.bfloat16, None, 0),
    (37, 6, torch.bfloat16, "same", 0),
    (37, 4100, torch.bfloat16, "same", 0),
    (5, 4100, torch.float32, "same", 0),
    (9, 4100, torch.float16, None, 0),
    (7, 16384, torch.bfloat16, "same", 0),
    (3, 8192, torch.float32, None, 0),
    (4, 32768, torch.bfloat16, "same", 0),
    (3, 131072, torch.bfloat16, "f32", 0),
    (300, 4096, torch.bfloat16, "same", 1),
    (300, 4096, torch.float32, None, 1),
    (1, 1, torch.float32, "same", 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,dtype,weight,offset", _RMS_ANY)
def test_rms_norm_kernels_take_any_input(cuda_device, rows, cols, dtype,
                                         weight, offset):
    """Every float input launches one forward and one backward kernel,
    held against the plain versions: y, dx and dw row by row within one
    rounding of the output (`_TOL`; f32 summation order), rstd within
    1e-5. dx = rstd * (wg - xh * mean(wg * xh)) cancels where a row is
    short (at one column to rounding alone), so its rows are held over the
    norm of the terms it cancels, rstd * wg."""
    x, w, gy = _rms_inputs(cuda_device, rows, cols, dtype, weight, offset,
                           seed=rows + cols)
    assert x.data_ptr() % 16 == (2 * offset if dtype != torch.float32
                                 else 4 * offset)
    n0, b0 = trms.launches, trms.bwd_launches
    y, rstd = trms.rms_norm(x, w, 1e-6, with_rstd=True)
    y_serve = trms.rms_norm(x, w, 1e-6)
    dx, dw = trms.rms_norm_bwd(x, w, rstd, gy)
    torch.cuda.synchronize()
    assert (trms.launches, trms.bwd_launches) == (n0 + 2, b0 + 1)
    assert torch.equal(y, y_serve)
    y_ref, rstd_ref = trms.rms_norm_ref(x, w, 1e-6, with_rstd=True)
    tol = _TOL[dtype]
    assert y.dtype == dtype and _row_rel_err(y, y_ref) <= tol
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=0)
    dx_ref, dw_ref = trms.rms_norm_bwd_ref(x, w, rstd, gy)
    wg = gy.float() if w is None else gy.float() * w.float()
    terms = (rstd[:, None] * wg).norm(dim=-1)
    assert dx.dtype == dtype
    assert ((dx.float() - dx_ref.float()).norm(dim=-1) / terms).max() <= tol
    if w is None:
        assert dw is None
    else:
        assert dw.dtype == w.dtype
        assert _row_rel_err(dw[None], dw_ref[None]) <= _TOL[w.dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,dtype", [(8, 4096, torch.bfloat16),
                                             (4096, 4096, torch.bfloat16),
                                             (37, 4100, torch.float32)])
def test_rms_norm_backward_is_one_deterministic_graph_safe_launch(
        cuda_device, rows, cols, dtype):
    """The backward (dx and dw) is one CUDA launch; dw is bitwise equal
    over two calls (its cross-block sum runs in a fixed order); replays of
    a CUDA graph of the call equal the eager call."""
    x, w, gy = _rms_inputs(cuda_device, rows, cols, dtype, "same", 0,
                           seed=3)
    _, rstd = trms.rms_norm(x, w, 1e-6, with_rstd=True)

    def call():
        return trms.rms_norm_bwd(x, w, rstd, gy)

    names = _kernel_names(call)
    assert len(names) == 1 and "rms_norm_bwd" in names[0], names
    dx, dw = call()
    dx2, dw2 = call()
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], dx) and torch.equal(out[1], dw)
    assert torch.equal(call()[1], dw)
    names = _kernel_names(lambda: trms.rms_norm(x, w, 1e-6))
    assert len(names) == 1 and "rms_norm_fwd" in names[0], names


def _row_rel_err(got, want):
    """Max over rows of ||got - want|| / ||want||, the denominator at least
    a quarter of the rms row norm (a row that is 0 but for rounding)."""
    num = (got.float() - want.float()).norm(dim=-1)
    den = want.float().norm(dim=-1)
    low = 0.25 * den.square().mean().sqrt()
    return (num / den.clamp_min(low.clamp_min(1e-30))).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s_q,s_kv,causal", [
    (256, 256, True), (256, 256, False), (128, 384, True), (256, 128, True),
    (192, 64, False)])
def test_flash_kernels_match_plain(cuda_device, dtype, s_q, s_kv, causal):
    g = torch.Generator(device=cuda_device).manual_seed(s_q + s_kv)
    bh, d, scale = 3, 128, 128 ** -0.5

    def rnd(s):
        return torch.randn(bh, s, d, generator=g, device=cuda_device) \
            .to(dtype)

    q, k, v, do = rnd(s_q), rnd(s_kv), rnd(s_kv), rnd(s_q)
    counts = (tfa.fwd_launches, tfa.bwd_launches)
    out, lse = tfa.flash_fwd(q, k, v, scale, causal)
    delta = tfa.flash_bwd_delta(out, do)
    dq, dk, dv = tfa.flash_bwd(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert (tfa.fwd_launches, tfa.bwd_launches) == \
        tuple(c + 1 for c in counts)
    out_ref, lse_ref = tfa.flash_fwd_ref(q, k, v, scale, causal)
    assert _row_rel_err(out, out_ref) <= _FLASH_TOL[dtype]
    live = lse_ref > -1e29  # rows with at least one visible key
    torch.testing.assert_close(lse[live], lse_ref[live], rtol=0, atol=1e-3)
    assert torch.equal(lse[~live], lse_ref[~live])
    assert not out[~live].any()
    dq_ref, dk_ref, dv_ref = tfa.flash_bwd_ref(q, k, v, do, lse_ref, delta,
                                               scale, causal)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert _row_rel_err(got, want) <= _FLASH_TOL[dtype]


@pytest.mark.cuda
def test_flash_attention_autograd_runs_the_kernels(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(2, 256, 4, 128, generator=g, device=cuda_device)
               .requires_grad_() for _ in range(3))
    counts = (tfa.fwd_launches, tfa.bwd_launches)
    out = tfa.flash_attention_bshd(q, k, v, causal=True)
    out.square().sum().backward()
    assert (tfa.fwd_launches, tfa.bwd_launches) == \
        tuple(c + 1 for c in counts)
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    out_c = tfa.flash_attention_bshd(qc, kc, vc, causal=True)
    out_c.square().sum().backward()
    assert _row_rel_err(out.cpu(), out_c) <= _FLASH_TOL[torch.float32]
    for a, b in ((q, qc), (k, kc), (v, vc)):
        assert _row_rel_err(a.grad.cpu(), b.grad) <= _FLASH_TOL[torch.float32]


@pytest.mark.cuda
def test_rms_norm_functional_on_cuda_launches_or_raises(cuda_device):
    """F.rms_norm never takes the plain version for a CUDA tensor: every
    width launches the forward kernel, and with a gradient the forward and
    backward kernels, with a weight, without one, and for a non-contiguous
    x (made contiguous first); an integer x raises."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(5, 11008, generator=g, device=cuda_device)
    w = torch.randn(11008, generator=g, device=cuda_device)
    n0 = trms.launches
    with torch.no_grad():
        y = F.rms_norm(x, w, 1e-6)
        y_strided = F.rms_norm(x.t().contiguous().t(), w, 1e-6)
    torch.cuda.synchronize()
    assert trms.launches == n0 + 2
    assert _close(y, trms.rms_norm_ref(x, w, 1e-6), torch.float32)
    assert torch.equal(y, y_strided)
    for weight in (w, None):
        xg = x.detach().clone().requires_grad_()
        wg = None if weight is None else weight.clone().requires_grad_()
        n0, b0 = trms.launches, trms.bwd_launches
        F.rms_norm(xg, wg).sum().backward()
        assert (trms.launches, trms.bwd_launches) == (n0 + 1, b0 + 1)
        xr = x.detach().clone().requires_grad_()
        wr = None if weight is None else weight.clone().requires_grad_()
        trms.rms_norm_ref(xr, wr, 1e-6).sum().backward()
        assert _close(xg.grad, xr.grad, torch.float32)
        if weight is not None:
            assert _close(wg.grad, wr.grad, torch.float32)
    with pytest.raises(TypeError):
        F.rms_norm(x.int(), None)


def _decode_case(dev, dtype, b, q_heads, kv_heads, d, page, pages_per_seq,
                 lens, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = b * pages_per_seq
    shape = (kv_heads, n_pages, page, d)
    k = torch.randn(shape, generator=g, device=dev).to(dtype)
    v = torch.randn(shape, generator=g, device=dev).to(dtype)
    q = torch.randn(b, q_heads, d, generator=g, device=dev).to(dtype)
    tables = torch.randperm(n_pages, generator=g, device=dev) \
        .reshape(b, pages_per_seq).to(torch.int32)
    return q, k, v, tables, torch.tensor(lens, dtype=torch.int32,
                                         device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_heads,kv_heads,d,page", [
    (32, 32, 128, 16), (32, 8, 128, 16), (4, 2, 64, 8), (16, 1, 128, 128),
    (4, 2, 32, 8), (32, 1, 128, 16), (64, 2, 64, 16), (20, 1, 32, 8),
    (8, 2, 256, 16), (32, 1, 256, 16)])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, q_heads,
                                              kv_heads, d, page):
    lens = (0, 1, 15, 16, 17, 300, 511, 512)
    args = _decode_case(cuda_device, dtype, len(lens), q_heads, kv_heads, d,
                        page, 512 // page, lens, seed=d + page)
    n0 = tpa.launches
    got = tpa.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.launches == n0 + 1
    assert _close(got, tpa.paged_attention_ref(*args), dtype)
    assert not got[0].any()  # a ctx == 0 row writes zeros


def _split_case(dev, kind, dtype, q_heads, kv_heads, lens, seed=0,
                page=16, pps=256):
    """Inputs of the split-KV decode (per-page "page", int8 "q8", grouped
    "grouped") and the call that makes one launch of it."""
    q, kp, vp, tables, ln = _decode_case(dev, dtype, len(lens), q_heads,
                                         kv_heads, 128, page, pps, lens,
                                         seed)
    sc = {}
    if kind == "q8":
        kp, ks = tpa._quant_kv_token(kp.float())
        vp, vs = tpa._quant_kv_token(vp.float())
        sc = dict(k_scales=ks, v_scales=vs)
    args = (q, kp, vp, tables, ln)
    if kind == "grouped":
        return args, sc, lambda: tpa.paged_attention_grouped(*args)
    return args, sc, lambda: tpa.paged_attention(*args, **sc)


def _split_lens(kind, q_heads, kv_heads, b=8, page=16, pps=256):
    """Contexts at the kernel's split edges: one split's tokens -1, +0, +1,
    two splits' -1 and +1, the full table, and 0."""
    plan = tpa.split_plan(b, kv_heads, q_heads // kv_heads, 128, page, pps,
                          tpa.sm_count(torch.device("cuda")))
    span = plan["split_pages"] * page
    return [0, span - 1, span, span + 1, 2 * span - 1, 2 * span + 1,
            pps * page - 1, pps * page]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype", [
    ("page", torch.bfloat16), ("page", torch.float32),
    ("q8", torch.bfloat16), ("q8", torch.float32),
    ("grouped", torch.bfloat16), ("grouped", torch.float32)])
@pytest.mark.parametrize("q_heads,kv_heads", [(32, 32), (32, 8), (32, 1)])
def test_paged_decode_kernel_at_its_split_edges(cuda_device, kind, dtype,
                                                q_heads, kv_heads):
    """The split-KV kernel against the dense plain version at contexts on
    either side of its split edges, and against the plain split
    computation at the same plan; int8 row by row (`_QUANT_TOL`), float
    within one output rounding."""
    lens = _split_lens(kind, q_heads, kv_heads)
    args, sc, call = _split_case(cuda_device, kind, dtype, q_heads,
                                 kv_heads, lens, seed=q_heads + kv_heads)
    got = call()
    torch.cuda.synchronize()
    want = tpa.paged_attention_ref(*args, **sc)
    plan = tpa.split_plan(len(lens), kv_heads, q_heads // kv_heads, 128, 16,
                          256, tpa.sm_count(cuda_device))
    split = tpa.paged_attention_split_ref(
        *args, None, sc.get("k_scales"), sc.get("v_scales"),
        plan["split_pages"])
    if kind == "q8":
        assert _row_rel_err(got[1:], want[1:]) <= _QUANT_TOL[dtype]
        assert _row_rel_err(got[1:], split[1:]) <= _QUANT_TOL[dtype]
    else:
        assert _close(got, want, dtype) and _close(got, split, dtype)
    assert not got[0].any()  # context 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["page", "q8", "grouped"])
def test_paged_decode_launches_once_is_bitwise_and_replays(cuda_device,
                                                           kind):
    """Each decode entry makes one kernel launch a call (its counter moves
    by one, the other entries' not at all; `chip_smoke.py`'s decode profile
    counts the step's device operations), gives bitwise equal results from
    two calls, and a CUDA graph captured once replays right with changed
    context lengths (the tickets reset themselves). No torch.profiler
    session here: late in this file's run the profiler keeps no device
    records, and every session moves that point."""
    lens = [0, 1, 15, 16, 17, 1000, 2049, 4096]
    args, sc, call = _split_case(cuda_device, kind, torch.bfloat16, 32, 8,
                                 lens, seed=5)
    counter = {"page": "launches", "q8": "q8_launches",
               "grouped": "grouped_launches"}[kind]
    counts = ("launches", "q8_launches", "grouped_launches")
    n0 = {c: getattr(tpa, c) for c in counts}
    first, second = call(), call()
    torch.cuda.synchronize()
    assert {c: getattr(tpa, c) - n0[c] for c in counts} == \
        {c: 2 if c == counter else 0 for c in counts}
    assert torch.equal(first, second)
    ln = args[4]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for new in ([4096, 0, 1, 17, 2049, 1000, 15, 16],
                [5, 600, 3000, 4096, 4095, 0, 1, 2], lens):
        ln.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call())
        want = tpa.paged_attention_ref(*args, **sc)
        if kind == "q8":
            rows = [i for i, n in enumerate(new) if n]
            assert _row_rel_err(out[rows], want[rows]) <= \
                _QUANT_TOL[torch.bfloat16]
        else:
            assert _close(out, want, torch.bfloat16)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.randn(8, 256, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        trms.rms_norm(x[:, ::2], torch.ones(128, device=cuda_device))
    with pytest.raises(TypeError):
        trms.rms_norm(x.int(), torch.ones(256, device=cuda_device))
    with pytest.raises(TypeError):
        trms.rms_norm(x.half(), torch.ones(256, device=cuda_device).bfloat16())
    args = _decode_case(cuda_device, torch.float32, 2, 4, 2, 96, 8, 4,
                        (3, 5))
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attention(*args)
    q = torch.randn(2, 128, 64, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(q, q, q, 0.125, True)
    q = torch.randn(2, 100, 128, device=cuda_device)
    with pytest.raises(ValueError, match="multiples"):
        tfa.flash_fwd(q, q, q, 0.125, True)
    q = torch.randn(2, 128, 128, device=cuda_device)
    with pytest.raises(TypeError):
        tfa.flash_fwd(q, q.half(), q, 0.125, True)
    rstd = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError, match="rstd"):
        trms.rms_norm_bwd(x, torch.ones(256, device=cuda_device),
                          rstd[:4], x)


@pytest.mark.cuda
def test_tiny_engine_greedy_streams_equal_on_cuda_and_cpu(cuda_device):
    cfg = LlamaConfig.tiny(vocab=256, hidden=128, layers=2, heads=4, seq=64)
    cfg.num_key_value_heads = 2
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=0)
    gpu = LlamaForCausalLM(cfg, device=cuda_device)
    load_llama_state(gpu, {k: v.numpy() for k, v in cpu.state_dict().items()})
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, (n,)) for n in (5, 9, 17, 3)]
    streams = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        eng = ServingEngine(model, max_batch=3, max_seq_len=48, page_size=8,
                            device=dev)
        for p in prompts:
            eng.add_request(p, max_new_tokens=12)
        streams.append({f.request_id: f.output_ids.tolist()
                        for f in eng.run()})
    assert streams[0] == streams[1]


def _tiny_burst_streams(model, dev, prompts, sampled=False, **kw):
    eng = ServingEngine(model, max_batch=3, max_seq_len=64, page_size=8,
                        device=dev, seed=3, **kw)
    for i, p in enumerate(prompts):
        extra = dict(decode_strategy="sampling", temperature=0.8,
                     top_k=20) if sampled and i % 2 else {}
        eng.add_request(p, max_new_tokens=20 - i, **extra)
    return {f.request_id: f.output_ids.tolist() for f in eng.run()}, eng


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("depth", [0, 2])
def test_burst_graphs_equal_eager_and_cpu_streams(cuda_device, kv, depth):
    """decode_burst=4 on the card replays captured graphs (one a program,
    none captured twice) and gives the eager engine's and the CPU's greedy
    streams (head_dim 128: the paged and RMSNorm kernels run)."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2, seq=64)
    cfg.num_key_value_heads = 1
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=0)
    gpu = LlamaForCausalLM(cfg, device=cuda_device)
    load_llama_state(gpu, {k: v.numpy() for k, v in cpu.state_dict().items()})
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, (n,)) for n in (5, 9, 17, 3, 40)]
    want, _ = _tiny_burst_streams(cpu, "cpu", prompts, kv_cache_quant=kv)
    eager, _ = _tiny_burst_streams(gpu, cuda_device, prompts,
                                   kv_cache_quant=kv)
    got, eng = _tiny_burst_streams(gpu, cuda_device, prompts,
                                   kv_cache_quant=kv, decode_burst=4,
                                   async_depth=depth)
    assert got == eager == want
    assert eng.graph_captures == len(eng._burst_fns) <= 2
    assert eng.graph_replays > 0 and eng.discarded_tokens == 0


@pytest.mark.cuda
def test_burst_graph_sampling_is_seeded(cuda_device):
    """The engine's generator is registered with the sampling graphs: a
    replay draws new numbers, two engines of one seed draw the same, and
    greedy rows beside sampled ones keep their streams."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2, seq=64)
    cfg.num_key_value_heads = 1
    gpu = LlamaForCausalLM(cfg, device=cuda_device, seed=0)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 256, (n,)) for n in (5, 9, 17, 3)]
    greedy, _ = _tiny_burst_streams(gpu, cuda_device, prompts)
    a, eng = _tiny_burst_streams(gpu, cuda_device, prompts, sampled=True,
                                 decode_burst=4)
    b, _ = _tiny_burst_streams(gpu, cuda_device, prompts, sampled=True,
                               decode_burst=4)
    assert a == b and eng.graph_replays > 0
    assert all(a[r] == greedy[r] for r in (0, 2))
    assert all(len(set(a[r])) > 1 for r in (1, 3))  # not one token repeated
    assert all(0 <= t < 256 for s in a.values() for t in s)


@pytest.mark.cuda
def test_tiny_training_through_the_kernels_matches_cpu(cuda_device):
    """Head_dim 128, so CUDA trains through the flash and RMSNorm kernels
    and the CPU through their plain versions: 3 AdamW steps from the same
    weights give losses within 1e-4 relative (split-TF32 flash products)."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2, seq=256)
    cfg.num_key_value_heads = 1
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=0)
    gpu = LlamaForCausalLM(cfg, device=cuda_device)
    load_llama_state(gpu, {k: v.numpy() for k, v in cpu.state_dict().items()})
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 256, (2, 256)))
    y = torch.from_numpy(rng.randint(0, 256, (2, 256)))
    n0 = tfa.fwd_launches, trms.bwd_launches
    losses = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        step = build_train_step(model, AdamW(learning_rate=1e-3,
                                             parameters=model.parameters()))
        losses.append([step(x.to(dev), y.to(dev)).item() for _ in range(3)])
    assert (tfa.fwd_launches, trms.bwd_launches) == (n0[0] + 6, n0[1] + 15)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4, atol=0)


_ALGO = {"int8": "weight_only_int8", "int4": "weight_only_int4"}


def _swap_nibbles(qw):
    u = qw.to(torch.int32) & 0xFF
    u = ((u & 0xF) << 4) | (u >> 4)
    return torch.where(u >= 128, u - 256, u).to(torch.int8)


def _shift_group(scales):
    """Group 0 takes group 1's scales (per-channel: every column takes its
    neighbour's)."""
    if scales.dim() == 1:
        return scales.roll(1)
    out = scales.clone()
    out[0] = scales[1]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("wd,gs", [("int8", -1), ("int8", 64), ("int8", 128),
                                   ("int4", -1), ("int4", 64),
                                   ("int4", 128)])
@pytest.mark.parametrize("m,k,n", [(1, 256, 384), (8, 512, 128),
                                   (17, 256, 256), (200, 384, 640)])
def test_quant_matmul_kernel_matches_plain(cuda_device, dtype, wd, gs, m, k,
                                           n):
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    w = torch.randn(k, n, generator=g, device=cuda_device) * 0.05
    x = torch.randn(m, k, generator=g, device=cuda_device).to(dtype)
    qw, sc = weight_quantize(w.to(dtype), _ALGO[wd], group_size=gs)
    n0 = tqm.launches
    got = tqm.quant_matmul(x, qw, sc, wd, gs)
    torch.cuda.synchronize()
    assert tqm.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (m, n)
    want = tqm.quant_matmul_ref(x, qw, sc, wd)
    assert _row_rel_err(got, want) <= _QUANT_TOL[dtype]
    fault = (tqm.quant_matmul_ref(x, _swap_nibbles(qw), sc, wd)
             if wd == "int4" else
             tqm.quant_matmul_ref(x, qw, _shift_group(sc), wd))
    assert _row_rel_err(fault, want) > _QUANT_TOL[dtype]


def _without_k_tile(x, qw, sc, wd, tile):
    """The plain version without one 64-deep k tile's contribution."""
    cut = x.clone()
    cut[:, tile * 64:(tile + 1) * 64] = 0
    return tqm.quant_matmul_ref(cut, qw, sc, wd)


@pytest.mark.cuda
@pytest.mark.parametrize("wd,gs", [("int8", -1), ("int8", 64), ("int8", 128),
                                   ("int4", -1), ("int4", 64),
                                   ("int4", 128)])
@pytest.mark.parametrize("n", [128, 384, 5120])
@pytest.mark.parametrize("k", [512, 13824])
@pytest.mark.parametrize("m", [17, 129, 2512])
def test_quant_matmul_prefill_kernel_matches_plain(cuda_device, m, k, n, wd,
                                                   gs):
    """The persistent wgmma kernel (bf16, m > 16) row by row against the
    plain version, beside the faults of a ring that drops the first or the
    last k tile, which must fail the same bar."""
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    w = torch.randn(k, n, generator=g, device=cuda_device) * 0.02
    x = torch.randn(m, k, generator=g, device=cuda_device).to(torch.bfloat16)
    qw, sc = weight_quantize(w.to(torch.bfloat16), _ALGO[wd], group_size=gs)
    n0 = tqm.launches
    got = tqm.quant_matmul(x, qw, sc, wd, gs)
    torch.cuda.synchronize()
    assert tqm.launches == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    want = tqm.quant_matmul_ref(x, qw, sc, wd)
    tol = _QUANT_TOL[torch.bfloat16]
    assert _row_rel_err(got, want) <= tol
    for tile in (0, k // 64 - 1):
        assert _row_rel_err(_without_k_tile(x, qw, sc, wd, tile), want) > tol


def _kernel_names(fn):
    """The device kernels one call of `fn` launches, by name."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kind = torch.autograd.DeviceType.CUDA
    return [e.name for e in prof.events() if e.device_type == kind
            and "emcpy" not in e.name and "emset" not in e.name]


def _without_split_partial(x, qw, sc, wd, splits):
    """The plain version without the first shared segment's partial of
    the decode kernel's in-launch reduce (one column tile's k range) at a
    k split of `splits`."""
    k, n = x.shape[1], qw.shape[1]
    sch = tmm.decode_schedule(k, n, tmm.sm_count(x.device), splits)
    _, c, s0, s1, _ = next(s for s in tmm.decode_segments(sch)
                           if s[4] is not None)
    w = tqm.dequantize(qw, sc, wd, x.dtype)
    t = tmm.DECODE_TILE
    w[s0 * t:s1 * t, c * t:(c + 1) * t] = 0
    return torch.matmul(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("wd,gs", [("int8", -1), ("int8", 64), ("int4", -1),
                                   ("int4", 128)])
@pytest.mark.parametrize("k,n", [(5120, 5120), (5120, 13824),
                                 (13824, 5120)])
@pytest.mark.parametrize("m", [1, 8, 16])
def test_quant_matmul_decode_kernel_matches_plain(cuda_device, m, k, n, wd,
                                                  gs):
    """The decode kernel (bf16, m <= 16) at LLaMA-2-13B's projections, row
    by row against the plain version, with its default split and with
    every column tile cut into 3 k ranges (the in-launch reduce at every
    shape), beside a reduce that misses one split partial, which must fail
    the same bar; two calls are bitwise equal."""
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    w = torch.randn(k, n, generator=g, device=cuda_device) * 0.02
    x = torch.randn(m, k, generator=g, device=cuda_device).to(torch.bfloat16)
    qw, sc = weight_quantize(w.to(torch.bfloat16), _ALGO[wd], group_size=gs)
    want = tqm.quant_matmul_ref(x, qw, sc, wd)
    tol = _QUANT_TOL[torch.bfloat16]
    for splits in (None, 3):
        n0 = tqm.kernel_launches["decode"]
        got = tqm._quant_matmul_cuda(x, qw, sc, wd, gs, splits)
        again = tqm._quant_matmul_cuda(x, qw, sc, wd, gs, splits)
        torch.cuda.synchronize()
        assert tqm.kernel_launches["decode"] == n0 + 2
        assert torch.equal(got, again)
        assert _row_rel_err(got, want) <= tol, splits
    assert _row_rel_err(_without_split_partial(x, qw, sc, wd, 3), want) > tol


@pytest.mark.cuda
@pytest.mark.parametrize("wd,gs", [("int8", -1), ("int8", 64), ("int4", -1),
                                   ("int4", 128)])
@pytest.mark.parametrize("m", [5, 16])
def test_decode_kernel_dequantizes_bit_for_bit(cuda_device, m, wd, gs):
    """One-hot rows of x pick weight rows, so y is the dequantized weight
    itself (times 1, plus exact zeros): the decode kernel's conversions
    equal the plain `dequantize` (bf16(q) x bf16(s), one rounding) bit for
    bit, over every int8 (or int4) value in every column position."""
    k, n = 512, 256
    levels, low = (256, -128) if wd == "int8" else (16, -8)
    r = torch.arange(k, device=cuda_device)[:, None]
    c = torch.arange(n, device=cuda_device)[None, :]
    q = ((r + c) % levels + low).to(torch.int8)
    if wd == "int4":
        b = (q[0::2].to(torch.int32) & 0xF) | ((q[1::2].to(torch.int32)
                                                & 0xF) << 4)
        qw = torch.where(b >= 128, b - 256, b).to(torch.int8)
    else:
        qw = q
    g = torch.Generator(device=cuda_device).manual_seed(m)
    groups = 1 if gs == -1 else k // gs
    sc = torch.rand(groups, n, generator=g, device=cuda_device) * 0.1 + 1e-3
    if gs == -1:
        sc = sc[0].contiguous()
    rows = torch.randperm(k, generator=g, device=cuda_device)[:m]
    x = torch.zeros(m, k, device=cuda_device, dtype=torch.bfloat16)
    x[torch.arange(m, device=cuda_device), rows] = 1
    got = tqm.quant_matmul(x, qw, sc, wd, gs)
    want = tqm.dequantize(qw, sc, wd, torch.bfloat16)[rows]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["int8", "int4", "bf16", "int8_split"])
def test_decode_kernels_launch_once_and_replay_in_a_graph(cuda_device, case):
    """The decode kernels (the dequant matmul's and the GEMM's skinny
    variant) launch exactly one kernel a call, no split-summing kernel;
    a CUDA graph of the call replays to the eager result bit for bit (the
    tickets reset themselves), as does a forced k split."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    k, n = 5120, 13824
    x = torch.randn(8, k, generator=g, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=cuda_device) * 0.02) \
        .to(torch.bfloat16)
    if case == "bf16":
        def call():
            return tmm.matmul_fused(x, w, "skinny")
    else:
        wd = case[:4]
        qw, sc = weight_quantize(w, _ALGO[wd], group_size=-1)
        sp = 3 if case.endswith("split") else None

        def call():
            return tqm._quant_matmul_cuda(x, qw, sc, wd, -1, sp)
    names = _kernel_names(call)
    assert len(names) == 1 and "skinny_kernel" in names[0], names
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert torch.equal(call(), eager)


@pytest.mark.cuda
def test_quant_matmul_refuses_what_it_does_not_take(cuda_device):
    x = torch.randn(4, 256, device=cuda_device)
    qw, sc = weight_quantize(torch.randn(256, 200, device=cuda_device))
    assert not tqm.supports(4, 256, 200)
    with pytest.raises(ValueError, match="supports"):
        tqm.quant_matmul(x, qw, sc)
    qw, sc = weight_quantize(torch.randn(96, 128, device=cuda_device))
    with pytest.raises(ValueError, match="supports"):
        tqm.quant_matmul(torch.randn(4, 96, device=cuda_device), qw, sc)
    qw, sc = weight_quantize(torch.randn(256, 128, device=cuda_device),
                             group_size=64)
    with pytest.raises(ValueError, match="scales"):
        tqm.quant_matmul(x, qw, sc, "int8", -1)
    with pytest.raises(TypeError):
        tqm.quant_matmul(x.half(), qw, sc, "int8", 64)
    with pytest.raises(ValueError):
        tqm.quant_matmul(x, qw.cpu(), sc, "int8", 64)


@pytest.mark.cuda
def test_weight_only_linear_launches_the_kernel(cuda_device):
    """WeightOnlyLinear on CUDA runs the kernel at every m (decode and a
    prefill of 1100 rows); with a gradient, dx is the plain transposed
    product."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    lin = Linear(512, 256, device=cuda_device)
    with torch.no_grad():
        lin.weight.normal_(0, 0.05, generator=g)
    wol = WeightOnlyLinear.from_source(lin, "weight_only_int4", 128)
    for rows in (8, 1100):
        x = torch.randn(1, rows, 512, generator=g, device=cuda_device)
        n0 = tqm.launches
        with torch.no_grad():
            y = wol(x)
        torch.cuda.synchronize()
        assert tqm.launches == n0 + 1 and y.shape == (1, rows, 256)
        want = tqm.quant_matmul_ref(x[0], wol.quant_weight, wol.weight_scale,
                                    "int4")
        assert _row_rel_err(y[0], want) <= _QUANT_TOL[torch.float32]
    x = x.requires_grad_()
    wol(x).square().sum().backward()
    xc = x.detach().cpu().requires_grad_()
    tqm.quant_matmul(xc, wol.quant_weight.cpu(), wol.weight_scale.cpu(),
                     "int4", 128).square().sum().backward()
    assert _row_rel_err(x.grad.cpu(), xc.grad) <= _QUANT_TOL[torch.float32]


def _q8_case(dev, dtype, b, q_heads, kv_heads, d, page, pages_per_seq, lens,
             seed=0):
    q, k, v, tables, ln = _decode_case(dev, torch.float32, b, q_heads,
                                       kv_heads, d, page, pages_per_seq,
                                       lens, seed)
    kq, ks = tpa._quant_kv_token(k)
    vq, vs = tpa._quant_kv_token(v)
    return q.to(dtype), kq, vq, tables, ln, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_heads,kv_heads,d,page", [
    (40, 40, 128, 16), (32, 8, 128, 16), (4, 2, 64, 8), (16, 1, 128, 128),
    (4, 2, 32, 8), (32, 1, 128, 16), (64, 2, 128, 16), (8, 2, 256, 16),
    (32, 1, 256, 16)])
def test_paged_attention_q8_kernel_matches_plain(cuda_device, dtype, q_heads,
                                                 kv_heads, d, page):
    lens = (0, 1, 15, 16, 17, 300, 511, 512)
    q, kq, vq, tables, ln, ks, vs = _q8_case(
        cuda_device, dtype, len(lens), q_heads, kv_heads, d, page,
        512 // page, lens, seed=d + page)
    n0, f0 = tpa.q8_launches, tpa.launches
    got = tpa.paged_attention(q, kq, vq, tables, ln, k_scales=ks,
                              v_scales=vs)
    torch.cuda.synchronize()
    assert (tpa.q8_launches, tpa.launches) == (n0 + 1, f0)
    want = tpa.paged_attention_ref(q, kq, vq, tables, ln, k_scales=ks,
                                   v_scales=vs)
    assert _row_rel_err(got[1:], want[1:]) <= _QUANT_TOL[dtype]
    assert not got[0].any()  # a ctx == 0 row writes zeros
    fault = tpa.paged_attention_ref(q, kq, vq, tables, ln,
                                    k_scales=torch.ones_like(ks),
                                    v_scales=vs)
    assert _row_rel_err(fault[1:], want[1:]) > _QUANT_TOL[dtype]


@pytest.mark.cuda
def test_paged_attention_q8_refuses_bad_scales(cuda_device):
    q, kq, vq, tables, ln, ks, vs = _q8_case(cuda_device, torch.float32, 2,
                                             4, 2, 64, 8, 4, (3, 5))
    with pytest.raises(ValueError, match="both"):
        tpa.paged_attention(q, kq, vq, tables, ln, k_scales=ks)
    with pytest.raises(ValueError, match="scales"):
        tpa.paged_attention(q, kq, vq, tables, ln, k_scales=ks[..., :4],
                            v_scales=vs[..., :4].contiguous())
    with pytest.raises(TypeError):
        tpa.paged_attention(q, kq.float(), vq.float(), tables, ln,
                            k_scales=ks, v_scales=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,gs", [("weight_only_int8", -1),
                                     ("weight_only_int4", 64)])
def test_tiny_quantized_engine_streams_equal_on_cuda_and_cpu(cuda_device,
                                                             algo, gs):
    """Head_dim 128, int8 KV: CUDA serves through the dequant-matmul and
    int8 decode kernels, the CPU through their plain versions."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2, seq=64)
    cfg.num_key_value_heads = 1
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=0)
    gpu = LlamaForCausalLM(cfg, device=cuda_device)
    for m in (cpu, gpu):
        quantize_for_inference(m, algo, gs, exclude=("lm_head",))
    # the CPU's quantized weights, carried across
    load_llama_state(gpu, llama_state_to_numpy(cpu))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, (n,)) for n in (5, 9, 17, 3)]
    counts = tqm.launches, tpa.q8_launches
    streams = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        eng = ServingEngine(model, max_batch=3, max_seq_len=48, page_size=8,
                            device=dev, kv_cache_quant="int8")
        for p in prompts:
            eng.add_request(p, max_new_tokens=12)
        streams.append({f.request_id: f.output_ids.tolist()
                        for f in eng.run()})
    assert tqm.launches > counts[0] and tpa.q8_launches > counts[1]
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# the dense matmul and the grouped-fetch decode
# ---------------------------------------------------------------------------


@pytest.fixture
def flags_restored(tmp_path):
    """The tuner's flags, its table in a temporary directory, and its timer,
    restored afterwards."""
    names = ["FLAGS_autotune", "FLAGS_autotune_cache_dir",
             "FLAGS_paged_grouped_kernel"]
    old = get_flags(names)
    set_flags({"FLAGS_autotune_cache_dir": str(tmp_path)})
    tat.reset_tuner()
    yield tmp_path
    set_flags(old)
    tat.set_timer(None)
    tat.reset_tuner()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 128, 128), (8, 512, 384),
                                   (33, 256, 256), (300, 1024, 512),
                                   (129, 4096, 128), (16, 320, 384),
                                   (17, 512, 256), (4095, 1024, 384),
                                   (129, 4096, 11008), (256, 192, 384)])
def test_matmul_kernel_matches_plain(cuda_device, dtype, m, k, n):
    """Every variant that takes m rows (bf16: the decode kernels at m <=
    16, the wgmma tiles above; f32: the split kernel's row tiles), at the
    m tails (1, 16, 17, 129, 4095), the n tails (256, 384: a 128 x 256
    tile half past n; 11008) and a k % 128 == 64 tail, beside a dropped k
    tile and, at an m tail, a last row written from the row before it."""
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(k, n, generator=g, device=cuda_device).to(dtype)
    want = torch.matmul(x.float(), w.float())
    x_cut = x.clone()
    x_cut[:, :64] = 0  # a dropped k tile
    fault = torch.matmul(x_cut.float(), w.float())
    assert _row_rel_err(fault, want) > _MATMUL_TOL[dtype]
    if m % 128 and m > 1:
        wrong = want.clone()
        wrong[-1] = want[-2]
        assert _row_rel_err(wrong, want) > _MATMUL_TOL[dtype]
    for tile in tmm.variants(dtype, m):
        n0 = tmm.launches
        got = tmm.matmul_fused(x, w, tile)
        torch.cuda.synchronize()
        assert tmm.launches == n0 + 1
        assert got.dtype == dtype and got.shape == (m, n)
        assert _row_rel_err(got, want) <= _MATMUL_TOL[dtype], tile


@pytest.mark.cuda
def test_matmul_autograd_uses_the_kernel_forward(cuda_device):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 17, 256).astype(np.float32))
    w = torch.from_numpy(rng.randn(256, 384).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 17, 384).astype(np.float32))
    xc, wc = x.clone().requires_grad_(), w.clone().requires_grad_()
    torch.matmul(xc, wc).backward(g)
    xg = x.to(cuda_device).requires_grad_()
    wg = w.to(cuda_device).requires_grad_()
    n0 = tmm.launches
    y = tmm.matmul_fused(xg, wg)
    y.backward(g.to(cuda_device))
    assert tmm.launches == n0 + 1
    assert _row_rel_err(y.detach().cpu(), torch.matmul(x, w)) <= 1e-5
    assert _row_rel_err(xg.grad.cpu(), xc.grad) <= 1e-5
    assert _row_rel_err(wg.grad.cpu(), wc.grad) <= 1e-5


@pytest.mark.cuda
def test_matmul_refuses_what_it_does_not_take(cuda_device):
    x = torch.randn(8, 256, device=cuda_device)
    with pytest.raises(ValueError, match="supports"):
        tmm.matmul_fused(x, torch.randn(256, 200, device=cuda_device))
    with pytest.raises(TypeError):
        tmm.matmul_fused(x.half(), torch.randn(256, 128, device=cuda_device)
                         .half())
    with pytest.raises(ValueError, match="variants"):
        tmm.matmul_fused(x, torch.randn(256, 128, device=cuda_device), 128)
    with pytest.raises(ValueError, match="variants"):  # m > 16
        tmm.matmul_fused(torch.randn(17, 256, device=cuda_device).bfloat16(),
                         torch.randn(256, 128, device=cuda_device).bfloat16(),
                         "skinny")


_GROUPED_LENS = (0, 1, 15, 16, 17, 127, 128, 129, 1000, 2049)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_heads,kv_heads", [(32, 32), (32, 8), (12, 2),
                                              (16, 1), (32, 1), (64, 2),
                                              (40, 2)])
def test_grouped_decode_kernel_matches_plain(cuda_device, dtype, q_heads,
                                             kv_heads):
    """Against the dense plain version and the per-page kernel; then with
    the table entries past each row's pages made ids far out of the pool,
    which the kernel must never read."""
    lens = _GROUPED_LENS
    q, kp, vp, tables, ln = _decode_case(cuda_device, dtype, len(lens),
                                         q_heads, kv_heads, 128, 16, 136,
                                         lens, seed=q_heads + kv_heads)
    n0 = tpa.grouped_launches
    got = tpa.paged_attention_grouped(q, kp, vp, tables, ln)
    torch.cuda.synchronize()
    assert tpa.grouped_launches == n0 + 1
    assert _close(got, tpa.paged_attention_ref(q, kp, vp, tables, ln), dtype)
    assert _close(got, tpa.paged_attention(q, kp, vp, tables, ln), dtype)
    assert not got[0].any()  # a ctx == 0 row writes zeros
    stale = tables.clone()
    for row, n in enumerate(lens):
        stale[row, -(-n // 16):] = 2 ** 30
    again = tpa.paged_attention_grouped(q, kp, vp, stale, ln)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_grouped_decode_refuses_what_it_does_not_take(cuda_device):
    args = _decode_case(cuda_device, torch.float32, 2, 4, 2, 128, 16, 12,
                        (3, 5))
    with pytest.raises(ValueError, match="multiple"):
        tpa.paged_attention_grouped(*args)
    args = _decode_case(cuda_device, torch.float32, 2, 4, 2, 128, 8, 16,
                        (3, 5))
    with pytest.raises(ValueError, match="16-token"):
        tpa.paged_attention_grouped(*args)
    q, kp, vp, tables, ln = _decode_case(cuda_device, torch.float32, 2, 4, 2,
                                         128, 16, 8, (3, 5))
    with pytest.raises(TypeError):
        tpa.paged_attention_grouped(q, kp.to(torch.int8), vp.to(torch.int8),
                                    tables, ln)


@pytest.mark.cuda
def test_decode_dispatch_follows_the_grouped_flag(cuda_device,
                                                  flags_restored):
    args = _decode_case(cuda_device, torch.bfloat16, 3, 8, 2, 128, 16, 16,
                        (5, 200, 0))
    counts = tpa.launches, tpa.grouped_launches
    tpa.paged_attention_dispatch(*args)
    set_flags({"FLAGS_paged_grouped_kernel": True})
    tpa.paged_attention_dispatch(*args)
    torch.cuda.synchronize()
    assert (tpa.launches, tpa.grouped_launches) == (counts[0] + 1,
                                                    counts[1] + 1)


@pytest.mark.cuda
def test_tuner_times_the_kernels_on_the_card(cuda_device, flags_restored):
    """FLAGS_autotune=on: the default timer (a CUDA graph of launches timed
    by events) times torch.matmul and every GEMM variant for the bucket's m
    (m = 8: the two decode kernels), and the grouped and per-page decode,
    then saves the table."""
    set_flags({"FLAGS_autotune": "on", "FLAGS_paged_grouped_kernel": True})
    win = tat.choose_matmul(8, 512, 256, torch.bfloat16)
    assert win is not None
    args = _decode_case(cuda_device, torch.bfloat16, 4, 8, 2, 128, 16, 32,
                        (5, 200, 0, 511))
    dwin = tat.choose_paged_decode(4, 8, 2, 128, 16, 32, torch.bfloat16,
                                   False)
    assert dwin.meta["impl"] in ("paged", "grouped")
    table = tat.get_tuner().snapshot()
    mm = [e for key, e in table.items() if key.startswith("matmul|")]
    pd = [e for key, e in table.items() if key.startswith("paged_decode|")]
    assert len(mm) == 1 and set(mm[0]["timings_ms"]) == {
        "torch", "cuda:skinny", "cuda:m16"}
    assert len(pd) == 1 and set(pd[0]["timings_ms"]) == {"paged", "grouped"}
    for e in mm + pd:
        assert all(0 < t < 100 for t in e["timings_ms"].values())
    assert (flags_restored / f"autotune_{tat.device_kind()}.json").is_file()
    out = tpa.paged_attention_dispatch(*args)
    torch.cuda.synchronize()
    assert _close(out, tpa.paged_attention_ref(*args), torch.bfloat16)


@pytest.mark.cuda
def test_tiny_engine_with_grouped_decode_and_gemm_kernel_equals_cpu(
        cuda_device, flags_restored):
    """Head_dim 128, 16-token pages, tables 8 pages wide: with the grouped
    flag on and a timer that makes the GEMM kernel win every bucket, CUDA
    serves through both new kernels and the CPU through their plain
    versions; the greedy streams are equal."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2, seq=128)
    cfg.num_key_value_heads = 1
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=0)
    gpu = LlamaForCausalLM(cfg, device=cuda_device)
    load_llama_state(gpu, {k: v.numpy() for k, v in cpu.state_dict().items()})
    set_flags({"FLAGS_autotune": "on", "FLAGS_paged_grouped_kernel": True})
    # torch.matmul 1 ms, the per-page decode 2 ms, the new kernels 0.5 ms
    tat.set_timer(lambda fn, args: {"matmul": 1.0, "paged": 2.0}.get(
        fn.__name__, 0.5))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, (n,)) for n in (5, 9, 17, 3)]
    counts = tmm.launches, tpa.grouped_launches, tpa.launches
    streams = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        eng = ServingEngine(model, max_batch=3, max_seq_len=128,
                            page_size=16, device=dev)
        for p in prompts:
            eng.add_request(p, max_new_tokens=12)
        streams.append({f.request_id: f.output_ids.tolist()
                        for f in eng.run()})
    assert tmm.launches > counts[0] and tpa.grouped_launches > counts[1]
    assert tpa.launches == counts[2]
    assert streams[0] == streams[1]


def _packed_ids(g, b, s, pad, device):
    """[b, s] int32 ids of packed sequences of random lengths (1-200),
    the last `pad` positions -1."""
    ids = torch.full((b, s), -1, dtype=torch.int32)
    for i in range(b):
        pos, sid = 0, 0
        while pos < s - pad:
            n = min(int(torch.randint(1, 200, (), generator=g)),
                    s - pad - pos)
            ids[i, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return ids.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["seg", "drop", "seg_drop"])
@pytest.mark.parametrize("s_q,s_kv,causal", [
    (256, 256, True), (256, 256, False), (128, 384, True), (384, 128, False)])
def test_flash_variant_kernels_match_plain(cuda_device, dtype, variant, s_q,
                                           s_kv, causal):
    """b = 2 of 3 heads (row bh reads the ids of batch bh // 3), padded
    queries (-1) and keys (-2) where there are segments."""
    g = torch.Generator().manual_seed(s_q * 7 + s_kv)
    b, h, d, scale = 2, 3, 128, 128 ** -0.5
    seg = variant != "drop"
    sq = sk = None
    if seg:
        sq = _packed_ids(g, b, s_q, 40, cuda_device)
        sk = _packed_ids(g, b, s_kv, 24, cuda_device)
        sk = torch.where(sk < 0, -2, sk).to(torch.int32)
    var = tfa.Variant(sq, sk, heads=h, rate=0.0 if variant == "seg" else
                      0.2, seed=-12345)
    assert var.name == variant

    def rnd(s):
        return torch.randn(b * h, s, d, generator=g).to(cuda_device, dtype)

    q, k, v, do = rnd(s_q), rnd(s_kv), rnd(s_kv), rnd(s_q)
    counts = {p: tfa.variant_launches[(p, variant)] for p in tfa.PASSES}
    out, lse = tfa.flash_fwd(q, k, v, scale, causal, var)
    delta = tfa.flash_bwd_delta(out, do)
    dq, dk, dv = tfa.flash_bwd(q, k, v, do, lse, delta, scale, causal, var)
    torch.cuda.synchronize()
    assert all(tfa.variant_launches[(p, variant)] == counts[p] + 1
               for p in tfa.PASSES)
    out_ref, lse_ref = tfa.flash_fwd_ref(q, k, v, scale, causal, var)
    assert _row_rel_err(out, out_ref) <= _FLASH_TOL[dtype]
    live = lse_ref > -1e29
    torch.testing.assert_close(lse[live], lse_ref[live], rtol=0, atol=1e-3)
    assert torch.equal(lse[~live], lse_ref[~live]) and not out[~live].any()
    dq_ref, dk_ref, dv_ref = tfa.flash_bwd_ref(q, k, v, do, lse_ref, delta,
                                               scale, causal, var)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert _row_rel_err(got, want) <= _FLASH_TOL[dtype]


def _aligned_ids(g, b, s, device):
    """[b, s] int32 ids of packed sequences of 64-192 tokens in steps of
    64: every 64-row tile inside one segment (the forward's mask-free
    tiles)."""
    ids = torch.empty((b, s), dtype=torch.int32)
    for i in range(b):
        pos, sid = 0, 0
        while pos < s:
            n = min(64 * int(torch.randint(1, 4, (), generator=g)), s - pos)
            ids[i, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return ids.to(device)


def _fwd_diag_shift(q, k, v, scale):
    """The causal forward with its diagonal one key late, in f32."""
    s_q, s_kv = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    rows = torch.arange(s_q, device=q.device)[:, None]
    cols = torch.arange(s_kv, device=q.device)[None, :]
    s = s.masked_fill(rows + (s_kv - s_q) + 1 < cols, float("-inf"))
    out = torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), v.float())
    return out.nan_to_num().to(q.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "seg", "drop", "seg_drop"])
@pytest.mark.parametrize("pattern", ["s192", "aligned"])
def test_flash_forward_kernel_at_its_edges(cuda_device, variant, pattern):
    """The bf16 mma.sync forward, each body: "s192" is s_q = 192 over
    s_kv = 320, causal (a q tile cut short, bottom-right aligned), beside
    the fault of a diagonal one key late; "aligned" is 512 tokens of
    tile-aligned segments, causal, the seg tiles taken mask-free."""
    g = torch.Generator().manual_seed(len(variant) * 31 + len(pattern))
    b, h, d, scale = 2, 2, 128, 128 ** -0.5
    s_q, s_kv = (192, 320) if pattern == "s192" else (512, 512)
    sq = sk = None
    if variant in ("seg", "seg_drop"):
        if pattern == "aligned":
            sq = sk = _aligned_ids(g, b, s_q, cuda_device)
        else:
            sq = _packed_ids(g, b, s_q, 16, cuda_device)
            sk = _packed_ids(g, b, s_kv, 0, cuda_device)
    var = None if variant == "plain" else tfa.Variant(
        sq, sk, heads=h, rate=0.2 if "drop" in variant else 0.0, seed=99)

    def rnd(s):
        return torch.randn(b * h, s, d, generator=g).to(cuda_device,
                                                        torch.bfloat16)

    q, k, v = rnd(s_q), rnd(s_kv), rnd(s_kv)
    n0 = tfa.variant_launches[("fwd", variant)]
    out, lse = tfa.flash_fwd(q, k, v, scale, True, var)
    torch.cuda.synchronize()
    assert tfa.variant_launches[("fwd", variant)] == n0 + 1
    out_ref, lse_ref = tfa.flash_fwd_ref(q, k, v, scale, True, var)
    tol = _FLASH_TOL[torch.bfloat16]
    assert _row_rel_err(out, out_ref) <= tol
    live = lse_ref > -1e29
    torch.testing.assert_close(lse[live], lse_ref[live], rtol=0, atol=1e-3)
    assert torch.equal(lse[~live], lse_ref[~live]) and not out[~live].any()
    if variant == "plain":
        assert _row_rel_err(_fwd_diag_shift(q, k, v, scale), out_ref) > tol


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attn_unpadded_runs_the_seg_kernels(cuda_device, causal, rate):
    """The packed entry on CUDA (seg or seg_drop kernels) against the same
    call on the CPU (their plain versions), forward and gradients."""
    lens = [300, 5, 700, 64, 211]
    cu = torch.tensor([0] + np.cumsum(lens).tolist(), dtype=torch.int32)
    g = torch.Generator().manual_seed(len(lens))
    q, k, v, gr = (torch.randn(sum(lens), 4, 128, generator=g)
                   for _ in range(4))
    name = "seg_drop" if rate else "seg"
    counts = {p: tfa.variant_launches[(p, name)] for p in tfa.PASSES}
    res = []
    for dev in (cuda_device, "cpu"):
        ts = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out, _ = tfa.flash_attn_unpadded(*ts, cu.to(dev), cu.to(dev),
                                         max(lens), max(lens), dropout=rate,
                                         causal=causal, dropout_seed=77)
        out.backward(gr.to(dev))
        res.append([out.detach().cpu()] + [t.grad.cpu() for t in ts])
    assert all(tfa.variant_launches[(p, name)] == counts[p] + 1
               for p in tfa.PASSES)
    for got, want in zip(*res):
        assert _row_rel_err(got, want) <= _FLASH_TOL[torch.float32]


@pytest.mark.cuda
def test_sdpa_dropout_with_the_flag_runs_the_drop_kernels(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(2, 256, 4, 128, generator=g, device=cuda_device,
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    old = get_flags(["FLAGS_flash_dropout_kernel"])
    set_flags({"FLAGS_flash_dropout_kernel": True})
    try:
        counts = dict(tfa.variant_launches)
        ptt.seed(5)
        out = F.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                             is_causal=True)
        out.float().square().sum().backward()
        ptt.seed(5)
        again = F.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                               is_causal=True)
    finally:
        set_flags(old)
    torch.cuda.synchronize()
    assert tfa.variant_launches[("fwd", "drop")] == \
        counts[("fwd", "drop")] + 2
    assert tfa.variant_launches[("bwd", "drop")] == \
        counts[("bwd", "drop")] + 1
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_lse_entry_on_cuda_matches_cpu(cuda_device):
    g = torch.Generator().manual_seed(4)
    q, k, v, go = (torch.randn(1, 256, 3, 128, generator=g)
                   for _ in range(4))
    gl = torch.randn(1, 3, 256, generator=g)
    res = []
    for dev in (cuda_device, "cpu"):
        ts = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out, lse = tfa.flash_attention_with_lse_bshd(*ts, causal=True)
        (torch.sum(out * go.to(dev)) + torch.sum(lse * gl.to(dev))) \
            .backward()
        res.append([out.detach().cpu(), lse.detach().cpu()]
                   + [t.grad.cpu() for t in ts])
    torch.testing.assert_close(res[0][1], res[1][1], rtol=0, atol=1e-4)
    for got, want in zip(res[0][:1] + res[0][2:], res[1][:1] + res[1][2:]):
        assert _row_rel_err(got, want) <= _FLASH_TOL[torch.float32]


@pytest.mark.cuda
def test_fused_encoder_attention_dropout_equals_cpu(cuda_device):
    """attn_dropout_rate 0.1, dropout_rate 0, f32, from the same weights and
    seed: CUDA through the drop kernels, the CPU through their plain
    versions, the same masks (the seeds come from the host stream)."""
    old = get_flags(["FLAGS_flash_dropout_kernel"])
    set_flags({"FLAGS_flash_dropout_kernel": True})
    try:
        ptt.seed(0)
        cpu = FusedTransformerEncoderLayer(256, 2, 512, dropout_rate=0.0,
                                           attn_dropout_rate=0.1,
                                           activation="gelu",
                                           normalize_before=True,
                                           device="cpu")
        gpu = FusedTransformerEncoderLayer(256, 2, 512, dropout_rate=0.0,
                                           attn_dropout_rate=0.1,
                                           activation="gelu",
                                           normalize_before=True,
                                           device=cuda_device)
        gpu.load_state_dict(fused_encoder_state_from_numpy(
            fused_encoder_state_to_numpy(cpu), gpu))
        x = torch.randn(2, 256, 256, generator=torch.Generator()
                        .manual_seed(1))
        n0 = tfa.variant_launches[("fwd", "drop")]
        outs = []
        for layer, dev in ((cpu, "cpu"), (gpu, cuda_device)):
            ptt.seed(9)
            out = layer(x.to(dev))
            out.square().sum().backward()
            outs.append(out.detach().cpu())
    finally:
        set_flags(old)
    assert tfa.variant_launches[("fwd", "drop")] == n0 + 1
    assert _row_rel_err(outs[1], outs[0]) <= _FLASH_TOL[torch.float32]
    for (name, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        if p.grad is None:  # the post-LN norms of a pre-LN layer
            assert q.grad is None, name
            continue
        assert _row_rel_err(q.grad.cpu().reshape(-1, p.shape[-1]),
                            p.grad.reshape(-1, p.shape[-1])) <= 1e-3, name


@pytest.mark.cuda
def test_flash_variants_refuse_what_they_do_not_take(cuda_device):
    q = torch.randn(4, 128, 128, device=cuda_device)
    ids = torch.zeros(2, 128, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="segment ids"):
        tfa.flash_fwd(q, q, q, 0.1, False,
                      tfa.Variant(ids.long(), ids.long(), heads=2))
    with pytest.raises(ValueError, match="segment ids"):
        tfa.flash_fwd(q, q, q, 0.1, False, tfa.Variant(ids, ids, heads=3))
    with pytest.raises(ValueError, match="one CUDA device"):
        tfa.flash_fwd(q, q, q, 0.1, False,
                      tfa.Variant(ids.cpu(), ids.cpu(), heads=2))
    keep = torch.ones(4, 128, 128, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="regenerate"):
        tfa.flash_fwd(q, q, q, 0.1, False,
                      tfa.Variant(rate=0.1, seed=1, keep=keep))



# ---------------------------------------------------------------------------
# the Adam / AdamW update in one pass (csrc/adam.cu)
# ---------------------------------------------------------------------------


def _adam_inputs(shape, dtype, master, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
    g = (torch.randn(shape, generator=gen, device=dev) * 1e-2).to(dtype)
    m1 = torch.randn(shape, generator=gen, device=dev) * 1e-3
    m2 = torch.randn(shape, generator=gen, device=dev).square() * 1e-6
    mw = p.float() + torch.randn(shape, generator=gen, device=dev) * 1e-5 \
        if master else None
    return [p, g, m1, m2, mw]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 4096), (4097,), (7,), (3, 33)])
@pytest.mark.parametrize("dtype,master", [(torch.bfloat16, False),
                                          (torch.bfloat16, True),
                                          (torch.float16, False),
                                          (torch.float32, False)])
@pytest.mark.parametrize("kind", ["adam", "adamw"])
@pytest.mark.parametrize("offset", [0, 1])
def test_adam_kernel_matches_plain(cuda_device, shape, dtype, master, kind,
                                   offset):
    """One update by the kernel and by its plain version (each f32
    operation rounded on its own, in the same order) on copies of the same
    tensors: equal bit for bit. offset 1: every tensor one element off a
    16-byte boundary (the element-by-element path)."""
    from paddle_tpu_torch.kernels import adam as kadam

    n = math.prod(shape)
    base = _adam_inputs((n + offset,), dtype, master, cuda_device)
    ts = [None if t is None else t[offset:].reshape(shape) for t in base]
    coeff, wd = (0.1, 0.0) if kind == "adamw" else (0.0, 0.1)
    args = (0.9, 0.999, 1e-8, 1e-3, coeff, wd, np.float32(0.1),
            np.float32(0.001))
    got = [None if t is None else t.clone() for t in ts]
    want = [None if t is None else t.clone() for t in ts]
    if offset:  # clones are aligned: take unaligned views again
        got = [None if t is None else
               torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].reshape(shape)
               for t in got]
    n0 = kadam.launches
    kadam.adam_update(*got, *args)
    kadam.adam_update_ref(*want, *args)
    torch.cuda.synchronize()
    assert kadam.launches == n0 + 1
    for a, b in zip(got, want):
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_adam_kernel_runs_the_optimizer_and_refuses_what_it_does_not_take(
        cuda_device):
    from paddle_tpu_torch.kernels import adam as kadam

    ps = [torch.nn.Parameter(torch.randn(64, 32, device=cuda_device)
                             .bfloat16()) for _ in range(3)]
    opt = AdamW(learning_rate=1e-3, parameters=ps, multi_precision=True)
    for p in ps:
        p.grad = torch.randn_like(p)
    n0 = kadam.launches
    opt.step()
    assert kadam.launches == n0 + 3
    p, g, m1, m2, _ = _adam_inputs((16,), torch.float32, False, cuda_device)
    args = (0.9, 0.999, 1e-8, 1e-3, 0.0, 0.0, 0.1, 0.001)
    with pytest.raises(TypeError):
        kadam.adam_update(p, g, m1.double(), m2, None, *args)
    with pytest.raises(TypeError):
        kadam.adam_update(p, g, m1, m2, m1.clone(), *args)
    with pytest.raises(ValueError):
        kadam.adam_update(p, g[:8], m1, m2, None, *args)
    with pytest.raises(ValueError):
        kadam.adam_update(p, g, m1.cpu(), m2, None, *args)


def _window_case(dev, dtype, quant, seed=0, d=128, kvh=2, q_heads=4):
    """Pools of 12 pages of 16 tokens, 4 rows with 3-page tables, ragged
    starts, a window of 20 tokens: row 0 overhangs its limit, row 2 is
    inactive."""
    g = torch.Generator().manual_seed(seed)
    shape = (kvh, 13, 16, d)  # page 12: the scratch page
    if quant:
        kp = torch.randint(-127, 128, shape, generator=g).to(torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g).to(torch.int8)
        ks = torch.rand(shape[:3], generator=g) * 0.02 + 0.001
        vs = torch.rand(shape[:3], generator=g) * 0.02 + 0.001
    else:
        kp = torch.randn(shape, generator=g).to(dtype)
        vp = torch.randn(shape, generator=g).to(dtype)
        ks = vs = None
    tables = torch.tensor([[3, 7, 0], [4, 5, 1], [6, 2, 8], [9, 10, 11]],
                          dtype=torch.int32)
    start = torch.tensor([5, 0, 14, 2], dtype=torch.int32)
    limit = torch.tensor([20, 20, 34, 11], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    q = torch.randn(4, 20, q_heads, d, generator=g).to(dtype)
    k_seq = torch.randn(4, 20, kvh, d, generator=g).to(dtype)
    v_seq = torch.randn(4, 20, kvh, d, generator=g).to(dtype)
    host = (q, kp, vp, ks, vs, k_seq, v_seq)
    on = tuple(None if t is None else t.to(dev) for t in host)
    return host, on, (tables, start, limit, active)


@pytest.mark.cuda
@pytest.mark.parametrize("scratch", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_window_writers_on_cuda_match_cpu(cuda_device, quant, scratch):
    """The window writers on CUDA tensors write what they write on the
    CPU: the same positions, float values bit for bit, int8 values within
    one step and their scales within one f32 rounding (a division on
    another unit). Host masks and tables on both."""
    results = []
    for side in (0, 1):
        case = _window_case(cuda_device, torch.bfloat16, quant)
        (_, kp, vp, ks, vs, k_seq, v_seq) = case[side]
        tables, start, limit, active = case[2]
        kw = dict(limit_lens=limit, active=active,
                  scratch_page=12 if scratch else None)
        if quant:
            out = tpa.scatter_paged_kv_window_q8(kp, ks, vp, vs, k_seq,
                                                 v_seq, tables, start, **kw)
        else:
            out = tpa.scatter_paged_kv_window(kp, vp, k_seq, v_seq, tables,
                                              start, **kw)
        torch.cuda.synchronize()
        results.append([t[:, :12].cpu() for t in out])
    for want, got in zip(*results):
        if got.dtype == torch.int8:
            assert (got.int() - want.int()).abs().max() <= 1
        elif quant:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        else:
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_attention_on_cuda_matches_cpu(cuda_device, dtype, quant):
    """The window attention on CUDA tensors against the CPU's, f32 inside:
    bf16 outputs within one rounding, f32 within summation order; an
    inactive row is 0 on both."""
    host, on, (tables, start, _limit, active) = _window_case(
        cuda_device, dtype, quant)
    outs = []
    for q, kp, vp, ks, vs, _k, _v in (host, on):
        outs.append(tpa.paged_attention_window(
            q, kp, vp, tables.to(q.device), start, k_scales=ks, v_scales=vs,
            active=active).cpu())
    want, got = outs
    assert not got[2].any()
    assert _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"])
def test_window_chunked_engine_on_cuda_equals_cpu(cuda_device, kv):
    """The prefix cache and chunk rounds of 16 tokens on the card (burst 4:
    prefilling rows stay inactive in the captured graphs): greedy streams
    equal to the CPU's, the shared prompt hits, nothing is captured twice,
    and the page counts close."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2, seq=64)
    cfg.num_key_value_heads = 1
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=0)
    gpu = LlamaForCausalLM(cfg, device=cuda_device)
    load_llama_state(gpu, {k: v.numpy() for k, v in cpu.state_dict().items()})
    rng = np.random.RandomState(1)
    shared = rng.randint(0, 256, (24,))
    prompts = [np.concatenate([shared, rng.randint(0, 256, (n,))])
               for n in (3, 9, 1, 14)]
    kw = dict(kv_cache_quant=kv, prefix_cache=1, prefill_chunk=16)
    streams = []
    for model, dev, extra in ((cpu, "cpu", {}),
                              (gpu, cuda_device, dict(decode_burst=4))):
        e = ServingEngine(model, max_batch=3, max_seq_len=64, page_size=8,
                          device=dev, seed=3, **kw, **extra)
        out = []
        for p in prompts:  # one at a time: the later ones hit the trie
            rid = e.add_request(p, max_new_tokens=12)
            out.append({f.request_id: f.output_ids.tolist()
                        for f in e.run()}[rid])
        for p in prompts[1:]:  # together: chunk rounds between bursts
            e.add_request(p, max_new_tokens=12)
        out += [f.output_ids.tolist()
                for f in sorted(e.run(), key=lambda f: f.request_id)]
        streams.append(out)
        assert e._prefix_hits_total > 0 and e.chunk_rounds > 0
        refs = e._page_refs
        assert sum(r > 0 for r in refs) + len(e._free_pages) == len(refs)
        assert sum(refs) == len(e._prefix_cache)  # drained: the trie's
    assert streams[0] == streams[1]
    assert e.graph_captures == len(e._burst_fns) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("window", [2, 5, 8])
@pytest.mark.parametrize("heads", [(32, 8), (32, 32)], ids=["gqa", "mha"])
@pytest.mark.parametrize("dtype,quant", [(torch.bfloat16, False),
                                         (torch.float32, False),
                                         (torch.bfloat16, True)])
def test_spec_window_rows_kernel_matches_window_attention(
        cuda_device, dtype, quant, heads, window):
    """The speculative verify's attention (`paged_attention_window_rows`:
    the window as decode rows through the paged decode kernel, one launch)
    against the gathered window attention on the CPU at every position
    below its row's limit (bf16 within one rounding, f32 within summation
    order); a position at or past the limit against the CPU's decode at
    the limit's context; an inactive row 0."""
    q_heads, kvh = heads
    g = torch.Generator().manual_seed(window)
    shape = (kvh, 40, 16, 128)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=g).to(torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g).to(torch.int8)
        ks = torch.rand(shape[:3], generator=g) * 0.02 + 0.001
        vs = torch.rand(shape[:3], generator=g) * 0.02 + 0.001
    else:
        kp = torch.randn(shape, generator=g).to(dtype)
        vp = torch.randn(shape, generator=g).to(dtype)
        ks = vs = None
    tables = torch.randperm(40, generator=g)[:32].reshape(4, 8) \
        .to(torch.int32)
    lens = torch.tensor([0, 15, 16, 100], dtype=torch.int32)
    limit = lens + torch.tensor([window, 2, window, 1], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    q = torch.randn(4, window, q_heads, 128, generator=g).to(dtype)
    on = [None if t is None else t.to(cuda_device)
          for t in (q, kp, vp, ks, vs, tables, lens, limit, active)]
    counter = "q8_launches" if quant else "launches"
    n0 = getattr(tpa, counter)
    rows = tpa.window_rows(on[5], on[6], window, limit_lens=on[7],
                           active=on[8])
    got = tpa.paged_attention_window_rows(on[0], on[1], on[2], rows,
                                          k_scales=on[3], v_scales=on[4])
    torch.cuda.synchronize()
    assert getattr(tpa, counter) == n0 + 1
    got = got.cpu()
    want = tpa.paged_attention_window(q, kp, vp, tables, lens, k_scales=ks,
                                      v_scales=vs)
    below = (lens[:, None] + torch.arange(window)) < limit[:, None]
    keep = below & active[:, None]
    assert _close(got[keep], want[keep], dtype)
    assert not got[3].any()
    for b, w in (~below & active[:, None]).nonzero().tolist():
        at = tpa.paged_attention_ref(q[b:b + 1, w], kp, vp, tables[b:b + 1],
                                     limit[b:b + 1], k_scales=ks,
                                     v_scales=vs)
        assert _close(got[b, w][None], at, dtype)


def _tiny_spec_streams(model, dev, prompts, graphs=True, **kw):
    eng = ServingEngine(model, max_batch=3, max_seq_len=64, page_size=8,
                        device=dev, seed=3, spec_decode=4, **kw)
    eng._spec_graphs = graphs and eng._spec_graphs
    eng.warmup()
    captures = eng.graph_captures
    for i, p in enumerate(prompts):
        eng.add_request(p, max_new_tokens=20 - i)
    out = {f.request_id: f.output_ids.tolist() for f in eng.run()}
    assert eng.graph_captures == captures  # nothing captured in traffic
    return out, eng


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("draft", [None, "draft", "target"])
def test_spec_graphs_equal_eager_and_cpu_streams(cuda_device, kv, draft):
    """spec_decode=4 on the card: warmup captures the draft and the verify
    graph, a round replays them, and the greedy streams equal the same
    engine's run eagerly on the card and the CPU's, with the same proposed
    and accepted totals (head_dim 128: the paged decode and RMSNorm
    kernels run), shallow exit, with a 1-layer draft model and with the
    target as its own draft model (every draft accepted: its pools hold
    the prompts and each draft's K/V)."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2, seq=64)
    cfg.num_key_value_heads = 1
    dcfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=1, heads=2, seq=64)
    dcfg.num_key_value_heads = 1
    models = {}
    for name, c, seed in (("target", cfg, 0), ("draft", dcfg, 5)):
        cpu = LlamaForCausalLM(c, device="cpu", seed=seed)
        gpu = LlamaForCausalLM(c, device=cuda_device)
        load_llama_state(gpu, {k: v.numpy()
                               for k, v in cpu.state_dict().items()})
        models[name] = cpu, gpu
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, (n,)) for n in (5, 9, 17, 3, 40)]
    runs = []
    for side, dev, graphs in ((0, "cpu", False), (1, cuda_device, False),
                              (1, cuda_device, True)):
        kw = dict(kv_cache_quant=kv)
        if draft:
            kw["draft_model"] = models[draft][side]
        runs.append(_tiny_spec_streams(models["target"][side], dev, prompts,
                                       graphs=graphs, **kw))
    (want, cpu_eng), (eager, _), (got, eng) = runs
    assert got == eager == want
    assert eng.graph_captures == 2 and eng.graph_replays > 0
    assert set(eng._spec_draft_fns) == {4 if draft else 3}
    assert eng.spec_rounds > 0
    assert (eng._spec_proposed_total, eng._spec_accepted_total) == \
        (cpu_eng._spec_proposed_total, cpu_eng._spec_accepted_total)
    if draft == "target":
        assert eng._spec_accepted_total == eng._spec_proposed_total


def _gpt_pair(dev, layers=2, seq=128):
    """A tiny f32 GPT (vocab 256, hidden 256, 2 heads of 128) on the CPU
    and the same weights on `dev`, every bias and norm weight moved off its
    initial value."""
    cfg = GPTConfig.tiny(vocab=256, hidden=256, layers=layers, heads=2,
                         seq=seq)
    cpu = GPTForCausalLM(cfg, device="cpu", seed=layers)
    with torch.no_grad():
        g = torch.Generator().manual_seed(7)
        for p in cpu.parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    gpu = GPTForCausalLM(cfg, device=dev)
    load_gpt_state(gpu, gpt_state_to_numpy(cpu))
    return cpu, gpu


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["burst", "spec", "draft", "int8"])
def test_gpt_engine_on_cuda_equals_cpu(cuda_device, mode):
    """Greedy streams of a GPT (one KV head a query head, learned
    positions per row) on the card equal the CPU's: burst graphs, shallow
    speculation, a 1-layer GPT draft model, int8 KV under burst graphs."""
    cpu, gpu = _gpt_pair(cuda_device)
    kw = dict(burst=dict(decode_burst=4), spec=dict(spec_decode=4),
              int8=dict(decode_burst=4, kv_cache_quant="int8"),
              draft=dict(spec_decode=3))[mode]
    drafts = _gpt_pair(cuda_device, layers=1) if mode == "draft" else None
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, (n,)) for n in (5, 9, 17, 3, 40)]
    streams, n0 = [], tpa.launches + tpa.q8_launches
    for side, (model, dev) in enumerate(((cpu, "cpu"), (gpu, cuda_device))):
        extra = dict(kw)
        if drafts is not None:
            extra["draft_model"] = drafts[side]
        eng = ServingEngine(model, max_batch=3, max_seq_len=128, page_size=8,
                            device=dev, seed=3, **extra)
        eng.warmup()
        for i, p in enumerate(prompts):
            eng.add_request(p, max_new_tokens=20 - i)
        streams.append({f.request_id: f.output_ids.tolist()
                        for f in eng.run()})
    assert streams[0] == streams[1]
    assert tpa.launches + tpa.q8_launches > n0
    assert eng.graph_captures > 0 and eng.graph_replays > 0


@pytest.mark.cuda
def test_gpt_generate_and_training_on_cuda_match_cpu(cuda_device):
    cpu, gpu = _gpt_pair(cuda_device, seq=256)
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (2, 7)))
    outs = [m.generate(ids, max_new_tokens=12)[0].cpu() for m in (cpu, gpu)]
    assert torch.equal(*outs)
    before = {k: v.clone() for k, v in cpu.state_dict().items()}
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randint(0, 256, (2, 256)))
    y = torch.from_numpy(rng.randint(0, 256, (2, 256)))
    n0 = tfa.fwd_launches, tfa.bwd_launches
    losses = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        step = build_train_step(model, AdamW(learning_rate=1e-3,
                                             parameters=model.parameters()))
        losses.append([step(x.to(dev), y.to(dev)).item() for _ in range(3)])
    assert (tfa.fwd_launches, tfa.bwd_launches) == (n0[0] + 6, n0[1] + 6)
    assert max(abs(a - b) / abs(a) for a, b in zip(*losses)) <= 1e-4
    key = (torch.arange(768) % 384) // 128 == 1  # head-major [q | k | v]
    g_state = gpu.state_dict()
    for name, c in cpu.state_dict().items():
        dc, dg = c - before[name], g_state[name].cpu() - before[name]
        if name.endswith("qkv_proj.bias"):
            dc, dg = dc[~key], dg[~key]
        assert (dg - dc).norm() <= 1e-2 * dc.norm(), name


@pytest.mark.cuda
def test_gpt_positions_past_the_table_clamp_on_cuda(cuda_device):
    """A window at positions 62..65 of a 64-row table: no device assert,
    logits equal the CPU's (both clamp to the last row)."""
    cpu, gpu = _gpt_pair(cuda_device, seq=64)
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        eng = ServingEngine(model, max_batch=1, max_seq_len=64, page_size=8,
                            device=dev)
        ids = torch.tensor([[5, 6, 7, 8]], device=dev)
        lens = torch.tensor([62], dtype=torch.int32, device=dev)
        with torch.no_grad():
            logits, _ = model.forward_paged(
                ids, eng._caches, torch.from_numpy(eng.block_tables)
                .to(dev), lens, scratch_page=eng._scratch,
                limit_lens=lens + 2)
        outs.append(logits.cpu())
    torch.cuda.synchronize()
    assert torch.isfinite(outs[1]).all()
    assert _close(outs[1], outs[0], torch.float32)


@pytest.mark.cuda
def test_gpt_fused_multi_transformer_decode_on_cuda(cuda_device):
    """f32, 2 layers at head_dim 128: the causal context forward launches
    one flash kernel a layer; 8 decode steps at time_step over the dense
    caches equal the context forward's rows (the f32 flash bar)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    mt = FusedMultiTransformer(256, 2, 512, num_layers=2, device=cuda_device,
                               generator=g).eval()
    x = torch.randn(2, 256, 256, generator=g, device=cuda_device)
    with torch.no_grad():
        n0 = tfa.fwd_launches
        full = mt(x)
        assert tfa.fwd_launches == n0 + 2
        _, caches = mt(x[:, :248], caches=mt.gen_cache(2, 256), time_step=0)
        for t in range(248, 256):
            out, caches = mt(x[:, t:t + 1], caches=caches, time_step=t)
            err = (out[:, 0] - full[:, t]).norm(dim=-1) \
                / full[:, t].norm(dim=-1)
            assert err.max().item() <= _FLASH_TOL[torch.float32], t


@pytest.mark.cuda
def test_refresh_params_under_burst_graphs_serves_new_weights(cuda_device):
    """A `decode_burst=8` engine whose graphs were captured on the old
    weights serves the reloaded ones after `refresh_params()`: its greedy
    streams equal a fresh engine's on the new weights (the graphs read
    the parameters that `load_llama_state` copies into)."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2, seq=64)
    old = LlamaForCausalLM(cfg, device=cuda_device, seed=0)
    new = LlamaForCausalLM(cfg, device=cuda_device, seed=1)
    kw = dict(max_batch=2, max_seq_len=64, page_size=8, decode_burst=8,
              device=cuda_device)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, (n,)) for n in (5, 11)]

    def serve(e):
        rids = [e.add_request(p, max_new_tokens=17) for p in prompts]
        done = {f.request_id: f.output_ids.tolist() for f in e.run()}
        return [done[r] for r in rids]

    eng = ServingEngine(old, **kw)
    eng.warmup()
    before = serve(eng)
    captured = eng.graph_captures
    load_llama_state(old, llama_state_to_numpy(new))
    eng.refresh_params()
    after = serve(eng)
    assert eng.graph_captures == captured  # the same graphs replayed
    assert after == serve(ServingEngine(new, **kw)) and after != before


@pytest.mark.cuda
def test_lbfgs_on_cuda_matches_cpu(cuda_device):
    rng = np.random.RandomState(0)
    w0 = rng.randn(8, 8).astype(np.float32) * 0.3
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 8).astype(np.float32)
    out = []
    for dev in ("cpu", cuda_device):
        w = torch.nn.Parameter(torch.from_numpy(w0.copy()).to(dev))
        opt = LBFGS(learning_rate=0.2, max_iter=6, parameters=[w])
        tx, ty = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

        def closure():
            opt.clear_grad()
            loss = ((tx @ w - ty) ** 2).mean()
            loss.backward()
            return loss

        loss = opt.step(closure)
        assert loss.device.type == torch.device(dev).type
        out.append(w.detach().cpu().numpy())
    np.testing.assert_allclose(out[1], out[0], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_save_and_load_of_cuda_tensors(cuda_device, tmp_path):
    """A state on the card round-trips bit for bit (bf16 and f32, with
    requires_grad), lands on the card by default and on the CPU when asked;
    an AdamW state with CUDA moments resumes."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.nn.Parameter(torch.randn(64, 32, device=cuda_device,
                                       generator=g).bfloat16())
    st = {"w": w, "f": torch.randn(7, device=cuda_device, generator=g),
          "ids": torch.arange(5, device=cuda_device)}
    path = str(tmp_path / "s.pd")
    ptt.save(st, path)
    got = ptt.load(path)
    for k, v in st.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
        assert torch.equal(got[k], v.detach())
    assert got["w"].requires_grad and not got["f"].requires_grad
    assert ptt.load(path, device="cpu")["w"].device.type == "cpu"
    opt = AdamW(learning_rate=1e-3, parameters=[w])
    w.grad = torch.randn_like(w)
    opt.step()
    ptt.save(opt.state_dict(), path)
    fresh = AdamW(learning_rate=1e-3, parameters=[w])
    fresh.set_state_dict(ptt.load(path))
    a, b = opt.state_dict(), fresh.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]) and b[k].is_cuda


@pytest.mark.cuda
def test_tensor_checker_names_an_op_on_cuda(cuda_device):
    from paddle_tpu_torch.amp import debugging

    x = torch.tensor([0.0, 1.0], device=cuda_device)
    debugging.enable_tensor_checker()
    try:
        with pytest.raises(RuntimeError, match="aten.log"):
            torch.log(x)
        torch.exp(x)  # finite: passes
    finally:
        debugging.disable_tensor_checker()
    assert debugging.check_numerics(x) is x
    with pytest.raises(FloatingPointError):
        debugging.check_numerics(torch.log(x))
