#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out chip_smoke.json]

Run from the repository root; it builds its CUDA kernels itself. Phases:

1. device: the card's name, count, and `nvidia-smi` name and power limit;
2. build: every kernel under paddle_tpu_torch/kernels/csrc with nvcc;
3. each kernel against its plain PyTorch version at the serving and the
   training shapes (flash attention forward and backward, the backward one
   kernel for dQ, dK and dV, at [1, 4096, 32, 128] bf16 causal and not, a
   rectangular 1024x4096 causal case, a 256x128 causal case with fully
   masked rows, an f32 case, each held row by row and beside faults made
   from the plain versions, which must fail the same bar (the causal
   cases also beside the forward with its diagonal one key late); the
   RMSNorm forward and backward at LLaMA-2-7B's and 13B's decode and
   prefill shapes ([8, 4096], [4096, 4096], [8, 5120], [2512, 5120] bf16,
   the backward also f32) and float16, and untimed at odd widths (6,
   4100), rows past the ring (32768, 131072), no weight, a float32 weight
   and x 2 bytes off a 16-byte boundary, each row by row beside faults (a
   16-byte vector of a row left out of its sum of squares, one block's dw
   partial left out of the reduction), the backward called twice (dw
   bitwise equal); the
   dequant matmul at LLaMA-2-13B's projections, 5120->5120, 5120->13824
   and 13824->5120, at m = 8 (the one-launch decode kernel) and 2512 (the
   persistent wgmma kernel), int8 and int4 weights per channel and in
   groups, one small f32 case (the split kernel) and untimed m, n and k
   tails of the decode kernel, each called twice (bitwise equal) and held
   beside faults (a group's scales shifted, the first or the last k tile
   missing, int4 nibbles swapped, at decode one split partial of the
   in-launch reduce missing); the dense GEMM's every variant (bf16: the
   decode kernels at m <= 16, the persistent TMA + wgmma tiles 128x256 and
   128x128 above) at LLaMA-2-7B's linears, m = 8, 2512 and 4096, and at
   untimed m tails (1, 16, 17, 129, 4095) and n tails (256, 384, 11008),
   beside faults (a k tile dropped, a column tile shifted, an m tail's
   last row wrong); the float, int8 and grouped paged decodes at MHA and GQA
   heads, at 32/1 (multi-query) and 64/2 heads, and the float and int8 at
   head_dim 256, beside a fault with two chunks of a group's queries
   swapped; each new case held row by row and beside faults made from the
   plain version); after phase 4b, its device time, the plain version's, a
   library call's, and its bound;
4. LLaMA-2-7B (32 layers, hidden 4096, bf16, random weights from --seed)
   served by the paged-KV ServingEngine: one 2500-token request decoding
   past a 2048-token context, then 10 requests of 5-1000 tokens, greedy
   and sampled, through 8 slots; the kernels' launch counts are reset just
   before and checked just after; then a profiled warm 2500-token prefill
   and a profiled window of batch-8 decode steps give the device's busy
   time and idle share;
4b. LLaMA-2-13B (40 layers, hidden 5120, bf16, random weights from
   --seed, PyTorch's default initialisation): the last-position logits of
   a 64-token prompt in f32, in bf16, and after weight-only int8
   quantization (lm_head kept in bf16): int8 and bf16 agree within 0.05 of
   the largest, the bf16-f32 distance is read beside it; then served with an int8 paged KV cache, the same
   traffic as phase 4, the launch counts reset just before and checked
   just after (dequant matmul 280 and RMSNorm 81 per forward, int8 paged
   decode 40 per decode step, the float paged kernel none), a profiled
   prefill (its device time and the dequant matmul's share) and decode
   window; then a fresh bf16 13B model quantized to int4
   in groups of 128 serves the 10 requests with the same checks;
5. a tiny f32 LLaMA gives the same greedy streams on CUDA and on the CPU,
   in float, with int8 and int4 weights and an int8 KV cache, and as a
   multi-query model (32 heads of 32 over 1 KV head);
6. training: LLaMA-2-7B widths cut to 20 of 32 layers (memory: weights,
   gradients and AdamW's f32 moments of all 32 do not fit one card), bf16
   parameters (amp O2), AdamW(lr 1e-4), dense cross entropy, batch 1 x
   seq 4096 of random ids from --seed repeated each step, through
   build_train_step: one warm step, then 5 timed steps with the kernels'
   launch counts reset just before and checked just after (per step: flash
   forward and backward 20 each, RMSNorm forward and backward 41 each); then
   one profiled step gives the device's busy time, idle share and top
   kernels;
7. a tiny f32 LLaMA (head_dim 128) takes 3 AdamW steps on CUDA, through the
   kernels, and on the CPU, through their plain versions, from the same
   weights: losses and updates agree;
8. measured dispatch (FLAGS_autotune, FLAGS_paged_grouped_kernel): the 7B
   serving and a 4-layer training step with both flags on, exact launch
   counts from the tuner's winners (the GEMM's variants raced against
   cuBLAS, then the fastest variant pinned in every bucket);
9. varlen and dropout flash attention, with FLAGS_flash_dropout_kernel on:
   (a) the seg, drop and seg_drop bodies of the forward and backward
   kernels against their plain versions at [b*h, s, 128] (2 batch rows of
   8-16 heads, 2048-4096 tokens, bf16, and 512 tokens f32, causal and not;
   packed ids with padding), held row by row beside faults (segment ids
   shifted by a token, a mask keyed by tile-local positions, the seed off
   by one, dV from the undropped p, dQ without one key tile), with device
   times, bounds over the visible pairs (and the dropout mask's integer
   work), the plain versions' and SDPA's times; (b)
   `F.flash_attn_unpadded` at LLaMA-2-7B's attention width (32 heads of
   128, bf16) over sequences of 64-4096 tokens packed to 16384, causal,
   forward and backward at dropout 0 and 0.1, launches counted from zero,
   3 heads held against per-sequence attention; (c) 24 fused encoder
   layers at GPT-3 1.3B widths (d 2048, 16 heads, ffn 8192, vocab 50304)
   trained on masked-token prediction, batch 4 x 2048, bf16 O2, AdamW,
   attention and other dropout 0.1: a warm step and 3 timed steps with
   exactly 24 launches of each dropout kernel a step, the loss falling, the
   drop share of layer 0's mask within 0.005 of the rate; (d) the lse
   entry at [1, 4096, 32, 128] bf16 against the plain versions; (e) a tiny
   f32 encoder with attention dropout on CUDA and on the CPU from the same
   weights and seed.

Any failure raises and exits non-zero. The second-to-last line is the JSON
list of kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as TF

import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp, get_flags, set_flags
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.kernels import _build, autotune
from paddle_tpu_torch.kernels import flash_attention as kfa
from paddle_tpu_torch.kernels import matmul as kmm
from paddle_tpu_torch.kernels import paged_attention as kpa
from paddle_tpu_torch.kernels import quant_matmul as kqm
from paddle_tpu_torch.kernels import rms_norm as krms
from paddle_tpu_torch.models import build_train_step
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import Embedding, LayerNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.quant import quantize_for_inference, weight_quantize
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import (fused_encoder_state_from_numpy,
                                      fused_encoder_state_to_numpy,
                                      llama_state_to_numpy, load_llama_state)

# H100 SXM data-sheet peaks (dense): HBM bytes/s; f32 FLOP/s off the tensor
# cores (the RMSNorm and paged kernels' arithmetic); the tensor cores' bf16
# and TF32 rates (the flash kernels' products on bf16 and f32 inputs)
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
TF32_FLOP_S = 495e12
# the dropout mask's integer work: 132 SMs x 64 INT32 lanes x 1.98 GHz
# (the H100 SXM's boost clock), and the live 32-bit integer operations of
# one keep bit as `keep` in csrc/flash_attention.cu computes it, counting
# only what varies per pair (the third key and the `k + n` injection
# constants depend on the seed and the row alone) and what reaches the
# returned word: x1 = kpos + k1 (1); 20 rounds of add, rotate (one funnel
# shift), xor (60), less the last round's rotate and xor, which only x1
# reads (-2); the 4 inner injections add to x1 (4), while their x0 add joins
# the next round's add in one three-input add (0); the last injection's x0
# add (1; its x1 add is dead); the low 23 bits (1); x0 = qpos + k0 joins the
# first round's add (0). The float convert, multiply and compare run off
# the INT32 pipe.
INT32_OPS_S = 132 * 64 * 1.98e9
MASK_INT_OPS = 65
# bf16 / f16: one output rounding (2^-7 / 2^-10 relative); f32: summation
# order
TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
       torch.float32: 1e-5}
# RMSNorm, row by row (`rms_rows`): the kernel and the plain version
# compute the same f32 expression but for rstd's summation order (about
# 1e-7 relative), so a bf16 / f16 element differs by at most one rounding
# and only where its f32 value lies that close to a rounding boundary:
# rarely. A fault that moves rstd by 1e-4 and more flips a larger share of
# a row (`rms_case`'s control); rstd itself within RSTD_TOL a row.
RMS_SHARE = 0.01
RSTD_TOL = 1e-5
# RMSNorm cases checked but not timed: rows, cols, dtype, weight ("same",
# "f32" or None), offset (elements off a 16-byte boundary)
RMS_UNTIMED = [(37, 6, "bf16", "same", 0), (37, 4100, "bf16", "same", 0),
               (5, 4100, "f32", "same", 0), (4, 32768, "bf16", "same", 0),
               (3, 131072, "bf16", "f32", 0), (64, 4096, "bf16", None, 0),
               (64, 4096, "bf16", "f32", 0), (64, 4096, "f16", "f32", 0),
               (300, 4096, "bf16", "same", 1), (300, 5120, "f16", None, 1)]
# flash: the largest error of a row (a query's out or dQ, a key's dK or dV)
# relative to that row's norm (`row_rel_err`). bf16: P and dS rounded to
# bf16 before their products, then the output rounding, which alone may
# reach one ulp, 2^-7 relative; f32: split-TF32 products summed in the
# tensor cores. Each bar lies between the sound kernels' readings and
# those of faults made from the plain versions (`flash_controls`)
FLASH_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}
# the dequant matmul and the int8 paged decode, row by row: kernel and
# plain version dequantize to the same values and sum in f32, so they
# differ by summation order and, in bf16, by the output rounding of the
# few elements whose sums straddle a rounding boundary; each bar lies
# below the faults (`qmm_controls`, the paged "k_scales" control)
QUANT_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-4}
# the dense matmul, row by row against torch.matmul on the f32 values of
# its inputs: bf16 rows differ by the output's one rounding (2^-9 relative
# on average), f32 rows by summation order (exact f32 products); the faults
# of `mm_case` read 0.1 and more
MATMUL_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
# the grouped decode, row by row against the plain dense version (and the
# per-page kernel): bf16 one output rounding, f32 summation order in the
# softmax; the faults of `grouped_controls` lie far above
GROUPED_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-4}
# phase 8's training losses against cuBLAS's from the same weights: bf16
# products summed in another order, then one AdamW step whose sign-like
# update moves elements with rounding-level gradients either way
TRAIN_DISPATCH_TOL = 1e-2
# the decode dequant matmul's forced k split (every column tile cut into 3
# k ranges), whose in-launch reduce phase 3 holds beside a missing partial
DECODE_SPLITS = 3
# the grouped decode's cases: every partial-group edge (15-17, 127-129) and
# long contexts (tables of 256 pages, 4096 tokens)
GROUPED_LENS = [0, 1, 15, 16, 17, 127, 128, 129, 1000, 2049, 4096]
ALGO = {"int8": "weight_only_int8", "int4": "weight_only_int4"}


def log(*parts):
    print(*parts, flush=True)


def kernel_name(mangled):
    """name<args> of a kernel in an anonymous namespace, from its mangled
    name (`_ZN<n><namespace><m><name>I<args>E...`), the arguments as
    mangled (Lb0E is false, Lb1E true, f float)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled[:64]
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"\d+", rest)
    if not m:
        return mangled[:64]
    end = m.end() + int(m.group(0))
    args = rest[end:]
    return rest[m.end():end] + (args[:args.find("EE") + 2]
                                if args.startswith("I") else "")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def _device_events(prof):
    kind = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == kind]


def time_ms(fn, iters, warmup=3):
    """(ms, timer): device ms per call, the sum of the kernel intervals that
    torch.profiler saw over `iters` calls; where it sees none, CUDA events
    around the calls (which then include the host's launch time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in _device_events(prof))
    if us > 0:
        return us / 1e3 / iters, "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, "events"


def events_ms(fn, iters):
    """ms per call by CUDA events around `iters` back-to-back calls, after
    two warm ones: the device's time where each call keeps the device busy
    longer than the host takes to launch the next (phase 9's kernels, plain
    versions and SDPA calls, 0.1 ms and more). Phase 9 does not sum
    torch.profiler's records: late in this script's run the profiler kept
    one of ten device records of the ctypes launches in one profiling run,
    while a fresh process kept them all."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, flop_s=F32_FLOP_S, int_ops=0):
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM's
    rate and the operations over their units' rates, the products over
    flop_s and integer work (the dropout mask) over INT32_OPS_S, two
    units that run side by side."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = max(flops / flop_s, int_ops / INT32_OPS_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_rel_err(got, want):
    """Max over rows (the last dim) of ||got - want|| / ||want||, the
    denominator at least a quarter of the rms of the row norms: a row that
    is 0 but for rounding (the dQ of a query that sees one key, where
    p = 1 and dp = delta) is held to that floor, not to its own noise."""
    g, w = got.float(), want.float()
    num = (g - w).norm(dim=-1)
    den = w.norm(dim=-1)
    low = 0.25 * den.square().mean().sqrt()
    return (num / den.clamp_min(low.clamp_min(1e-30))).max().item()


def max_err(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype] * max(1.0, want.float().abs().max().item())
    return err, tol


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def rms_inputs(rows, cols, dtype, gen, dev, weight="same", offset=0,
               grad=False):
    """x (and g) [rows, cols] of `dtype`, `offset` elements into their
    buffers (1: 2 bytes off a 16-byte boundary in bf16 and f16), and the
    weight: "same" (x's dtype), "f32" or None."""
    def make(scale):
        buf = torch.randn(rows * cols + offset, generator=gen, device=dev)
        return (buf * scale).to(dtype)[offset:].view(rows, cols)

    x = make(2.0)
    w = None if weight is None else torch.randn(
        cols, generator=gen, device=dev).to(
            dtype if weight == "same" else torch.float32)
    return (x, w, make(1.0)) if grad else (x, w)


def rms_rows(got, want):
    """The row-by-row reading of an RMSNorm output against its plain
    version. bf16 / f16: "ulps", the largest difference in units of the
    last place of the plain value, and "share", the largest share of a
    row's elements that differ at all, less one element; f32: "row_rel",
    as `row_rel_err`."""
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        return dict(row_rel=row_rel_err(got, want))
    mant = 7 if got.dtype == torch.bfloat16 else 10
    tiny = torch.finfo(got.dtype).tiny
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(tiny))) - mant)
    differ = (g != w).sum(dim=-1).float()
    return dict(ulps=((g - w).abs() / ulp).max().item(),
                share=((differ - 1).clamp_min(0) / got.shape[-1])
                .max().item())


def rms_pass(reading):
    """The bar of `rms_rows`: bf16 / f16 every element within one rounding
    and at most RMS_SHARE of a row's elements (beyond one) differing; f32
    rows within TOL."""
    if "row_rel" in reading:
        return reading["row_rel"] <= TOL[torch.float32]
    return reading["ulps"] <= 1.0 and reading["share"] <= RMS_SHARE


def rstd_rel(got, want):
    return ((got - want).abs() / want).max().item()


def rms_vector_out(x, w, eps):
    """(y, rstd) of the plain forward with one 16-byte vector of row 0 left
    out of its sum of squares: the vector of the largest squares (at
    131072 columns a vector of small ones moves rstd by less than f32
    summation order does), the whole row where it is narrower."""
    xf = x.float()
    sq = xf.square()
    n = 16 // x.element_size()
    v = sq[0, :x.shape[-1] // n * n].view(-1, n).sum(dim=-1).argmax().item() \
        if x.shape[-1] >= n else 0
    sq[0, v * n:(v + 1) * n] = 0
    rstd = torch.rsqrt(sq.mean(dim=-1) + eps)
    y = xf * rstd[:, None]
    return (y if w is None else y * w.float()).to(x.dtype), rstd


def rms_case(name, rows, cols, dtype, gen, dev, weight="same", offset=0,
             timed=True, eps=1e-6):
    """The forward kernel against its plain version, row by row: y as
    serving calls it (no rstd) by `rms_rows`, and with rstd (y bitwise the
    same, rstd within RSTD_TOL a row); beside a fault, the plain version
    with the 16-byte vector of row 0 with the largest squares left out of
    its sum of squares, which must fail the same bar (in y's rows or in
    rstd's)."""
    x, w = rms_inputs(rows, cols, dtype, gen, dev, weight, offset)
    route = krms.route(x, w, False, torch.empty_like(x))["route"]
    got = krms.rms_norm(x, w, eps)
    got2, rstd = krms.rms_norm(x, w, eps, with_rstd=True)
    torch.cuda.synchronize()
    want, rstd_ref = krms.rms_norm_ref(x, w, eps, with_rstd=True)
    reading = rms_rows(got, want)
    err_r = rstd_rel(rstd, rstd_ref)
    check(rms_pass(reading) and err_r <= RSTD_TOL and torch.equal(got, got2),
          f"rms_norm {name}: y {reading}, rstd rel err {err_r} (bars: "
          f"{RMS_SHARE} share, 1 ulp, rstd {RSTD_TOL})")
    y_f, rstd_f = rms_vector_out(x, w, eps)
    fault = dict(rms_rows(y_f, want), rstd_rel=rstd_rel(rstd_f, rstd_ref))
    check(not (rms_pass(fault) and fault["rstd_rel"] <= RSTD_TOL),
          f"rms_norm {name}: the fault passes the bar: {fault}")
    err = (got.float() - want.float()).abs().max().item()
    out = dict(case=name, shape=[rows, cols],
               dtype=str(dtype).split(".")[-1],
               weight=None if w is None else str(w.dtype).split(".")[-1],
               offset=offset, route=route, rows=reading, rstd_rel=err_r,
               controls={"vector_out_of_sum": fault}, max_abs_err=err)
    if not timed:
        return out
    it = 500 if rows <= 64 else 100
    lib = getattr(TF, "rms_norm", None)
    elt = x.element_size()
    wbytes = 0 if w is None else cols * w.element_size()
    b_ms, b_by = bound(2 * rows * cols * elt + wbytes, 4 * rows * cols)

    def timings():
        ms, timer = time_ms(lambda: krms.rms_norm(x, w, eps), it)
        return dict(
            ms=ms, timer=timer,
            plain_ms=time_ms(lambda: krms.rms_norm_ref(x, w, eps),
                             it // 5)[0],
            library_ms=None if lib is None else time_ms(
                lambda: lib(x, (cols,), w, eps), it // 5)[0])

    out.update(bound_ms=b_ms, bound_by=b_by, timings=timings)
    return out


def sdpa_paged(q, k_pages, v_pages, tables, lens):
    """Library yardstick: gather the pages dense, then PyTorch's SDPA."""
    kvh, _, ps, d = k_pages.shape
    b, qh, _ = q.shape
    t = tables.long()
    S = t.shape[1] * ps
    kd = k_pages[:, t].reshape(kvh, b, S, d).transpose(0, 1)
    vd = v_pages[:, t].reshape(kvh, b, S, d).transpose(0, 1)
    if qh != kvh:
        kd = kd.repeat_interleave(qh // kvh, dim=1)
        vd = vd.repeat_interleave(qh // kvh, dim=1)
    mask = torch.arange(S, device=q.device)[None, :] < lens.long()[:, None]
    return TF.scaled_dot_product_attention(q[:, :, None, :], kd, vd,
                                           attn_mask=mask[:, None, None, :])


def chunk_swapped(out, kv_heads, chunk):
    """`out` [b, q_heads, d] with the first two `chunk`-query chunks of each
    kv head's group swapped, what a decode kernel that wrote one block's
    queries in another's place would give; None where the group is one
    chunk. The per-page kernel's chunks are 16 queries (8 at head_dim 256),
    the grouped kernel's 16."""
    b, qh, d = out.shape
    g = qh // kv_heads
    if g <= chunk:
        return None
    idx = torch.arange(g, device=out.device)
    idx[:chunk], idx[chunk:2 * chunk] = idx[chunk:2 * chunk].clone(), \
        idx[:chunk].clone()
    return out.reshape(b, kv_heads, g, d)[:, :, idx].reshape(b, qh, d)


def paged_case(name, dtype, q_heads, kv_heads, gen, dev, lens, d=128,
               page=16, pages_per_seq=256):
    b = len(lens)
    n_pages = b * pages_per_seq
    shape = (kv_heads, n_pages, page, d)
    kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    q = torch.randn(b, q_heads, d, generator=gen, device=dev).to(dtype)
    tables = torch.randperm(n_pages, generator=gen, device=dev) \
        .reshape(b, pages_per_seq).to(torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (q, kp, vp, tables, ln)
    got = kpa.paged_attention(*args)
    torch.cuda.synchronize()
    want = kpa.paged_attention_ref(*args)
    err, tol = max_err(got, want, dtype)
    check(err <= tol, f"paged_attention {name}: max abs err {err} > {tol}")
    check(not got[lens.index(0)].any() if 0 in lens else True,
          f"paged_attention {name}: a ctx 0 row is not zero")
    ctl = {}
    swapped = chunk_swapped(want, kv_heads, 8 if d > 128 else 16)
    if swapped is not None:
        ctl["chunk_swapped"] = max_err(swapped, want, dtype)[0]
        check(ctl["chunk_swapped"] > tol, f"paged_attention {name}: the "
              f"chunk_swapped control reads {ctl}, within {tol}")
    del got, want, swapped
    elt = q.element_size()
    ctx = sum(lens)
    nbytes = (2 * ctx * kv_heads * d * elt + 2 * q.numel() * elt
              + 4 * sum(math.ceil(c / page) for c in lens) + 4 * b)
    b_ms, b_by = bound(nbytes, 4 * ctx * q_heads * d)

    def timings():
        ms, timer = time_ms(lambda: kpa.paged_attention(*args), 50)
        return dict(
            ms=ms, timer=timer,
            plain_ms=time_ms(lambda: kpa.paged_attention_ref(*args), 5)[0],
            library_ms=time_ms(lambda: sdpa_paged(*args), 10)[0])

    return dict(
        case=name, batch=b, q_heads=q_heads, kv_heads=kv_heads, head_dim=d,
        page=page, lens=list(lens), dtype=str(dtype).split(".")[-1],
        max_abs_err=err, tol=tol, controls=ctl, bound_ms=b_ms,
        bound_by=b_by, timings=timings)


def swap_nibbles(qw):
    u = qw.to(torch.int32) & 0xFF
    u = ((u & 0xF) << 4) | (u >> 4)
    return torch.where(u >= 128, u - 256, u).to(torch.int8)


def shift_group(scales):
    """Group 0 takes group 1's scales; per-channel scales: every column
    takes its neighbour's."""
    if scales.dim() == 1:
        return scales.roll(1)
    out = scales.clone()
    out[0] = scales[1]
    return out


def without_k_tile(x, qw, sc, wd, tile):
    """The plain version without one 64-deep k tile's contribution (x's
    columns of that tile zeroed): the fault of a ring that skips a stage."""
    cut = x.clone()
    cut[:, tile * 64:(tile + 1) * 64] = 0
    return kqm.quant_matmul_ref(cut, qw, sc, wd)


def without_split_partial(x, qw, sc, wd, splits):
    """The plain version without one partial of the decode kernel's
    in-launch reduce at a k split of `splits`: the first segment of a
    column tile that several blocks share (`kmm.decode_segments` on this
    card's SMs) adds nothing to that column tile (the fault of a reducer
    that skips a slot)."""
    k, n = x.shape[1], qw.shape[1]
    sch = kmm.decode_schedule(k, n, kmm.sm_count(x.device), splits)
    _, c, s0, s1, _ = next(s for s in kmm.decode_segments(sch)
                           if s[4] is not None)
    w = kqm.dequantize(qw, sc, wd, x.dtype)
    t = kmm.DECODE_TILE
    w[s0 * t:s1 * t, c * t:(c + 1) * t] = 0
    return torch.matmul(x, w)


def qmm_controls(x, qw, sc, wd, want):
    """Readings of the row check on faults made from the plain version:
    one group's scales shifted by one group, the first or the last k tile's
    contribution missing, for int4 the two nibbles of every byte swapped,
    and at decode (bf16, m <= 16) one split partial of the in-launch reduce
    missing. Each must exceed the bar."""
    k = x.shape[1]
    got = {"group_shift": kqm.quant_matmul_ref(x, qw, shift_group(sc), wd),
           "first_k_tile": without_k_tile(x, qw, sc, wd, 0),
           "last_k_tile": without_k_tile(x, qw, sc, wd, k // 64 - 1)}
    if wd == "int4":
        got["nibble_swap"] = kqm.quant_matmul_ref(x, swap_nibbles(qw), sc, wd)
    if x.dtype == torch.bfloat16 and x.shape[0] <= 16:
        got["split_partial"] = without_split_partial(x, qw, sc, wd,
                                                     DECODE_SPLITS)
    return {k: row_rel_err(v, want) for k, v in got.items()}


class full_precision_reductions:
    """cuBLAS bf16 products reduce in f32 inside the block (the plain
    version's products, as the kernel's)."""

    def __enter__(self):
        self.old = torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            self.old


def turns(first, nbytes, copy):
    """A function returning, call after call, the next of `first` and
    copies made by `copy()`, worth at least 128 MB together: each call
    finds its operands out of the 50 MB L2."""
    items = first + [copy() for _ in range(-(-2 ** 27 // nbytes) - 1)]
    state = [0]

    def nxt():
        state[0] = (state[0] + 1) % len(items)
        return items[state[0]]

    return nxt


def qmm_case(name, m, k, n, wd, gs, dtype, gen, dev, timed=True):
    """The dequant matmul against its plain version, row by row, beside
    `qmm_controls`' faults; a second call must equal the first bit for bit
    (the decode kernel's in-launch reduce adds its partials in a fixed
    order). `timed`: time it after the serving phases (tails: no)."""
    w = (torch.randn(k, n, generator=gen, device=dev) * 0.02).to(dtype)
    qw, sc = weight_quantize(w, ALGO[wd], group_size=gs)
    del w
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    got = kqm.quant_matmul(x, qw, sc, wd, gs)
    again = kqm.quant_matmul(x, qw, sc, wd, gs)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"quant_matmul {name}: two calls differ")
    del again
    tol = QUANT_TOL[dtype]
    with full_precision_reductions():
        want = kqm.quant_matmul_ref(x, qw, sc, wd)
        err = row_rel_err(got, want)
        check(err <= tol, f"quant_matmul {name}: row rel err {err} > {tol}")
        if dtype == torch.bfloat16 and m <= 16:
            # the in-launch reduce of a forced split, which the control
            # below faults
            split = [kqm._quant_matmul_cuda(x, qw, sc, wd, gs, DECODE_SPLITS)
                     for _ in range(2)]
            check(torch.equal(*split), f"quant_matmul {name}: two calls at "
                  f"{DECODE_SPLITS} k splits differ")
            e = row_rel_err(split[0], want)
            check(e <= tol, f"quant_matmul {name} at {DECODE_SPLITS} k "
                  f"splits: row rel err {e} > {tol}")
            err = max(err, e)
            del split
        ctl = qmm_controls(x, qw, sc, wd, want)
    for fault, r in ctl.items():
        check(r > tol, f"quant_matmul {name}: the {fault} control reads {r}, "
              f"within the bar {tol}")
    abs_err = (got.float() - want.float()).abs().max().item()
    del got, want
    elt = x.element_size()
    rate = BF16_FLOP_S if dtype == torch.bfloat16 else F32_FLOP_S
    # x, the packed weight and the scales read once, y written once
    b_ms, b_by = bound(m * k * elt + qw.numel() + 4 * sc.numel()
                       + m * n * elt, 2 * m * k * n, rate)

    def timings():
        it = 200 if m <= 16 else 20
        # at decode, as on the serving path, each call finds its weight out
        # of the 50 MB L2: the calls take turns over copies worth >= 128 MB
        # (the kernel's packed weight and scales, the library's bf16 one)
        w_deq = kqm.dequantize(qw, sc, wd, dtype)
        if m <= 16:
            qs = turns([(qw, sc)], qw.numel() + 4 * sc.numel(),
                       lambda: (qw.clone(), sc.clone()))
            ws = turns([w_deq], w_deq.numel() * elt, w_deq.clone)
        else:
            qs, ws = (lambda: (qw, sc)), (lambda: w_deq)
        ms, timer = time_ms(lambda: kqm.quant_matmul(x, *qs(), wd, gs), it)
        res = dict(
            ms=ms, timer=timer,
            plain_ms=time_ms(lambda: kqm.quant_matmul_ref(x, qw, sc, wd),
                             max(it // 10, 3))[0],
            library_ms=time_ms(lambda: torch.matmul(x, ws()), it)[0])
        del w_deq, qs, ws
        return res

    return dict(case=name, m=m, k=k, n=n, weight=wd, group_size=gs,
                dtype=str(dtype).split(".")[-1], row_rel_err=err,
                max_abs_err=abs_err, tol=tol, controls=ctl, bound_ms=b_ms,
                bound_by=b_by, timings=timings if timed else None)


def qmm_split_sweep(gen, dev, card, splits=(1, 2, 4, 8, 16, 32)):
    """Device time of the decode dequant matmul (m = 8, int8 and int4 per
    channel) with its weight stream cut as one block per SM shares it
    ("auto", `kmm.decode_schedule`) beside forced k splits of every column
    tile (a grid of n / 128 x splits blocks): where the time stops
    falling, the bytes in flight no longer bound it."""
    res = []
    for k, n in ((5120, 5120), (5120, 13824), (13824, 5120)):
        w = torch.randn(k, n, generator=gen, device=dev) * 0.02
        x = torch.randn(8, k, generator=gen, device=dev).to(torch.bfloat16)
        for wd in ("int8", "int4"):
            qw, sc = weight_quantize(w, ALGO[wd])
            auto = kmm.decode_schedule(k, n, kmm.sm_count(dev))["grid"]
            row = dict(k=k, n=n, weight=wd, auto_grid=auto, ms={})
            for sp in (None,) + splits:
                row["ms"]["auto" if sp is None else sp] = time_ms(
                    lambda: kqm._quant_matmul_cuda(x, qw, sc, wd, -1, sp),
                    100)[0]
            log(f"kernel: quant_matmul {k}->{n} m8 {wd} by k split (auto: "
                f"{auto} blocks): " + ", ".join(
                    f"{s_} {ms * 1e3:.1f} us" for s_, ms in row["ms"].items())
                + f" [{card}]")
            res.append(row)
    return res


def sdpa_paged_q8(q, k_pages, v_pages, tables, lens, k_scales, v_scales):
    """Library yardstick of the int8 decode: a dequantizing gather of the
    pages, then PyTorch's SDPA (as `sdpa_paged`)."""
    kd = k_pages.to(q.dtype) * k_scales[..., None].to(q.dtype)
    vd = v_pages.to(q.dtype) * v_scales[..., None].to(q.dtype)
    return sdpa_paged(q, kd, vd, tables, lens)


def paged_q8_case(name, dtype, q_heads, kv_heads, gen, dev, lens, d=128,
                  page=16, pages_per_seq=256):
    b = len(lens)
    n_pages = b * pages_per_seq
    shape = (kv_heads, n_pages, page, d)
    kp, ks = kpa._quant_kv_token(torch.randn(shape, generator=gen,
                                             device=dev))
    vp, vs = kpa._quant_kv_token(torch.randn(shape, generator=gen,
                                             device=dev))
    q = torch.randn(b, q_heads, d, generator=gen, device=dev).to(dtype)
    tables = torch.randperm(n_pages, generator=gen, device=dev) \
        .reshape(b, pages_per_seq).to(torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (q, kp, vp, tables, ln)
    sc = dict(k_scales=ks, v_scales=vs)
    got = kpa.paged_attention(*args, **sc)
    torch.cuda.synchronize()
    want = kpa.paged_attention_ref(*args, **sc)
    err = row_rel_err(got, want)
    tol = QUANT_TOL[dtype]
    check(err <= tol, f"paged_attention_int8 {name}: row rel err {err} > "
          f"{tol}")
    check(not got[lens.index(0)].any() if 0 in lens else True,
          f"paged_attention_int8 {name}: a ctx 0 row is not zero")
    ctl = {"k_scales_left_out": row_rel_err(kpa.paged_attention_ref(
        *args, k_scales=torch.ones_like(ks), v_scales=vs), want)}
    swapped = chunk_swapped(want, kv_heads, 8 if d > 128 else 16)
    if swapped is not None:
        ctl["chunk_swapped"] = row_rel_err(swapped, want)
    for fault, r in ctl.items():
        check(r > tol, f"paged_attention_int8 {name}: the {fault} control "
              f"reads {r}, within the bar {tol}")
    abs_err = (got.float() - want.float()).abs().max().item()
    del got, want
    elt = q.element_size()
    ctx = sum(lens)
    # int8 K and V rows and their f32 scales, q read, out written, tables
    nbytes = (2 * ctx * kv_heads * (d + 4) + 2 * q.numel() * elt
              + 4 * sum(math.ceil(c / page) for c in lens) + 4 * b)
    b_ms, b_by = bound(nbytes, 4 * ctx * q_heads * d)

    def timings():
        ms, timer = time_ms(lambda: kpa.paged_attention(*args, **sc), 50)
        return dict(
            ms=ms, timer=timer,
            plain_ms=time_ms(lambda: kpa.paged_attention_ref(*args, **sc),
                             5)[0],
            library_ms=time_ms(lambda: sdpa_paged_q8(*args, ks, vs), 10)[0])

    return dict(
        case=name, batch=b, q_heads=q_heads, kv_heads=kv_heads, head_dim=d,
        page=page, lens=list(lens), dtype=str(dtype).split(".")[-1],
        row_rel_err=err, max_abs_err=abs_err, tol=tol, controls=ctl,
        bound_ms=b_ms, bound_by=b_by, timings=timings)


def mm_case(name, m, k, n, dtype, gen, dev, check_timer=False, timed=True):
    """The dense matmul's every variant that takes m rows (bf16: the decode
    kernels at m <= 16, the wgmma tiles above; f32: the split kernel's row
    tiles) against `torch.matmul` on the f32 values of its inputs, row by
    row, beside faults made from the plain version (one 64-deep k tile of x
    dropped; w's column tiles shifted by one; at an m tail, the last row
    written from the row before it), which must exceed the bar.
    `check_timer`: also time the default variant through the tuner's timer
    (a CUDA graph of launches) beside the profiler, to check the tuner's
    clock. `timed`: time it after the serving phases (tails: no)."""
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5).to(dtype)
    tol = MATMUL_TOL[dtype]
    want = torch.matmul(x.float(), w.float())
    errs, abs_err = {}, 0.0
    for tile in kmm.variants(dtype, m):
        got = kmm.matmul_fused(x, w, tile)
        torch.cuda.synchronize()
        errs[tile] = row_rel_err(got, want)
        abs_err = max(abs_err, (got.float() - want).abs().max().item())
        check(errs[tile] <= tol, f"matmul {name} {tile}: row rel err "
              f"{errs[tile]} > {tol}")
        del got
    x_cut = x.float().clone()
    x_cut[:, k // 2:k // 2 + 64] = 0
    ctl = {"k_tile_dropped": row_rel_err(torch.matmul(x_cut, w.float()),
                                         want),
           "column_tile_shifted": row_rel_err(
               torch.matmul(x.float(), w.float().roll(128, dims=1)), want)}
    if m % 128 and m > 1:
        wrong = want.clone()
        wrong[-1] = want[-2]
        ctl["m_tail_last_row"] = row_rel_err(wrong, want)
        del wrong
    del x_cut, want
    for fault, r in ctl.items():
        check(r > tol, f"matmul {name}: the {fault} control reads {r}, "
              f"within the bar {tol}")
    elt = x.element_size()
    rate = BF16_FLOP_S if dtype == torch.bfloat16 else F32_FLOP_S
    # x and w read once, y written once
    b_ms, b_by = bound((m * k + k * n + m * n) * elt, 2 * m * k * n, rate)

    def timings():
        it = 200 if m <= 16 else 20
        # as on the serving path, each call finds its weight out of the
        # 50 MB L2: the calls take turns over copies of w worth >= 128 MB
        w_next = turns([w], k * n * elt, w.clone)
        tile_ms = {t: time_ms(lambda: kmm.matmul_fused(x, w_next(), t), it)
                   for t in kmm.variants(dtype, m)}
        best = min(tile_ms, key=lambda t: tile_ms[t][0])
        # the plain version is the library call: torch.matmul in x's dtype
        lib_ms = time_ms(lambda: torch.matmul(x, w_next()), it)[0]
        copies = -(-2 ** 27 // (k * n * elt))
        res = dict(ms=tile_ms[best][0], timer=tile_ms[best][1],
                   best_tile=best, weight_copies=copies,
                   tile_ms={t: v[0] for t, v in tile_ms.items()},
                   plain_ms=lib_ms, library_ms=lib_ms,
                   # the tuner's timer on the same two calls (one weight)
                   graph_ms={"kernel": autotune.default_timer(
                       lambda a, b: kmm.matmul_fused(a, b, best), (x, w)),
                       "library": autotune.default_timer(torch.matmul,
                                                         (x, w))})
        del w_next
        if check_timer:
            t = kmm.default_variant(m, n, dtype)
            res["tuner_timer_ms"] = {
                "tile": t, "graph_events": autotune.default_timer(
                    lambda a, b: kmm.matmul_fused(a, b, t), (x, w), iters=20),
                "profiler": tile_ms[t][0]}
        return res

    return dict(case=name, m=m, k=k, n=n, dtype=str(dtype).split(".")[-1],
                row_rel_err=max(errs.values()), tile_row_rel_err=errs,
                max_abs_err=abs_err, tol=tol, controls=ctl, bound_ms=b_ms,
                bound_by=b_by, timings=timings if timed else None)


def grouped_controls(q, kp, vp, tables, ln, want):
    """Readings of the grouped decode's row check on faults made from the
    plain version, each against the sound plain output: "page_skipped",
    every row past two pages loses the second page of its first group;
    "pages_out_of_order", the K of a row's first two pages swapped (read
    in the wrong order against their V); "chunk_swapped" (groups above 16
    queries), two chunks of a group's queries swapped. Each must exceed
    the bar."""
    lens = ln.tolist()
    t_skip, l_skip = tables.clone(), ln.clone()
    kf = kp.clone()
    for row, n in enumerate(lens):
        if n > 32:
            t_skip[row, 1:-1] = tables[row, 2:]
            l_skip[row] = n - 16
            p0, p1 = tables[row, 0].item(), tables[row, 1].item()
            kf[:, p0], kf[:, p1] = kp[:, p1], kp[:, p0]
    ctl = {"page_skipped": row_rel_err(kpa.paged_attention_ref(
               q, kp, vp, t_skip, l_skip), want),
           "pages_out_of_order": row_rel_err(kpa.paged_attention_ref(
               q, kf, vp, tables, ln), want)}
    swapped = chunk_swapped(want, kp.shape[0], 16)
    if swapped is not None:
        ctl["chunk_swapped"] = row_rel_err(swapped, want)
    return ctl


def grouped_case(name, dtype, q_heads, kv_heads, gen, dev, lens, d=128,
                 page=16, pages_per_seq=256):
    """The grouped-fetch decode against the plain dense version, row by row
    (bar GROUPED_TOL), beside the faults of `grouped_controls`, and against
    the per-page kernel."""
    b = len(lens)
    n_pages = b * pages_per_seq
    shape = (kv_heads, n_pages, page, d)
    kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    q = torch.randn(b, q_heads, d, generator=gen, device=dev).to(dtype)
    tables = torch.randperm(n_pages, generator=gen, device=dev) \
        .reshape(b, pages_per_seq).to(torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (q, kp, vp, tables, ln)
    got = kpa.paged_attention_grouped(*args)
    paged = kpa.paged_attention(*args)
    torch.cuda.synchronize()
    want = kpa.paged_attention_ref(*args)
    tol = GROUPED_TOL[dtype]
    err = row_rel_err(got, want)
    vs_paged = row_rel_err(got, paged)
    check(err <= tol, f"paged_attention_grouped {name}: row rel err {err} "
          f"> {tol}")
    check(vs_paged <= tol, f"paged_attention_grouped {name}: row rel err "
          f"{vs_paged} against the per-page kernel > {tol}")
    check(not got[lens.index(0)].any() if 0 in lens else True,
          f"paged_attention_grouped {name}: a ctx 0 row is not zero")
    ctl = grouped_controls(*args, want)
    for fault, r in ctl.items():
        check(r > tol, f"paged_attention_grouped {name}: the {fault} control "
              f"reads {r}, within the bar {tol}")
    abs_err = (got.float() - want.float()).abs().max().item()
    del got, paged, want
    elt = q.element_size()
    ctx = sum(lens)
    nbytes = (2 * ctx * kv_heads * d * elt + 2 * q.numel() * elt
              + 4 * sum(math.ceil(c / page) for c in lens) + 4 * b)
    b_ms, b_by = bound(nbytes, 4 * ctx * q_heads * d)

    def timings():
        ms, timer = time_ms(lambda: kpa.paged_attention_grouped(*args), 50)
        return dict(
            ms=ms, timer=timer,
            per_page_kernel_ms=time_ms(lambda: kpa.paged_attention(*args),
                                       50)[0],
            plain_ms=time_ms(lambda: kpa.paged_attention_grouped_ref(*args),
                             5)[0],
            library_ms=time_ms(lambda: sdpa_paged(*args), 10)[0])

    return dict(
        case=name, batch=b, q_heads=q_heads, kv_heads=kv_heads, head_dim=d,
        page=page, lens=list(lens), dtype=str(dtype).split(".")[-1],
        row_rel_err=err, row_rel_err_vs_per_page=vs_paged,
        max_abs_err=abs_err, tol=tol, controls=ctl, bound_ms=b_ms,
        bound_by=b_by, timings=timings)


def rms_bwd_case(name, rows, cols, dtype, gen, dev, weight="same", offset=0,
                 timed=True, eps=1e-6):
    """The backward kernel against its plain version given the kernel's
    rstd, row by row: dx over the norm of the terms it cancels, rstd * wg
    (a short row cancels to rounding), and dw, one row, over its norm (a
    sum over few rows cancels in some columns), each within TOL; called
    twice, dx and dw bitwise equal. Beside a fault, the plain dw without
    one block's partial (the rows b, b + grid, ... of block b = 0), which
    must fail the same bar."""
    x, w, g = rms_inputs(rows, cols, dtype, gen, dev, weight, offset,
                         grad=True)
    r = krms.route(x, w, True, g, torch.empty_like(x))
    _, rstd = krms.rms_norm(x, w, eps, with_rstd=True)
    dx, dw = krms.rms_norm_bwd(x, w, rstd, g)
    dx2, dw2 = krms.rms_norm_bwd(x, w, rstd, g)
    torch.cuda.synchronize()
    check(torch.equal(dx, dx2) and (w is None or torch.equal(dw, dw2)),
          f"rms_norm_bwd {name}: two calls differ")
    dx_ref, dw_ref = krms.rms_norm_bwd_ref(x, w, rstd, g)
    wg = g.float() if w is None else g.float() * w.float()
    terms = (rstd[:, None] * wg).norm(dim=-1)
    err_dx = ((dx.float() - dx_ref.float()).norm(dim=-1) / terms).max().item()
    check(err_dx <= TOL[dtype], f"rms_norm_bwd {name} dx: row err {err_dx} "
          f"> {TOL[dtype]}")

    def dw_reading(got):
        return dict(row_rel=row_rel_err(got[None], dw_ref[None]))

    def dw_pass(reading):
        return reading["row_rel"] <= TOL[w.dtype]

    controls, reading = {}, None
    if w is not None:
        reading = dw_reading(dw)
        check(dw_pass(reading), f"rms_norm_bwd {name} dw: {reading}")
        xh = x.float() * rstd[:, None]
        block0 = (g.float()[::r["grid"]] * xh[::r["grid"]]).sum(dim=0)
        fault = ((g.float() * xh).sum(dim=0) - block0).to(w.dtype)
        controls["block_partial_out"] = dw_reading(fault)
        check(not dw_pass(controls["block_partial_out"]),
              f"rms_norm_bwd {name}: the fault passes the bar: {controls}")
    err = (dx.float() - dx_ref.float()).abs().max().item()
    out = dict(case=name, shape=[rows, cols],
               dtype=str(dtype).split(".")[-1],
               weight=None if w is None else str(w.dtype).split(".")[-1],
               offset=offset, route=r["route"], grid=r["grid"],
               dx_row_err=err_dx, dw=reading, controls=controls,
               max_abs_err=err)
    if not timed:
        return out
    elt = x.element_size()
    wbytes = 0 if w is None else 2 * cols * w.element_size()
    # x and g read, dx written, w read, dw written, rstd read; ~10 f32
    # operations per element
    b_ms, b_by = bound(3 * rows * cols * elt + wbytes + 4 * rows,
                       10 * rows * cols)
    it = 500 if rows <= 64 else 100
    lib = getattr(TF, "rms_norm", None)

    def library():
        xl = x.detach().requires_grad_()
        wl = None if w is None else w.detach().requires_grad_()
        y = lib(xl, (cols,), wl, eps)
        return time_ms(lambda: torch.autograd.grad(
            y, (xl,) if w is None else (xl, wl), g, retain_graph=True),
            it // 5)[0]

    def timings():
        ms, timer = time_ms(lambda: krms.rms_norm_bwd(x, w, rstd, g), it)
        return dict(
            ms=ms, timer=timer,
            plain_ms=time_ms(lambda: krms.rms_norm_bwd_ref(x, w, rstd, g),
                             it // 5)[0],
            library_ms=None if lib is None else library())

    out.update(bound_ms=b_ms, bound_by=b_by, timings=timings)
    return out


def visible_pairs(s_q, s_kv, causal, seg_q=None, seg_k=None):
    """(query, key) pairs the attention computes for one head: all, or under
    the bottom-right aligned causal mask those with i + s_kv - s_q >= j;
    with segment ids (int tensors [b, s_q], [b, s_kv]) only the pairs of
    equal ids among those, summed over the b rows."""
    off = s_kv - s_q
    if seg_q is None:
        if not causal:
            return s_q * s_kv
        return sum(min(max(i + off + 1, 0), s_kv) for i in range(s_q))
    cols = torch.arange(s_kv, device=seg_k.device)
    total = 0
    for row in range(seg_q.shape[0]):
        for r0 in range(0, s_q, 1024):
            rows = torch.arange(r0, min(r0 + 1024, s_q), device=cols.device)
            hit = seg_q[row, rows, None] == seg_k[row, None, :]
            if causal:
                hit &= rows[:, None] + off >= cols[None, :]
            total += int(hit.sum())
    return total


def dq_without_tile(q, k, v, do, lse, delta, scale, causal, var=None,
                    keys=128):
    """dQ of the plain version without the contribution of the first
    `keys` keys (one block of the backward kernel), the fault of a block
    whose atomic additions into dQ were lost."""
    p, _, dp = kfa._grad_terms(q, k, v, do, lse, scale, causal, var)
    ds = kfa._ds(p, dp, delta, scale)
    del p, dp
    ds[:, :, :keys] = 0
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def fwd_diag_shift(q, k, v, scale):
    """The causal forward with the diagonal shifted by one key (each query
    also sees the key after its last one), in f32: a fault of the kernel's
    in-register causal test."""
    s_q, s_kv = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    rows = torch.arange(s_q, device=q.device)[:, None]
    cols = torch.arange(s_kv, device=q.device)[None, :]
    s = s.masked_fill(rows + (s_kv - s_q) + 1 < cols, float("-inf"))
    out = torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), v.float())
    return out.nan_to_num().to(q.dtype)


def flash_controls(q, k, v, do, lse, delta, scale, causal, want):
    """Readings of the flash check on faults made from the plain versions,
    each against the sound plain outputs `want`: every one must exceed the
    bar. "scale": the softmax scale 1 % too large throughout. "dq_tile":
    dQ without the first 128-key tile's contribution. "diag_shift"
    (causal): the forward with the causal diagonal one key late. "tile" (not
    causal): the forward and dQ skip one 64-key tile, dK/dV one 64-query
    tile, with the sound lse and delta."""
    s2 = scale * 1.01
    out, lse2 = kfa.flash_fwd_ref(q, k, v, s2, causal)
    delta2 = kfa.flash_bwd_delta(out, do)
    dq, dk, dv = kfa.flash_bwd_ref(q, k, v, do, lse2, delta2, s2, causal)
    got = {"scale": dict(out=out, dq=dq, dk=dk, dv=dv),
           "dq_tile": dict(dq=dq_without_tile(q, k, v, do, lse, delta, scale,
                                              causal))}
    if causal:
        got["diag_shift"] = dict(out=fwd_diag_shift(q, k, v, scale))
    if not causal:
        a, b = k.shape[1] // 2, q.shape[1] // 2

        def cut(t, i):
            return torch.cat([t[:, :i], t[:, i + 64:]], dim=1)

        kd, vd = cut(k, a), cut(v, a)
        out = kfa.flash_fwd_ref(q, kd, vd, scale, False)[0]
        dq = kfa.flash_bwd_dq_ref(q, kd, vd, do, lse, delta, scale, False)
        dk, dv = kfa.flash_bwd_dkv_ref(
            cut(q, b), k, v, cut(do, b), cut(lse[..., None], b)[..., 0],
            cut(delta[..., None], b)[..., 0], scale, False)
        got["tile"] = dict(out=out, dq=dq, dk=dk, dv=dv)
    return {fault: {key: row_rel_err(t, want[key]) for key, t in ts.items()}
            for fault, ts in got.items()}


def flash_case(name, bh, s_q, s_kv, causal, dtype, gen, dev, library=False):
    """The flash forward and backward kernels against their plain versions,
    each output held to FLASH_TOL as a row relative error, and the readings
    of faults (`flash_controls`), which must exceed it; with `library`,
    timings also of the plain versions and of PyTorch's SDPA (square shapes
    only: SDPA aligns its causal mask top-left)."""
    d = kfa.HEAD_DIM
    scale = d ** -0.5

    def rnd(s):
        return torch.randn(bh, s, d, generator=gen, device=dev).to(dtype)

    q, k, v, do = rnd(s_q), rnd(s_kv), rnd(s_kv), rnd(s_q)
    out, lse = kfa.flash_fwd(q, k, v, scale, causal)
    delta = kfa.flash_bwd_delta(out, do)
    dq, dk, dv = kfa.flash_bwd(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    out_r, lse_r = kfa.flash_fwd_ref(q, k, v, scale, causal)
    dq_r, dk_r, dv_r = kfa.flash_bwd_ref(q, k, v, do, lse_r, delta, scale,
                                         causal)
    want = dict(out=out_r, dq=dq_r, dk=dk_r, dv=dv_r)
    tol = FLASH_TOL[dtype]
    errs, abs_err = {}, {}
    for key, got in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
        abs_err[key] = (got.float() - want[key].float()).abs().max().item()
        err = row_rel_err(got, want[key])
        check(err <= tol, f"flash {name} {key}: row rel err {err} > {tol}")
        errs[key] = err
    live = lse_r > -1e29  # rows that see at least one key
    lse_err = (lse[live] - lse_r[live]).abs().max().item()
    check(lse_err <= 1e-3, f"flash {name} lse: max abs err {lse_err}")
    check(torch.equal(lse[~live], lse_r[~live]) and not out[~live].any(),
          f"flash {name}: a row that sees no key is not 0 / -1e30")
    ctl = flash_controls(q, k, v, do, lse_r, delta, scale, causal, want)
    for fault, readings in ctl.items():
        for key, err in readings.items():
            check(err > tol, f"flash {name}: the {fault} control reads "
                  f"{key} {err}, within the bar {tol}")
    del out_r, lse_r, dk_r, dv_r, dq_r, want
    pairs = visible_pairs(s_q, s_kv, causal)
    elt = q.element_size()
    rate = BF16_FLOP_S if dtype == torch.bfloat16 else TF32_FLOP_S
    n_q, n_kv = bh * s_q * d * elt, bh * s_kv * d * elt
    # forward: q, k, v read, out written, lse written; 2 products
    fwd_b = bound(2 * n_q + 2 * n_kv + 4 * bh * s_q, 4 * bh * d * pairs,
                  rate)
    # backward: q, dO, k, v, lse, delta read, dq, dk, dv written; 5
    # products (S, dP, dV, dK, dQ)
    bwd_b = bound(3 * n_q + 4 * n_kv + 8 * bh * s_q, 10 * bh * d * pairs,
                  rate)
    res = dict(case=name, bh=bh, s_q=s_q, s_kv=s_kv, head_dim=d,
               causal=causal, dtype=str(dtype).split(".")[-1],
               lse_err=lse_err, visible_pairs=pairs, tol=tol, controls=ctl,
               fwd=dict(max_abs_err=abs_err["out"], row_rel_err=errs["out"],
                        bound_ms=fwd_b[0], bound_by=fwd_b[1]),
               bwd=dict(max_abs_err=max(abs_err[t] for t in ("dq", "dk",
                                                             "dv")),
                        row_rel_err=max(errs[t] for t in ("dq", "dk", "dv")),
                        row_rel_errs={t: errs[t] for t in ("dq", "dk",
                                                           "dv")},
                        bound_ms=bwd_b[0], bound_by=bwd_b[1]))

    def timings():
        it = 20 if s_q * s_kv >= 2 ** 22 else 100
        for key, fn in (
                ("fwd", lambda: kfa.flash_fwd(q, k, v, scale, causal)),
                ("bwd", lambda: kfa.flash_bwd(q, k, v, do, lse, delta,
                                              scale, causal))):
            res[key]["ms"], res[key]["timer"] = time_ms(fn, it)
            res[key]["plain_ms"] = res[key]["library_ms"] = None
        if not library:
            return
        res["fwd"]["plain_ms"] = time_ms(
            lambda: kfa.flash_fwd_ref(q, k, v, scale, causal), 3)[0]
        res["bwd"]["plain_ms"] = time_ms(
            lambda: kfa.flash_bwd_ref(q, k, v, do, lse, delta, scale,
                                      causal), 3)[0]
        # SDPA over [1, bh, s, d] views; its backward computes dQ, dK and
        # dV in one call
        q4, k4, v4 = (t.view(1, bh, -1, d) for t in (q, k, v))
        res["fwd"]["library_ms"] = time_ms(
            lambda: TF.scaled_dot_product_attention(q4, k4, v4,
                                                    is_causal=causal),
            it)[0]
        qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
        o = TF.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        bwd = time_ms(lambda: torch.autograd.grad(
            o, (qg, kg, vg), do.view(1, bh, s_q, d), retain_graph=True),
            it)[0]
        res["bwd"]["library_ms"] = bwd

    res["timings"] = timings
    return res


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------


def drive(eng, requests):
    """Queue `requests` [(prompt, max_new, kwargs)], step the engine until
    idle, and time it: TTFT per request, and the steps that only decoded."""
    t_add, t_first, n_tok = {}, {}, [0]

    def on_token(rid, _tok):
        n_tok[0] += 1
        t_first.setdefault(rid, time.perf_counter())

    want = {}
    for prompt, max_new, kw in requests:
        rid = eng.add_request(prompt, max_new_tokens=max_new,
                              on_token=on_token, **kw)
        t_add[rid] = time.perf_counter()
        want[rid] = max_new
    finished, step_ms, dec_tok, dec_s = [], [], 0, 0.0
    while eng.has_work():
        p0, d0, k0 = eng.prefills, eng.decode_steps, n_tok[0]
        t0 = time.perf_counter()
        finished += eng.step()  # ends in a device->host read of the tokens
        dt = time.perf_counter() - t0
        if eng.prefills == p0 and eng.decode_steps > d0:
            step_ms.append(dt * 1e3)
            dec_tok += n_tok[0] - k0
            dec_s += dt
    check(sorted(f.request_id for f in finished) == sorted(want),
          "not every request finished")
    vocab = eng.cfg.vocab_size
    for f in finished:
        check(len(f.output_ids) == want[f.request_id],
              f"request {f.request_id}: {len(f.output_ids)} tokens, "
              f"expected {want[f.request_id]}")
        check(((f.output_ids >= 0) & (f.output_ids < vocab)).all(),
              f"request {f.request_id}: token outside the vocabulary")
    ttft = [1e3 * (t_first[r] - t_add[r]) for r in sorted(want)]
    streams = {r: f.output_ids.tolist() for f in finished
               for r in (f.request_id,)}
    return dict(requests=len(want), ttft_ms=ttft,
                streams=[streams[r] for r in sorted(want)],
                decode_steps=len(step_ms),
                ms_per_decode_step_p50=float(np.median(step_ms))
                if step_ms else None,
                decode_tokens_per_s=dec_tok / dec_s if dec_s else None)


class ForwardLog:
    """Wraps an engine's model so that every forward is recorded: its token
    count m (the linears' rows) and the host seconds the call took. A
    decode forward issues its kernels without waiting on the device (its
    masks stay on the host), so its call time is the host's cost of the
    step's forward."""

    def __init__(self, model):
        self.forwards = []  # (kind, m, host s)
        for kind in ("forward_cached", "forward_paged"):
            real = getattr(model, kind)

            def wrapped(ids, *a, _real=real, _kind=kind, **kw):
                t0 = time.perf_counter()
                out = _real(ids, *a, **kw)
                self.forwards.append((_kind, ids.numel(),
                                      time.perf_counter() - t0))
                return out

            setattr(model, kind, wrapped)

    def host_ms_per_decode(self, since=0):
        ts = [t for k, _, t in self.forwards[since:]
              if k == "forward_paged"]
        return float(np.median(ts)) * 1e3 if ts else None


def profile_decode(eng, rng, card, steps=8, quant=False):
    """Profile `steps` pure decode steps at batch 8 (contexts ~1000): wall
    ms per step, device busy ms per step (the sum of kernel intervals on
    the one stream), the device's idle share, and device time by kernel.
    `quant`: also the dequant matmul's device ms per step, which must come
    from the one-launch decode kernel (no split-summing kernel)."""
    for _ in range(eng.max_batch):
        eng.add_request(rng.randint(0, eng.cfg.vocab_size, 1000),
                        max_new_tokens=steps + 4)
    eng.step()  # admission, batched prefill, first decode step
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()  # each ends in a device->host read of the tokens
        wall = time.perf_counter() - t0
    eng.run()
    by_name = {}
    events = _device_events(prof)
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    res = dict(steps=steps, wall_ms_per_step=wall * 1e3 / steps,
               device_ops_per_step=len(events) / steps,
               device_busy_ms_per_step=busy / 1e3 / steps,
               idle_share=1.0 - busy / (wall * 1e6),
               top_kernels_ms_per_step=[(n[:90], us / 1e3 / steps)
                                        for n, us in top])
    log(f"profile: batch-8 decode at context ~1000: "
        f"{res['wall_ms_per_step']:.2f} ms/step wall, "
        f"{res['device_busy_ms_per_step']:.2f} ms/step device busy, idle "
        f"share {res['idle_share']:.3f}, {res['device_ops_per_step']:.0f} "
        f"kernels and copies per step [{card}]")
    if quant:
        check(not any("split_sum_kernel" in n for n in by_name),
              "decode profile: a split-summing kernel ran beside the "
              "dequant matmul")
        res["dequant_ms_per_step"] = sum(
            us for n, us in by_name.items() if "skinny_kernel" in n) \
            / 1e3 / steps
        log(f"profile:   the dequant matmul (decode kernel): "
            f"{res['dequant_ms_per_step']:.3f} ms/step of "
            f"{res['device_busy_ms_per_step']:.3f} [{card}]")
    for name, ms in res["top_kernels_ms_per_step"]:
        log(f"profile:   {ms:8.3f} ms/step  {name}")
    return res


def profile_prefill(eng, rng, card, n=2500):
    """One warm, profiled prefill of an n-token prompt (the request ends at
    its first token): wall ms, device busy ms, device time by kernel."""
    eng.add_request(rng.randint(0, eng.cfg.vocab_size, n), max_new_tokens=1)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = eng.step()  # prefill; ends in a device->host read
        wall = time.perf_counter() - t0
    check(len(done) == 1, "the warm prefill request did not finish")
    by_name = {}
    for e in _device_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # the dequant matmul's kernels (prefill: qmm_wgmma_kernel)
    dequant = sum(us for name, us in by_name.items()
                  if "qmm_wgmma_kernel" in name or "skinny_kernel" in name
                  or "quant_matmul_kernel" in name
                  or "split_sum_kernel" in name)
    res = dict(prompt=n, wall_ms=wall * 1e3, device_busy_ms=busy / 1e3,
               dequant_ms=dequant / 1e3,
               top_kernels_ms=[(k[:90], us / 1e3) for k, us in top])
    log(f"profile: warm prefill of a {n}-token prompt: {res['wall_ms']:.1f} "
        f"ms wall, {res['device_busy_ms']:.1f} ms device busy [{card}]")
    if dequant:
        log(f"profile:   the dequant matmul: {res['dequant_ms']:.1f} ms of "
            f"the {res['device_busy_ms']:.1f} ms of device time (share "
            f"{dequant / busy:.3f}) [{card}]")
    for name, ms in res["top_kernels_ms"]:
        log(f"profile:   {ms:8.3f} ms  {name}")
    return res


def traffic(rng, vocab):
    """The serving phases' requests: one 2500-token prompt with 64 new
    tokens, and 10 prompts of 5-1000 tokens with 16-64 new tokens, every
    other one sampled."""
    long_req = [(rng.randint(0, vocab, 2500), 64, {})]
    batch = []
    for i in range(10):
        n = int(rng.randint(5, 1001))
        kw = {} if i % 2 == 0 else dict(decode_strategy="sampling",
                                        temperature=0.8, top_k=50,
                                        top_p=0.95)
        batch.append((rng.randint(0, vocab, n), int(rng.randint(16, 65)),
                      kw))
    return long_req, batch


def serve_7b(seed, dev, card):
    cfg = LlamaConfig.llama2_7b()
    cfg.dtype = "bfloat16"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    eng = ServingEngine(model, max_batch=8, max_seq_len=4096, page_size=16,
                        seed=seed, device=dev)
    torch.cuda.synchronize()
    log(f"serve: LLaMA-2-7B bf16 ({cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}) and 8x4096-token page pools ready in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed)
    long_req, batch = traffic(rng, cfg.vocab_size)
    fwd = ForwardLog(model)
    # the main path: counts from zero, read right after
    krms.launches = 0
    kpa.launches = 0
    t0 = time.perf_counter()
    lone = drive(eng, long_req)
    mixed = drive(eng, batch)
    wall = time.perf_counter() - t0
    host_ms = fwd.host_ms_per_decode()
    launches = {"rms_norm": krms.launches,
                "paged_attention": kpa.launches}
    L = cfg.num_hidden_layers
    forwards = eng.prefills + eng.decode_steps
    check(launches["rms_norm"] == (2 * L + 1) * forwards,
          f"rms_norm launched {launches['rms_norm']} times, expected "
          f"{(2 * L + 1) * forwards}")
    check(launches["paged_attention"] == L * eng.decode_steps > 0,
          f"paged_attention launched {launches['paged_attention']} times, "
          f"expected {L * eng.decode_steps}")
    res = dict(card=card, lone_2500=lone, mixed_10=mixed, wall_s=wall,
               host_ms_per_decode_forward=host_ms,
               prefills=eng.prefills, decode_steps=eng.decode_steps,
               preemptions=eng.preemptions, launches=launches,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 2 ** 30)
    log("serve: lone 2500-token request, 64 new tokens (decode at context "
        f"2500..2563): TTFT {lone['ttft_ms'][0]:.1f} ms, "
        f"{lone['ms_per_decode_step_p50']:.2f} ms/decode step (p50), "
        f"{lone['decode_tokens_per_s']:.1f} tok/s [{card}]")
    log(f"serve: 10 requests (5-1000 tokens, 16-64 new, greedy+sampled) "
        f"through 8 slots: TTFT p50 {np.median(mixed['ttft_ms']):.1f} ms "
        f"max {max(mixed['ttft_ms']):.1f} ms, "
        f"{mixed['ms_per_decode_step_p50']:.2f} ms/decode step (p50), "
        f"{mixed['decode_tokens_per_s']:.1f} decode tok/s [{card}]")
    log(f"serve: host ms per decode step's forward (p50) {host_ms:.2f} "
        f"[{card}]")
    log(f"serve: {eng.prefills} prefills, {eng.decode_steps} decode steps, "
        f"{eng.preemptions} preemptions, launches {launches}, peak "
        f"{res['max_memory_allocated_gb']:.2f} GiB allocated, "
        f"{wall:.1f} s [{card}]")
    res["prefill_profile"] = profile_prefill(eng, rng, card)
    res["decode_profile"] = profile_decode(eng, rng, card)
    del eng, model
    torch.cuda.empty_cache()
    return res


def last_logits(model, ids, dev):
    """f32 logits of the last position of one prompt (dense-cache
    forward, the prefill path)."""
    with torch.no_grad():
        logits, _ = model.forward_cached(
            torch.from_numpy(ids)[None].to(dev),
            model.init_kv_caches(1, len(ids)), 0)
    return logits[0, -1].float()


QUANT_COUNTERS = (("quant_matmul", kqm, "launches"),
                  ("paged_attention_int8", kpa, "q8_launches"),
                  ("paged_attention", kpa, "launches"),
                  ("rms_norm", krms, "launches"))


def init_default(model, seed, dev):
    """PyTorch's default initialisation, drawn from `seed`: a linear's
    [in, out] weight U(-1/sqrt(in), 1/sqrt(in)) (`nn.Linear`), the
    embedding N(0, 1) (`nn.Embedding`), norm weights 1. A 40-layer model
    drawn from N(0, 0.02) instead amplifies small perturbations (int8
    weights moved its logits by 0.29 of the largest on an H100), so a
    quantization bar of 0.05 could not tell good weights from bad on it."""
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0)
            elif name.endswith("embed_tokens.weight"):
                p.normal_(0.0, 1.0, generator=gen)
            else:
                b = p.shape[0] ** -0.5
                p.uniform_(-b, b, generator=gen)


def serve_13b(seed, dev, card, algo, group_size, lone=True):
    """LLaMA-2-13B (random weights, `init_default`), quantized weight-only
    (lm_head kept in bf16) and served over an int8 paged KV cache: the
    last-position logits of a 64-token prompt in bf16 and after quantizing
    (int8: held to the reference's 0.05 of the largest; with `lone` also
    read in f32 first, the floor bf16 rounding alone sets), then the
    phase-4 traffic (`lone`: also the 2500-token request) with the
    kernels' launch counts reset just before and checked just after."""
    cfg = LlamaConfig.llama2_13b()
    cfg.dtype = "float32" if lone else "bfloat16"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold (their timing inputs): the sizes below
    # are this phase's own
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    init_default(model, seed, dev)
    n_params = sum(p.numel() for p in model.parameters())
    prompt = np.random.RandomState(seed + 1).randint(0, cfg.vocab_size, 64)
    floor = None
    if lone:
        ref32 = last_logits(model, prompt, dev)
        model.to(torch.bfloat16)
        cfg.dtype = "bfloat16"
        gc.collect()
        torch.cuda.empty_cache()
    ref = last_logits(model, prompt, dev)
    if lone:
        floor = ((ref - ref32).abs().max() / ref32.abs().max()).item()
        del ref32
    bf16_gib = (torch.cuda.memory_allocated() - base) / 2 ** 30
    t1 = time.perf_counter()
    quantize_for_inference(model, algo, group_size, exclude=("lm_head",))
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    got = last_logits(model, prompt, dev)
    logit_dev = ((got - ref).abs().max() / ref.abs().max()).item()
    tag = f"{algo.split('_')[-1]}" + ("" if group_size == -1
                                      else f"-g{group_size}")
    if algo == "weight_only_int8":
        check(logit_dev < 0.05, f"13B {tag}: logits moved by {logit_dev} "
              f"of the largest, the reference's bar is 0.05")
    quant_gib = (torch.cuda.memory_allocated() - base) / 2 ** 30
    eng = ServingEngine(model, max_batch=8, max_seq_len=4096, page_size=16,
                        seed=seed, device=dev, kv_cache_quant="int8")
    torch.cuda.synchronize()
    ready_gib = (torch.cuda.memory_allocated() - base) / 2 ** 30
    log(f"serve13: LLaMA-2-13B ({cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {n_params / 1e9:.3f} B parameters) bf16 "
        f"{bf16_gib:.2f} GiB allocated -> {tag} weights {quant_gib:.2f} GiB "
        f"(quantized in {quant_s:.1f} s) -> with int8 8x4096-token page "
        f"pools {ready_gib:.2f} GiB; ready in {time.perf_counter() - t0:.1f} "
        f"s; last-position logits of a 64-token prompt moved by "
        f"{logit_dev:.4f} of the largest |logit| ({ref.abs().max():.3f})"
        + ("" if floor is None else f"; bf16 itself moves the f32 model's "
           f"by {floor:.4f}"))
    rng = np.random.RandomState(seed)
    long_req, batch = traffic(rng, cfg.vocab_size)
    # the main path: counts from zero, read right after
    for _, mod, attr in QUANT_COUNTERS:
        setattr(mod, attr, 0)
    kqm.reset_launches()
    t0 = time.perf_counter()
    lone_res = drive(eng, long_req) if lone else None
    mixed = drive(eng, batch)
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr) for name, mod, attr in
                QUANT_COUNTERS}
    by_kernel = dict(kqm.kernel_launches)
    L = cfg.num_hidden_layers
    forwards = eng.prefills + eng.decode_steps
    want = {"quant_matmul": 7 * L * forwards,
            "paged_attention_int8": L * eng.decode_steps,
            "paged_attention": 0, "rms_norm": (2 * L + 1) * forwards}
    for name, n in want.items():
        check(launches[name] == n, f"13B {tag}: {name} launched "
              f"{launches[name]} times, expected {n}")
    check(eng.decode_steps > 0, f"13B {tag}: no decode step ran")
    # every decode step (at most 8 rows) runs the decode kernel, one launch
    # a linear; prefills of more than 16 tokens the prefill kernel
    check(by_kernel["split"] == 0 and by_kernel["prefill"] % (7 * L) == 0
          and by_kernel["decode"] >= 7 * L * eng.decode_steps
          and by_kernel["decode"] + by_kernel["prefill"]
          == launches["quant_matmul"],
          f"13B {tag}: dequant launches by kernel {by_kernel}, "
          f"{eng.decode_steps} decode steps of {7 * L} linears")
    launches["quant_matmul_by_kernel"] = by_kernel
    res = dict(card=card, algo=algo, group_size=group_size, params=n_params,
               logit_rel_dev=logit_dev, bf16_vs_f32_logit_rel_dev=floor,
               bf16_gib=bf16_gib,
               quantized_gib=quant_gib, ready_gib=ready_gib,
               quantize_s=quant_s, lone_2500=lone_res, mixed_10=mixed,
               wall_s=wall, prefills=eng.prefills,
               decode_steps=eng.decode_steps, preemptions=eng.preemptions,
               launches=launches,
               max_memory_allocated_gib=(torch.cuda.max_memory_allocated()
                                         - base) / 2 ** 30)
    if lone_res:
        log(f"serve13 {tag}: lone 2500-token request, 64 new tokens: TTFT "
            f"{lone_res['ttft_ms'][0]:.1f} ms, "
            f"{lone_res['ms_per_decode_step_p50']:.2f} ms/decode step "
            f"(p50), {lone_res['decode_tokens_per_s']:.1f} tok/s [{card}]")
    log(f"serve13 {tag}: 10 requests (5-1000 tokens, 16-64 new, "
        f"greedy+sampled) through 8 slots: TTFT p50 "
        f"{np.median(mixed['ttft_ms']):.1f} ms max "
        f"{max(mixed['ttft_ms']):.1f} ms, "
        f"{mixed['ms_per_decode_step_p50']:.2f} ms/decode step (p50), "
        f"{mixed['decode_tokens_per_s']:.1f} decode tok/s [{card}]")
    log(f"serve13 {tag}: {eng.prefills} prefills, {eng.decode_steps} decode "
        f"steps, {eng.preemptions} preemptions, launches {launches}, peak "
        f"{res['max_memory_allocated_gib']:.2f} GiB allocated, {wall:.1f} s "
        f"[{card}]")
    if lone:
        res["prefill_profile"] = profile_prefill(eng, rng, card)
    res["decode_profile"] = profile_decode(eng, rng, card, quant=True)
    del eng, model, ref, got
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tiny_quant_parity(seed, dev):
    """A tiny f32 LLaMA (head_dim 128, so the kernels take it), quantized on
    the CPU and carried to the card: with int8 KV, the greedy streams
    through the CUDA kernels equal those through the plain versions."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2, seq=128)
    cfg.num_key_value_heads = 1
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (5, 9, 17, 3, 40)]
    res = {}
    for algo, gs in (("weight_only_int8", -1), ("weight_only_int4", 64)):
        cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed)
        gpu = LlamaForCausalLM(cfg, device=dev)
        for m in (cpu, gpu):
            quantize_for_inference(m, algo, gs, exclude=("lm_head",))
        load_llama_state(gpu, llama_state_to_numpy(cpu))
        n0 = kqm.launches, kpa.q8_launches
        streams = []
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            eng = ServingEngine(model, max_batch=3, max_seq_len=128,
                                page_size=8, device=d, kv_cache_quant="int8")
            for p in prompts:
                eng.add_request(p, max_new_tokens=24)
            streams.append({f.request_id: f.output_ids.tolist()
                            for f in eng.run()})
        check(kqm.launches > n0[0] and kpa.q8_launches > n0[1],
              f"tiny {algo}: the quantized kernels did not run on CUDA")
        check(streams[0] == streams[1], f"tiny {algo} g{gs} + int8 KV "
              f"greedy streams differ: cpu {streams[0]} cuda {streams[1]}")
        log(f"parity: tiny f32 LLaMA (2 layers, hidden 256, 2 heads of 128 "
            f"over 1 KV head), {algo} g{gs} + int8 KV, {len(prompts)} "
            f"greedy requests x 24 tokens: CUDA == CPU")
        res[f"{algo}_g{gs}"] = dict(requests=len(prompts), identical=True)
    return res


def tiny_parity(seed, dev):
    cfg = LlamaConfig.tiny(vocab=256, hidden=128, layers=2, heads=4, seq=128)
    cfg.num_key_value_heads = 2
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu = LlamaForCausalLM(cfg, device=dev)
    load_llama_state(gpu, {k: v.numpy() for k, v in cpu.state_dict().items()})
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (5, 9, 17, 3, 40)]
    streams = []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        eng = ServingEngine(model, max_batch=3, max_seq_len=128,
                            page_size=8, device=d)
        for p in prompts:
            eng.add_request(p, max_new_tokens=24)
        streams.append({f.request_id: f.output_ids.tolist()
                        for f in eng.run()})
    check(streams[0] == streams[1],
          f"tiny greedy streams differ: cpu {streams[0]} cuda {streams[1]}")
    log(f"parity: tiny f32 LLaMA (2 layers, hidden 128, GQA 4/2), "
        f"{len(prompts)} greedy requests x 24 tokens: CUDA == CPU")
    return dict(requests=len(prompts), identical=True)


def tiny_mqa_parity(seed, dev):
    """A tiny f32 multi-query LLaMA (32 heads of 32 over 1 KV head, so each
    decode runs the per-page kernel in two chunks of 16 queries): the same
    greedy streams on CUDA and on the CPU, float pages and int8 pages."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=1024, layers=2, heads=32,
                           seq=128)
    cfg.num_key_value_heads = 1
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu = LlamaForCausalLM(cfg, device=dev)
    load_llama_state(gpu, {k: v.numpy() for k, v in cpu.state_dict().items()})
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (5, 9, 17, 3, 40)]
    res = {}
    for kv in (None, "int8"):
        n0 = kpa.launches, kpa.q8_launches
        streams = []
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            eng = ServingEngine(model, max_batch=3, max_seq_len=128,
                                page_size=8, device=d, kv_cache_quant=kv)
            for p in prompts:
                eng.add_request(p, max_new_tokens=24)
            streams.append({f.request_id: f.output_ids.tolist()
                            for f in eng.run()})
        ran = kpa.q8_launches > n0[1] if kv else kpa.launches > n0[0]
        check(ran, f"tiny multi-query ({kv or 'float'} KV): the decode "
              f"kernel did not run on CUDA")
        check(streams[0] == streams[1], f"tiny multi-query ({kv or 'float'} "
              f"KV) greedy streams differ: cpu {streams[0]} cuda "
              f"{streams[1]}")
        log(f"parity: tiny f32 multi-query LLaMA (2 layers, 32 heads of 32 "
            f"over 1 KV head), {kv or 'float'} KV, {len(prompts)} greedy "
            f"requests x 24 tokens: CUDA == CPU")
        res[kv or "float"] = dict(requests=len(prompts), identical=True)
    return res


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------


def model_flops_per_token(cfg, seq_len, causal=True):
    """6*N (fwd+bwd matmul flops per token per param) + attention term
    (a copy of `bench.py::model_flops_per_token`)."""
    h = cfg.hidden_size
    l = cfg.num_hidden_layers
    v = cfg.vocab_size
    inter = cfg.intermediate_size
    per_layer = 4 * h * h + 3 * h * inter
    n_matmul = l * per_layer + v * h
    flops = 6 * n_matmul
    attn = 12 * seq_len * h * l
    flops += attn // 2 if causal else attn
    return flops


TRAIN_COUNTERS = (("flash_fwd", kfa, "fwd_launches"),
                  ("flash_bwd", kfa, "bwd_launches"),
                  ("rms_norm", krms, "launches"),
                  ("rms_norm_bwd", krms, "bwd_launches"))


def _device_profile(fn):
    """Run fn() under the profiler: (wall ms, {kernel name: device us})."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in _device_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return wall * 1e3, by_name


def _kernel_class(name):
    n = name.lower()
    if "flash_" in n:
        return "flash"
    if "rms_norm" in n:
        return "rms_norm"
    if any(t in n for t in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        return "gemm"
    return "other"


def train_7b(seed, dev, card, layers=20, seq=4096, steps=5):
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = layers
    t0 = time.perf_counter()
    model = amp.decorate(LlamaForCausalLM(cfg, device=dev, seed=seed),
                         level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = build_train_step(model, opt)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq))).to(dev)
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq))).to(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"train: LLaMA-2-7B widths, {layers} layers, {n_params / 1e9:.3f} B "
        f"bf16 parameters, ready in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    losses = [step(x, y)]
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    # the main path: counts from zero, read right after
    for _, mod, attr in TRAIN_COUNTERS:
        setattr(mod, attr, 0)
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(x, y))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: getattr(mod, attr) for name, mod, attr in
                TRAIN_COUNTERS}
    losses = [float(v) for v in losses]
    per_step = {"flash_fwd": layers, "flash_bwd": layers,
                "rms_norm": 2 * layers + 1,
                "rms_norm_bwd": 2 * layers + 1}
    for name, n in per_step.items():
        check(launches[name] == n * steps,
              f"train: {name} launched {launches[name]} times in {steps} "
              f"steps, expected {n * steps}")
    check(all(math.isfinite(v) for v in losses), f"train: loss {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    p50 = float(np.median(step_ms))
    tok_s = seq / (p50 / 1e3)
    flops_tok = model_flops_per_token(cfg, seq)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    total_gib = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    res = dict(card=card, layers=layers, params=n_params, seq=seq, batch=1,
               losses=losses, warm_step_ms=warm_ms, step_ms=step_ms,
               step_ms_p50=p50, tokens_per_s=tok_s,
               model_flops_per_token=flops_tok,
               mfu=tok_s * flops_tok / BF16_FLOP_S, launches=launches,
               max_memory_allocated_gib=peak_gib,
               device_memory_gib=total_gib)
    log(f"train: losses {', '.join(f'{v:.4f}' for v in losses)} (warm step "
        f"first)")
    log(f"train: batch 1 x {seq}: warm step {warm_ms:.1f} ms; {steps} steps "
        f"p50 {p50:.1f} ms (min {min(step_ms):.1f}, max {max(step_ms):.1f}),"
        f" {tok_s:.1f} tokens/s, model-FLOPs share {res['mfu']:.4f} of "
        f"989 TFLOP/s bf16; peak {peak_gib:.2f} GiB allocated of "
        f"{total_gib:.2f} GiB [{card}]")
    log(f"train: launches over the {steps} timed steps {launches}")

    # one profiled step, in its two halves (forward + backward, optimizer)
    def fwd_bwd():
        model.train()
        model.compute_loss(model(x), y).backward()

    wall_a, dev_a = _device_profile(fwd_bwd)
    wall_b, dev_b = _device_profile(opt.step)
    opt.clear_grad()
    busy_a, busy_b = sum(dev_a.values()) / 1e3, sum(dev_b.values()) / 1e3
    classes = {}
    for name, us in dev_a.items():
        c = _kernel_class(name)
        classes[c] = classes.get(c, 0.0) + us / 1e3
    classes["optimizer"] = busy_b
    top = sorted(dev_a.items(), key=lambda kv: -kv[1])[:10]
    wall, busy = wall_a + wall_b, busy_a + busy_b
    res["profile"] = dict(
        wall_ms=wall, device_busy_ms=busy, idle_share=1.0 - busy / wall,
        fwd_bwd_wall_ms=wall_a, fwd_bwd_busy_ms=busy_a,
        optimizer_wall_ms=wall_b, optimizer_busy_ms=busy_b,
        device_ms_by_class=classes,
        top_kernels_ms=[(n[:90], us / 1e3) for n, us in top])
    log(f"profile: one train step: {wall:.1f} ms wall, {busy:.1f} ms device "
        f"busy, idle share {1.0 - busy / wall:.3f} (forward+backward "
        f"{wall_a:.1f} ms wall / {busy_a:.1f} ms busy, AdamW {wall_b:.1f} ms "
        f"wall / {busy_b:.1f} ms busy) [{card}]")
    log("profile:   device ms by class: " + ", ".join(
        f"{c} {ms:.1f}" for c, ms in sorted(classes.items(),
                                             key=lambda kv: -kv[1])))
    for name, ms in res["profile"]["top_kernels_ms"]:
        log(f"profile:   {ms:8.3f} ms  {name}")
    del model, opt, step, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 7: tiny training parity, CUDA kernels vs CPU plain versions
# ---------------------------------------------------------------------------


def tiny_train_parity(seed, dev, steps=3, lr=1e-3):
    """Losses within 1e-4 relative (the flash kernels' split-TF32 products
    against f32); each parameter's update (after - before) within 1e-2 of
    its norm: Adam's step is about lr * sign(grad), so an element whose
    gradient is at rounding level may move the other way."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2,
                           seq=256)
    cfg.num_key_value_heads = 1
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu = LlamaForCausalLM(cfg, device=dev)
    load_llama_state(gpu, {k: v.numpy() for k, v in cpu.state_dict().items()})
    before = {k: v.clone() for k, v in cpu.state_dict().items()}
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 256)))
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 256)))
    n0 = kfa.fwd_launches, kfa.bwd_launches
    losses = []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        step = build_train_step(model, AdamW(learning_rate=lr,
                                             parameters=model.parameters()))
        losses.append([step(x.to(d), y.to(d)).item() for _ in range(steps)])
    check((kfa.fwd_launches, kfa.bwd_launches) ==
          tuple(n + 2 * steps for n in n0),
          "tiny training did not run the flash kernels on CUDA")
    rel = max(abs(a - b) / abs(a) for a, b in zip(*losses))
    check(rel <= 1e-4, f"tiny training losses differ: cpu {losses[0]} "
          f"cuda {losses[1]}")
    worst = 0.0
    g_state = gpu.state_dict()
    for name, c in cpu.state_dict().items():
        dc = c - before[name]
        dg = g_state[name].cpu() - before[name]
        worst = max(worst, ((dg - dc).norm() / dc.norm()).item())
    check(worst <= 1e-2, f"tiny training updates differ by {worst} of norm")
    log(f"parity: tiny f32 LLaMA (2 layers, hidden 256, 2 heads of 128 over "
        f"1 KV head), {steps} AdamW steps: losses cpu {losses[0]} cuda "
        f"{losses[1]} (max rel diff {rel:.2e}); updates differ by at most "
        f"{worst:.2e} of their norm")
    return dict(losses_cpu=losses[0], losses_cuda=losses[1],
                max_rel_loss_diff=rel, max_rel_update_diff=worst)


# ---------------------------------------------------------------------------
# phase 8: measured dispatch (FLAGS_autotune, FLAGS_paged_grouped_kernel)
# ---------------------------------------------------------------------------


DISPATCH_FLAGS = ("FLAGS_autotune", "FLAGS_autotune_cache_dir",
                  "FLAGS_paged_grouped_kernel")
DISPATCH_COUNTERS = (("matmul", kmm, "launches"),
                     ("paged_attention_grouped", kpa, "grouped_launches"),
                     ("paged_attention", kpa, "launches"),
                     ("rms_norm", krms, "launches"))


def linear_shapes(cfg):
    """(k, n, count) of the linears of one forward: q, k, v, o, gate, up,
    down per layer, and lm_head."""
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    kv = cfg.num_key_value_heads * (h // cfg.num_attention_heads)
    per_layer = [(h, h), (h, kv), (h, kv), (h, h), (h, i), (h, i), (i, h)]
    shapes = {}
    for kn in per_layer:
        shapes[kn] = shapes.get(kn, 0) + L
    shapes[(h, cfg.vocab_size)] = shapes.get((h, cfg.vocab_size), 0) + 1
    return [(k, n, c) for (k, n), c in shapes.items()]


def expected_matmul_launches(ms, cfg, dtype):
    """GEMM kernel launches of forwards with token counts `ms`: one per
    linear whose bucket's winner (the tuner, as the dispatch asks it) is
    the kernel."""
    total = 0
    for m in ms:
        for k, n, count in linear_shapes(cfg):
            if not kmm.supports(m, k, n, dtype):
                continue
            win = autotune.choose_matmul(m, k, n, dtype)
            if win is not None and win.meta["impl"] == "cuda":
                total += count
    return total


def tuner_table():
    """The tuner's table: {key: entry}, as saved in its file."""
    with open(autotune.get_tuner().cache_path()) as f:
        return json.load(f)["entries"]


def log_table(entries, card, tag):
    for key, e in sorted(entries.items()):
        times = ", ".join(f"{c} {t:.4f}" for c, t in
                          sorted(e["timings_ms"].items(), key=lambda kv: kv[1]))
        log(f"dispatch {tag}: {key}: winner {e['winner']}; ms {times} "
            f"[{card}]")


def pin_kernel_winners():
    """Rewrite the tuner's file so that the kernel's fastest row tile wins
    every matmul bucket and the grouped kernel every float decode bucket
    it was timed in; drop the process's tuner so the file is read again.
    Returns the rewritten entries."""
    path = autotune.get_tuner().cache_path()
    with open(path) as f:
        payload = json.load(f)
    for e in payload["entries"].values():
        t = e["timings_ms"]
        if e["op"] == "matmul":
            e["winner"] = min((c for c in t if c.startswith("cuda:")),
                              key=t.get)
        elif e["op"] == "paged_decode" and "grouped" in t:
            e["winner"] = "grouped"
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    autotune.reset_tuner()
    return payload["entries"]


def reset_counters():
    for _, mod, attr in DISPATCH_COUNTERS:
        setattr(mod, attr, 0)
    kmm.reset_launches()


def read_counters():
    out = {name: getattr(mod, attr) for name, mod, attr in DISPATCH_COUNTERS}
    out["matmul_by_variant"] = dict(kmm.variant_launches)
    return out


def check_dispatch_launches(tag, launches, fwd, since, cfg, decode_steps,
                            prefills):
    """Exact launch counts of a serving run under measured dispatch: the
    GEMM kernel once per linear whose bucket it won, the grouped or the
    per-page decode kernel 32 times a decode step as the decode bucket's
    winner says, RMSNorm 2L + 1 per forward."""
    L = cfg.num_hidden_layers
    ms = [m for _, m, _ in fwd.forwards[since:]]
    check(len(ms) == prefills + decode_steps,
          f"{tag}: {len(ms)} forwards recorded, expected "
          f"{prefills + decode_steps}")
    dwin = autotune.choose_paged_decode(
        8, cfg.num_attention_heads, cfg.num_key_value_heads,
        cfg.hidden_size // cfg.num_attention_heads, 16, 256, torch.bfloat16,
        False)
    grouped = dwin is not None and dwin.meta["impl"] == "grouped"
    want = {"matmul": expected_matmul_launches(ms, cfg, torch.bfloat16),
            "paged_attention_grouped": L * decode_steps if grouped else 0,
            "paged_attention": 0 if grouped else L * decode_steps,
            "rms_norm": (2 * L + 1) * len(ms)}
    for name, n in want.items():
        check(launches[name] == n, f"{tag}: {name} launched {launches[name]} "
              f"times, expected {n}")
    return want, grouped


def stream_agreement(phase4, lone, mixed):
    """Phase 4's streams against a run's: how many are identical and where
    the greedy ones first differ (a random 32-layer model's logits sit
    close together, so one rounding that moves may flip a token; a sampled
    stream also depends on the engine's sampler state)."""
    pairs = [(p, g, i % 2 == 0) for i, (p, g) in enumerate(zip(
        phase4["mixed_10"]["streams"], mixed["streams"]))]
    if lone is not None:
        pairs.append((phase4["lone_2500"]["streams"][0], lone["streams"][0],
                      True))

    def first_diff(x, y):
        return next((i for i, (u, v) in enumerate(zip(x, y)) if u != v),
                    None if len(x) == len(y) else min(len(x), len(y)))

    greedy = [first_diff(p, g) for p, g, gr in pairs if gr]
    sampled = [p == g for p, g, gr in pairs if not gr]
    return dict(greedy=len(greedy),
                greedy_identical=sum(d is None for d in greedy),
                greedy_first_diff=greedy, sampled=len(sampled),
                sampled_identical=sum(sampled))


def dispatch_host_cost(dev, card, calls=2000, rounds=3):
    """Host microseconds per `F.linear` call on a small CUDA matmul (the
    device finishes each call before the host issues the next), with the
    tuner off and on (a table hit whose winner is torch.matmul), in turns:
    the dispatch's own host cost per linear."""
    x = torch.randn(8, 256, device=dev, dtype=torch.bfloat16)
    w = torch.randn(256, 256, device=dev, dtype=torch.bfloat16)
    old = get_flags(["FLAGS_autotune"])
    autotune.get_tuner()  # the bucket may be timed at the first call
    res = {"off": [], "on": []}
    try:
        for _ in range(rounds):
            for mode in ("off", "on"):
                set_flags({"FLAGS_autotune": mode})
                F.linear(x, w)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    F.linear(x, w)
                res[mode].append((time.perf_counter() - t0) / calls * 1e6)
                torch.cuda.synchronize()
    finally:
        set_flags(old)
    out = {m: min(v) for m, v in res.items()}
    out["winner_on"] = autotune.choose_matmul(8, 256, 256,
                                              torch.bfloat16).name
    log(f"dispatch (a): host us per F.linear on a small CUDA matmul "
        f"(8x256 @ 256x256 bf16): tuner off {out['off']:.2f}, on "
        f"{out['on']:.2f} (the bucket's winner {out['winner_on']}; best of "
        f"{rounds} x {calls} calls, in turns) [{card}]")
    return out


def serve_dispatch(seed, dev, card, phase4):
    """(a) LLaMA-2-7B, phase 4's model, engine and traffic, under
    FLAGS_autotune=on with FLAGS_paged_grouped_kernel set: a first pass
    fills the tuner's table (it times every bucket at its first call),
    then the counted pass; (b) the table rewritten so the GEMM kernel wins
    every matmul bucket, and the 10 requests again under readonly."""
    cfg = LlamaConfig.llama2_7b()
    cfg.dtype = "bfloat16"
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    eng = ServingEngine(model, max_batch=8, max_seq_len=4096, page_size=16,
                        seed=seed, device=dev)
    fwd = ForwardLog(model)
    rng = np.random.RandomState(seed)
    long_req, batch = traffic(rng, cfg.vocab_size)
    t0 = time.perf_counter()
    drive(eng, long_req)
    drive(eng, batch)
    tune_s = time.perf_counter() - t0
    entries = tuner_table()
    log(f"dispatch (a): tuning pass (FLAGS_autotune=on, every bucket timed "
        f"at its first call) {tune_s:.1f} s, {len(entries)} buckets")
    log_table(entries, card, "(a)")
    # the main path: counts from zero, read right after
    since, d0, p0 = len(fwd.forwards), eng.decode_steps, eng.prefills
    reset_counters()
    t0 = time.perf_counter()
    lone = drive(eng, long_req)
    mixed = drive(eng, batch)
    wall = time.perf_counter() - t0
    launches = read_counters()
    steps, prefills = eng.decode_steps - d0, eng.prefills - p0
    want, grouped = check_dispatch_launches("dispatch (a)", launches, fwd,
                                            since, cfg, steps, prefills)
    host_ms = fwd.host_ms_per_decode(since)
    agree = stream_agreement(phase4, lone, mixed)
    # the same traffic with both flags off again, right after, so that the
    # host's cost is compared within one stretch of the run
    set_flags({"FLAGS_autotune": "off", "FLAGS_paged_grouped_kernel": False})
    since_off = len(fwd.forwards)
    lone_off = drive(eng, long_req)
    mixed_off = drive(eng, batch)
    host_off = fwd.host_ms_per_decode(since_off)
    # the control of the stream comparison: this engine with the flags off
    agree_off = stream_agreement(phase4, lone_off, mixed_off)
    set_flags({"FLAGS_autotune": "on", "FLAGS_paged_grouped_kernel": True})
    a = dict(tune_s=tune_s, table=entries, lone_2500=lone, mixed_10=mixed,
             wall_s=wall, decode_steps=steps, prefills=prefills,
             launches=launches, expected=want, decode_winner_grouped=grouped,
             host_ms_per_decode_forward=host_ms,
             flags_off=dict(lone_2500=lone_off, mixed_10=mixed_off,
                            host_ms_per_decode_forward=host_off,
                            streams_vs_phase4=agree_off),
             phase4_host_ms_per_decode_forward=phase4[
                 "host_ms_per_decode_forward"],
             streams_vs_phase4=agree)
    log(f"dispatch (a): lone 2500-token request: TTFT "
        f"{lone['ttft_ms'][0]:.1f} ms, {lone['ms_per_decode_step_p50']:.2f} "
        f"ms/decode step (p50); 10 requests: TTFT p50 "
        f"{np.median(mixed['ttft_ms']):.1f} ms, "
        f"{mixed['ms_per_decode_step_p50']:.2f} ms/decode step (p50); host "
        f"ms per decode step's forward {host_ms:.2f} [{card}]")
    log(f"dispatch (a): the same traffic right after with both flags off: "
        f"lone TTFT {lone_off['ttft_ms'][0]:.1f} ms, "
        f"{lone_off['ms_per_decode_step_p50']:.2f} ms/decode step; 10 "
        f"requests TTFT p50 {np.median(mixed_off['ttft_ms']):.1f} ms, "
        f"{mixed_off['ms_per_decode_step_p50']:.2f} ms/decode step; host ms "
        f"per decode step's forward {host_off:.2f} (phase 4: "
        f"{phase4['host_ms_per_decode_forward']:.2f}); greedy streams "
        f"against phase 4's {agree_off['greedy_identical']} of "
        f"{agree_off['greedy']} identical, first differing token at "
        f"{agree_off['greedy_first_diff']} [{card}]")
    log(f"dispatch (a): {prefills} prefills, {steps} decode steps, launches "
        f"{launches} (exact; the decode bucket's winner is "
        f"{'grouped' if grouped else 'per-page'}); against phase 4's streams "
        f"(not a gate): greedy {agree['greedy_identical']} of "
        f"{agree['greedy']} identical, first differing token at "
        f"{agree['greedy_first_diff']}; sampled {agree['sampled_identical']} "
        f"of {agree['sampled']} (this engine's sampler drew for the tuning "
        f"pass first)")
    a["decode_profile"] = profile_decode(eng, rng, card)
    a["dispatch_host_us"] = dispatch_host_cost(dev, card)

    # (b): the GEMM kernel's best tile pinned in every matmul bucket
    pinned = pin_kernel_winners()
    set_flags({"FLAGS_autotune": "readonly"})
    since, d0, p0 = len(fwd.forwards), eng.decode_steps, eng.prefills
    reset_counters()
    mixed_b = drive(eng, batch)
    launches_b = read_counters()
    steps, prefills = eng.decode_steps - d0, eng.prefills - p0
    L = cfg.num_hidden_layers
    check(launches_b["matmul"] == (7 * L + 1) * (steps + prefills),
          f"dispatch (b): matmul launched {launches_b['matmul']} times, "
          f"expected {7 * L + 1} per forward x {steps + prefills}")
    want_b, grouped_b = check_dispatch_launches(
        "dispatch (b)", launches_b, fwd, since, cfg, steps, prefills)
    check(grouped_b, "dispatch (b): the grouped kernel was not pinned")
    b = dict(table=pinned, mixed_10=mixed_b, decode_steps=steps,
             prefills=prefills, launches=launches_b,
             host_ms_per_decode_forward=fwd.host_ms_per_decode(since),
             streams_vs_phase4=stream_agreement(phase4, None, mixed_b))
    log(f"dispatch (b): readonly table with the GEMM kernel pinned: 10 "
        f"requests, {prefills} prefills, {steps} decode steps, launches "
        f"{launches_b} (matmul {7 * L + 1} per forward, grouped {L} per "
        f"decode step); TTFT p50 {np.median(mixed_b['ttft_ms']):.1f} ms, "
        f"{mixed_b['ms_per_decode_step_p50']:.2f} ms/decode step (p50), host "
        f"ms per decode step's forward {b['host_ms_per_decode_forward']:.2f}"
        f"; greedy streams against phase 4's: "
        f"{b['streams_vs_phase4']['greedy_identical']} of "
        f"{b['streams_vs_phase4']['greedy']} identical, first differing "
        f"token at {b['streams_vs_phase4']['greedy_first_diff']} [{card}]")
    b["decode_profile"] = profile_decode(eng, rng, card)
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return a, b


def train_dispatch(seed, dev, card, layers=4, seq=4096, steps=2):
    """(c) the training step at LLaMA-2-7B widths, cut to `layers` layers:
    2 steps with the tuner off (cuBLAS), 2 under FLAGS_autotune=on, 2 under
    the table rewritten so the GEMM kernel wins (readonly), each from the
    same weights; the readonly run launches the kernel once per linear of
    each forward (7 L + 1); its losses and the tuned run's agree with
    cuBLAS's within TRAIN_DISPATCH_TOL."""
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = layers
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq))).to(dev)
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq))).to(dev)

    def run(mode):
        set_flags({"FLAGS_autotune": mode})
        model = amp.decorate(LlamaForCausalLM(cfg, device=dev, seed=seed),
                             level="O2", dtype="bfloat16")
        step = build_train_step(model, AdamW(
            learning_rate=1e-4, parameters=model.parameters()))
        reset_counters()
        ms, losses = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(x, y)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_counters()
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
        return dict(losses=losses, step_ms=ms, launches=launches)

    res = {"off": run("off")}
    # a table of its own, so that the tuned run measures its buckets
    set_flags({"FLAGS_autotune_cache_dir": os.path.join(
        get_flags(["FLAGS_autotune_cache_dir"])["FLAGS_autotune_cache_dir"],
        "train")})
    autotune.reset_tuner()
    res["on"] = run("on")
    winners = {k: e["winner"] for k, e in tuner_table().items()
               if e["op"] == "matmul" and f"|m={seq}|" in k}
    log(f"dispatch (c): training under FLAGS_autotune=on, winners at "
        f"m={seq}: {winners}")
    pin_kernel_winners()
    res["readonly_pinned"] = run("readonly")
    n = res["readonly_pinned"]["launches"]["matmul"]
    check(n == (7 * layers + 1) * steps, f"dispatch (c): matmul launched {n} "
          f"times in {steps} steps, expected {7 * layers + 1} per forward")
    ref = res["off"]["losses"]
    for mode in ("on", "readonly_pinned"):
        rel = max(abs(a - b) / abs(b) for a, b in zip(res[mode]["losses"],
                                                       ref))
        res[mode]["max_rel_loss_diff_vs_cublas"] = rel
        check(all(math.isfinite(v) for v in res[mode]["losses"])
              and rel <= TRAIN_DISPATCH_TOL,
              f"dispatch (c): {mode} losses {res[mode]['losses']} vs cuBLAS "
              f"{ref}: rel diff {rel} > {TRAIN_DISPATCH_TOL}")
    res["winners_on"] = winners
    log(f"dispatch (c): LLaMA-2-7B widths, {layers} layers, batch 1 x {seq}, "
        f"bf16 O2: losses cuBLAS {ref}, tuned {res['on']['losses']}, GEMM "
        f"kernel pinned {res['readonly_pinned']['losses']} (max rel diff "
        f"{res['readonly_pinned']['max_rel_loss_diff_vs_cublas']:.2e}, bar "
        f"{TRAIN_DISPATCH_TOL}); step ms cuBLAS {res['off']['step_ms']}, "
        f"pinned {res['readonly_pinned']['step_ms']}; matmul launches {n} "
        f"[{card}]")
    return res


def tiny_dispatch_parity(seed, dev):
    """(d) a tiny f32 LLaMA (head_dim 128, 16-token pages, tables 8 pages
    wide) with the grouped flag on and the GEMM kernel pinned (a first
    CUDA pass under FLAGS_autotune=on fills the table, which is then
    rewritten and read readonly): the greedy streams through the kernels
    on CUDA equal those through the plain versions on the CPU."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2, seq=128)
    cfg.num_key_value_heads = 1
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu = LlamaForCausalLM(cfg, device=dev)
    load_llama_state(gpu, {k: v.numpy() for k, v in cpu.state_dict().items()})
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (5, 9, 17, 3, 40)]

    def serve(model, d):
        eng = ServingEngine(model, max_batch=3, max_seq_len=128,
                            page_size=16, device=d)
        for p in prompts:
            eng.add_request(p, max_new_tokens=24)
        return {f.request_id: f.output_ids.tolist() for f in eng.run()}

    set_flags({"FLAGS_autotune": "on"})
    serve(gpu, dev)
    pin_kernel_winners()
    set_flags({"FLAGS_autotune": "readonly"})
    reset_counters()
    streams = [serve(cpu, "cpu"), serve(gpu, dev)]
    launches = read_counters()
    check(launches["matmul"] > 0 and launches["paged_attention_grouped"] > 0
          and launches["paged_attention"] == 0,
          f"tiny dispatch: the new kernels did not run on CUDA: {launches}")
    check(streams[0] == streams[1], f"tiny dispatch greedy streams differ: "
          f"cpu {streams[0]} cuda {streams[1]}")
    log(f"parity: tiny f32 LLaMA (2 layers, hidden 256, 2 heads of 128 over 1 "
        f"KV head), grouped decode on, GEMM kernel pinned, {len(prompts)} "
        f"greedy requests x 24 tokens: CUDA == CPU; launches {launches}")
    return dict(requests=len(prompts), identical=True, launches=launches)


def measured_dispatch(seed, dev, card, phase4):
    """Phase 8: (a)-(d) with FLAGS_paged_grouped_kernel set and the tuner's
    table in a temporary directory; the flags are restored afterwards, so
    the other phases keep the fixed dispatch."""
    old = get_flags(list(DISPATCH_FLAGS))
    tmp = tempfile.mkdtemp(prefix="autotune-")
    try:
        set_flags({"FLAGS_autotune": "on", "FLAGS_paged_grouped_kernel": True,
                   "FLAGS_autotune_cache_dir": tmp})
        autotune.reset_tuner()
        a, b = serve_dispatch(seed, dev, card, phase4)
        c = train_dispatch(seed, dev, card)
        d = tiny_dispatch_parity(seed, dev)
    finally:
        set_flags(old)
        autotune.reset_tuner()
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(serving=a, serving_pinned=b, training=c, tiny_parity=d)


# ---------------------------------------------------------------------------
# phase 9: varlen and dropout flash attention (the seg, drop and seg_drop
# bodies of the three flash sites)
# ---------------------------------------------------------------------------


# the TPU kernel bodies each CUDA variant replaces
# (paddle_tpu/kernels/flash_attention.py): the backward both passes' bodies
VARIANT_REPLACES = {
    ("fwd", "seg"): (190,), ("fwd", "drop"): (196,),
    ("fwd", "seg_drop"): (202,), ("bwd", "seg"): (410, 418),
    ("bwd", "drop"): (425, 433), ("bwd", "seg_drop"): (439, 447)}
PASS_KERNEL = {"fwd": "flash_fwd", "bwd": "flash_bwd"}
DROP_RATE = 0.1


def packed_ids(rng, b, s, pad, lo=64, hi=4096):
    """[b, s] int32 segment ids of sequences of lengths drawn in [lo, hi]
    packed from the start of each row (the last one cut to fit), the last
    `pad` positions -1."""
    ids = np.full((b, s), -1, np.int32)
    for i in range(b):
        pos, sid = 0, 0
        while pos < s - pad:
            n = min(int(rng.randint(lo, hi + 1)), s - pad - pos)
            ids[i, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return ids


def variant_controls(q, k, v, do, lse, delta, scale, causal, var, want):
    """Readings of the variant check on faults made from the plain
    versions, against the sound plain outputs `want`: every one must exceed
    the bar. "seg_shift": segment ids shifted by one token. "tile_local":
    the dropout mask keyed by positions within 64-row tiles instead of
    global ones. "seed": the seed off by one. "dv_undropped": dV from the
    undropped p (the sound lse and delta). "dq_tile": dQ without the first
    128-key tile's contribution."""
    bh, s_q, s_kv = q.shape[0], q.shape[1], k.shape[1]

    def run(v_):
        out, lse2 = kfa.flash_fwd_ref(q, k, v, scale, causal, v_)
        delta2 = kfa.flash_bwd_delta(out, do)
        dq, dk, dv = kfa.flash_bwd_ref(q, k, v, do, lse2, delta2, scale,
                                       causal, v_)
        return dict(out=out, dq=dq, dk=dk, dv=dv)

    def variant(**kw):
        base = dict(seg_q=var.seg_q, seg_k=var.seg_k, heads=var.heads,
                    rate=var.rate, seed=var.seed)
        base.update(kw)
        return kfa.Variant(**base)

    got = {"dq_tile": dict(dq=dq_without_tile(q, k, v, do, lse, delta,
                                               scale, causal, var))}
    if var.seg_q is not None:
        got["seg_shift"] = run(variant(
            seg_q=torch.roll(var.seg_q, 1, dims=1),
            seg_k=torch.roll(var.seg_k, 1, dims=1)))
    if var.rate:
        ar = torch.arange(max(bh, s_q, s_kv), device=q.device)
        local = kfa.dropout_keep(var.seed, ar[:bh, None, None],
                                 (ar[:s_q] % 64)[None, :, None],
                                 (ar[:s_kv] % 64)[None, None, :], var.rate)
        got["tile_local"] = run(variant(keep=local))
        del local
        got["seed"] = run(variant(seed=var.seed + 1))
        _, dv = kfa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale, causal,
                                      variant(rate=0.0))
        got["dv_undropped"] = dict(dv=dv)
        del dv
    return {fault: {key: row_rel_err(t, want[key]) for key, t in ts.items()}
            for fault, ts in got.items()}


def variant_case(name, variant, b, heads, s, causal, dtype, gen, dev, rng,
                 controls=False, seed=20260917):
    """The forward and backward kernels of one variant against their plain
    versions, row by row under FLASH_TOL, on [b * heads, s, 128] (row bh reads the segment ids
    of batch bh // heads: packed sequences of 64-4096 tokens, s / 32
    padding, -1 for queries, -2 for keys); with `controls`, faults that
    must fail the bar, and a `timings` closure (kernel, plain, PyTorch's
    SDPA with a boolean block-diagonal mask and / or dropout_p)."""
    d = kfa.HEAD_DIM
    scale = d ** -0.5
    bh = b * heads
    sq = sk = None
    if variant != "drop":
        sq = torch.from_numpy(packed_ids(rng, b, s, s // 32)).to(dev)
        sk = torch.where(sq < 0, -2, sq).to(torch.int32)
    var = kfa.Variant(sq, sk, heads=heads,
                      rate=0.0 if variant == "seg" else DROP_RATE, seed=seed)
    check(var.name == variant, f"variant {name}: {var.name}")

    def rnd():
        return torch.randn(bh, s, d, generator=gen, device=dev).to(dtype)

    q, k, v, do = rnd(), rnd(), rnd(), rnd()
    before = {p: kfa.variant_launches[(p, variant)] for p in kfa.PASSES}
    out, lse = kfa.flash_fwd(q, k, v, scale, causal, var)
    delta = kfa.flash_bwd_delta(out, do)
    dq, dk, dv = kfa.flash_bwd(q, k, v, do, lse, delta, scale, causal, var)
    torch.cuda.synchronize()
    check(all(kfa.variant_launches[(p, variant)] == before[p] + 1
              for p in kfa.PASSES), f"variant {name}: kernels not launched")
    out_r, lse_r = kfa.flash_fwd_ref(q, k, v, scale, causal, var)
    dq_r, dk_r, dv_r = kfa.flash_bwd_ref(q, k, v, do, lse_r, delta, scale,
                                         causal, var)
    want = dict(out=out_r, dq=dq_r, dk=dk_r, dv=dv_r)
    tol = FLASH_TOL[dtype]
    errs, abs_err = {}, {}
    for key, got in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
        abs_err[key] = (got.float() - want[key].float()).abs().max().item()
        errs[key] = row_rel_err(got, want[key])
        check(errs[key] <= tol, f"flash {variant} {name} {key}: row rel err "
              f"{errs[key]} > {tol}")
    live = lse_r > -1e29
    lse_err = (lse[live] - lse_r[live]).abs().max().item()
    check(lse_err <= 1e-3, f"flash {variant} {name} lse: max abs err "
          f"{lse_err}")
    check(torch.equal(lse[~live], lse_r[~live]) and not out[~live].any(),
          f"flash {variant} {name}: a row that sees no key is not 0 / -1e30")
    ctl = {}
    if controls:
        ctl = variant_controls(q, k, v, do, lse_r, delta, scale, causal, var,
                               want)
        for fault, readings in ctl.items():
            for key, err in readings.items():
                check(err > tol, f"flash {variant} {name}: the {fault} "
                      f"control reads {key} {err}, within the bar {tol}")
    del out_r, lse_r, dk_r, dv_r, dq_r, want
    # visible pairs: one head of each batch row, times the heads
    pairs = visible_pairs(s, s, causal, sq, sk) * heads if sq is not None \
        else visible_pairs(s, s, causal) * bh
    elt = q.element_size()
    rate_ = BF16_FLOP_S if dtype == torch.bfloat16 else TF32_FLOP_S
    n_t = bh * s * d * elt
    ids = 0 if sq is None else 2 * b * s * 4
    # the dropout mask: one keep bit per visible pair in each kernel
    mask_ops = MASK_INT_OPS * pairs if var.rate else 0
    b_fwd = bound(4 * n_t + 4 * bh * s + ids, 4 * d * pairs, rate_,
                  mask_ops)
    # q, dO, k, v, lse, delta read, dq, dk, dv written; 5 products
    b_bwd = bound(7 * n_t + 8 * bh * s + ids, 10 * d * pairs, rate_,
                  mask_ops)
    res = dict(case=name, variant=variant, b=b, heads=heads, s=s,
               causal=causal, dtype=str(dtype).split(".")[-1],
               rate=var.rate, visible_pairs=pairs,
               pair_share=pairs / (bh * s * s), tol=tol, lse_err=lse_err,
               controls=ctl)
    for key, kb, err, aerr, flops in (
            ("fwd", b_fwd, errs["out"], abs_err["out"], 4 * d * pairs),
            ("bwd", b_bwd, max(errs[t] for t in ("dq", "dk", "dv")),
             max(abs_err[t] for t in ("dq", "dk", "dv")), 10 * d * pairs)):
        res[key] = dict(row_rel_err=err, max_abs_err=aerr, bound_ms=kb[0],
                        bound_by=kb[1],
                        products_bound_ms=flops / rate_ * 1e3,
                        mask_bound_ms=mask_ops / INT32_OPS_S * 1e3)

    def timings():
        it = 10
        for key, fn, ref in (
                ("fwd", lambda: kfa.flash_fwd(q, k, v, scale, causal, var),
                 lambda: kfa.flash_fwd_ref(q, k, v, scale, causal, var)),
                ("bwd", lambda: kfa.flash_bwd(q, k, v, do, lse, delta, scale,
                                              causal, var),
                 lambda: kfa.flash_bwd_ref(q, k, v, do, lse, delta, scale,
                                           causal, var))):
            res[key]["ms"], res[key]["timer"] = events_ms(fn, it), "events"
            res[key]["plain_ms"] = events_ms(ref, 2)
        # SDPA over [b, heads, s, d] views: a boolean [b, 1, s, s] mask of
        # equal ids (and the causal triangle) for segments, dropout_p for
        # dropout; its backward computes dQ, dK and dV in one call
        q4, k4, v4 = (t.view(b, heads, s, d) for t in (q, k, v))
        mask = None
        if sq is not None:
            mask = (sq[:, None, :, None] == sk[:, None, None, :])
            if causal:
                mask = mask & torch.ones(s, s, dtype=torch.bool,
                                         device=dev).tril()
        kw = dict(attn_mask=mask, dropout_p=var.rate,
                  is_causal=causal and mask is None)
        res["fwd"]["library_ms"] = events_ms(
            lambda: TF.scaled_dot_product_attention(q4, k4, v4, **kw), it)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
        o = TF.scaled_dot_product_attention(qg, kg, vg, **kw)
        bwd = events_ms(lambda: torch.autograd.grad(
            o, (qg, kg, vg), do.view(b, heads, s, d), retain_graph=True),
            it)
        res["bwd"]["library_ms"] = bwd

    res["timings"] = timings
    return res


def per_sequence_reference(q, k, v, g, out, lens, heads, rate, seed):
    """Causal attention of each packed sequence alone, in f32, for the
    listed heads of q/k/v [total, heads, d] (bf16), with the threefry mask
    of the packed call (batch-head row = head, global positions), and its
    gradients for the output cotangent g by the flash backward's math from
    the stored output `out` (delta = rowsum(g * out), as the backward
    kernels take it: a row that sees few keys forms dQ from dP - delta, a
    difference that bf16 rounding of a recomputed output would swamp):
    (out, dq, dk, dv) [total, len(heads), d]."""
    scale = q.shape[-1] ** -0.5
    res = [torch.zeros(q.shape[0], len(heads), q.shape[-1],
                       device=q.device) for _ in range(4)]
    start = 0
    for n in lens:
        sl = slice(start, start + n)
        pos = torch.arange(start, start + n, device=q.device)
        tri = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        for j, hh in enumerate(heads):
            qs, ks, vs, gs, os_ = (t[sl, hh].float()
                                   for t in (q, k, v, g, out))
            p = torch.softmax((qs @ ks.T * scale).masked_fill(
                ~tri, float("-inf")), dim=-1)
            dp = gs @ vs.T
            p_d = p
            if rate:
                keep = kfa.dropout_keep(seed, hh, pos[:, None],
                                        pos[None, :], rate)
                inv = 1.0 / (1.0 - rate)
                p_d = torch.where(keep, p, 0.0) * inv
                dp = torch.where(keep, dp, 0.0) * inv
            o = p_d @ vs
            delta = (gs * os_).sum(-1, keepdim=True)
            ds = p * (dp - delta) * scale
            for r, t in zip(res, (o, ds @ ks, ds.T @ qs, p_d.T @ gs)):
                r[sl, j] = t
        start += n
    return res


def varlen_7b(seed, dev, card, total=16384, heads=32, check_heads=(0, 13,
                                                                    31)):
    """(b) `F.flash_attn_unpadded` at LLaMA-2-7B's attention width (32
    heads of 128, bf16) over sequences of 64-4096 tokens from --seed packed
    to 16384 tokens, causal, forward and backward in training, at dropout 0
    (the seg kernels) and 0.1 (seg_drop), each run counted from zero; three
    heads held against per-sequence plain attention."""
    rng = np.random.RandomState(seed + 9)
    lens = []
    while sum(lens) < total:
        lens.append(int(rng.randint(64, 4097)))
    lens[-1] -= sum(lens) - total
    cu = torch.tensor([0] + np.cumsum(lens).tolist(), dtype=torch.int32,
                      device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    q, k, v, g = (torch.randn(total, heads, 128, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    pairs = sum(n * (n + 1) // 2 for n in lens) * heads
    runs = {}
    for rate in (0.0, DROP_RATE):
        name = "seg_drop" if rate else "seg"
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        state = ptt.get_rng_state()
        torch.cuda.synchronize()
        # the main path: counts from zero, read right after
        kfa.reset_launches()
        t0 = time.perf_counter()
        out, _ = F.flash_attn_unpadded(*ts, cu, cu, max(lens), max(lens),
                                       dropout=rate, causal=True,
                                       training=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out.backward(g)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {f"{p}_{v_}": n for (p, v_), n in
                    kfa.variant_launches.items() if n}
        check(launches == {f"{p}_{name}": 1 for p in kfa.PASSES},
              f"varlen dropout {rate}: launches {launches}")
        kseed = None
        if rate:  # the seed the call drew: the stream's next draw
            after = ptt.get_rng_state()
            ptt.set_rng_state(state)
            kseed = trandom.next_seed()
            ptt.set_rng_state(after)
        want = per_sequence_reference(q, k, v, g, out.detach(), lens,
                                      check_heads, rate, kseed)
        hs = list(check_heads)
        errs = {key: row_rel_err(got[:, hs].float(), w)
                for key, got, w in zip(("out", "dq", "dk", "dv"),
                                       (out.detach(), ts[0].grad,
                                        ts[1].grad, ts[2].grad), want)}
        for key, err in errs.items():
            check(err <= FLASH_TOL[torch.bfloat16],
                  f"varlen dropout {rate} {key}: row rel err {err} against "
                  f"per-sequence attention")
        check(all(torch.isfinite(t).all() for t in
                  (out, ts[0].grad, ts[1].grad, ts[2].grad)),
              f"varlen dropout {rate}: non-finite values")
        del want

        def fwd_bwd():
            xs = [t.detach().requires_grad_() for t in (q, k, v)]
            o, _ = F.flash_attn_unpadded(*xs, cu, cu, max(lens), max(lens),
                                         dropout=rate, causal=True,
                                         training=True)
            o.backward(g)

        _, by_name = _device_profile(fwd_bwd)
        dev_ms = {n[:60]: us / 1e3 for n, us in by_name.items()}
        flash_ms = sum(ms for n, ms in dev_ms.items() if "flash_" in n)
        runs[name] = dict(rate=rate, seed=kseed, launches=launches,
                          fwd_wall_ms=(t1 - t0) * 1e3,
                          bwd_wall_ms=(t2 - t1) * 1e3, row_rel_err=errs,
                          device_ms=dev_ms, flash_device_ms=flash_ms)
        log(f"varlen: {len(lens)} sequences packed to {total} tokens x "
            f"{heads} heads of 128 bf16, causal, dropout {rate}: forward "
            f"{(t1 - t0) * 1e3:.2f} ms, backward {(t2 - t1) * 1e3:.2f} ms "
            f"wall (first call); flash kernels {flash_ms:.3f} ms device per "
            f"forward + backward; launches {launches}; heads {hs} against "
            f"per-sequence attention: row rel err " + ", ".join(
                f"{key} {e:.3g}" for key, e in errs.items()) + f" [{card}]")
    return dict(lens=lens, total=total, heads=heads, visible_pairs=pairs,
                pair_share=pairs / (heads * total * total), runs=runs)


class MaskedEncoder(torch.nn.Module):
    """Token and position embeddings, `layers` incubate
    `FusedTransformerEncoderLayer`s (pre-LN, GELU, dropout 0.1 everywhere,
    attention dropout included), a final LayerNorm and the output head tied
    to the token embedding."""

    def __init__(self, vocab, d, heads, ff, layers, seq, dev, gen):
        super().__init__()
        self.embed = Embedding(vocab, d, device=dev)
        self.pos = Embedding(seq, d, device=dev)
        with torch.no_grad():
            for e in (self.embed, self.pos):
                e.weight.normal_(0.0, 0.02, generator=gen)
        self.layers = torch.nn.ModuleList(
            FusedTransformerEncoderLayer(
                d, heads, ff, dropout_rate=DROP_RATE, activation="gelu",
                normalize_before=True, device=dev, generator=gen)
            for _ in range(layers))
        self.norm = LayerNorm(d, device=dev)

    def forward(self, ids):
        h = self.embed(ids) + self.pos.weight[:ids.shape[1]]
        for layer in self.layers:
            h = layer(h)
        return F.linear(self.norm(h), self.embed.weight.t())


def train_fused_encoder(seed, dev, card, layers=24, batch=4, seq=2048,
                        steps=3, vocab=50304, d=2048, heads=16, ff=8192):
    """(c) GPT-3 1.3B layer widths (d 2048, 16 heads of 128, ffn 8192,
    vocab 50304) as 24 pre-LN fused encoder layers trained on masked-token
    prediction (15 % of positions masked, random ids from --seed, the same
    batch each step), bf16 O2, AdamW(1e-4), with FLAGS_flash_dropout_kernel
    on: a warm step, then `steps` timed steps counted from zero (24
    forward, dK/dV and dQ dropout launches a step, nothing else), the keep
    share of layer 0's mask in one step, one profiled step."""
    mask_id = vocab - 1
    t0 = time.perf_counter()
    ptt.seed(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = amp.decorate(MaskedEncoder(vocab, d, heads, ff, layers, seq, dev,
                                       gen), level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(seed + 3)
    ids = rng.randint(0, vocab - 1, (batch, seq))
    masked = rng.rand(batch, seq) < 0.15
    x = torch.from_numpy(np.where(masked, mask_id, ids)).to(dev)
    y = torch.from_numpy(np.where(masked, ids, -100)).to(dev)

    def step():
        model.train()
        loss = F.cross_entropy(model(x).float(), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"encoder: GPT-3 1.3B widths, {layers} fused encoder layers, "
        f"{n_params / 1e9:.3f} B bf16 parameters, ready in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    losses = [step()]
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    state = ptt.get_rng_state()  # layer 0's attention seed: the next draw
    kfa.reset_launches()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {f"{p}_{v_}": n for (p, v_), n in kfa.variant_launches.items()
                if n}
    check(launches == {f"{p}_drop": layers * steps for p in kfa.PASSES},
          f"encoder: launches {launches} in {steps} steps, expected "
          f"{layers * steps} of each dropout kernel and no other")
    after = ptt.get_rng_state()
    ptt.set_rng_state(state)
    seed0 = trandom.next_seed()
    ptt.set_rng_state(after)
    kept, ar = 0, torch.arange(seq, device=dev)
    for h0 in range(0, batch * heads, 8):  # 8 rows of b*h at a time
        rows = torch.arange(h0, min(h0 + 8, batch * heads), device=dev)
        kept += int(kfa.dropout_keep(seed0, rows[:, None, None],
                                     ar[None, :, None], ar[None, None, :],
                                     DROP_RATE).sum())
    drop_share = 1.0 - kept / (batch * heads * seq * seq)
    check(abs(drop_share - DROP_RATE) <= 0.005,
          f"encoder: layer 0's mask drops {drop_share}, rate {DROP_RATE}")
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f"encoder: loss {losses}")
    check(losses[-1] < losses[0], f"encoder: loss did not fall: {losses}")
    p50 = float(np.median(step_ms))
    tok_s = batch * seq / (p50 / 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    wall, by_name = _device_profile(step)
    busy = sum(by_name.values()) / 1e3
    classes = {}
    for name, us in by_name.items():
        c = _kernel_class(name)
        classes[c] = classes.get(c, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    res = dict(card=card, layers=layers, params=n_params, batch=batch,
               seq=seq, losses=losses, warm_step_ms=warm_ms,
               step_ms=step_ms, step_ms_p50=p50, tokens_per_s=tok_s,
               launches=launches, layer0_seed=seed0,
               layer0_drop_share=drop_share, max_memory_allocated_gib=peak_gib,
               profile=dict(wall_ms=wall, device_busy_ms=busy,
                            idle_share=1.0 - busy / wall,
                            device_ms_by_class=classes,
                            top_kernels_ms=[(n[:90], us / 1e3)
                                            for n, us in top]))
    log(f"encoder: losses {', '.join(f'{v:.4f}' for v in losses)} (warm "
        f"step first); batch {batch} x {seq}: warm step {warm_ms:.1f} ms; "
        f"{steps} steps p50 {p50:.1f} ms (min {min(step_ms):.1f}, max "
        f"{max(step_ms):.1f}), {tok_s:.1f} tokens/s; peak {peak_gib:.2f} GiB "
        f"allocated [{card}]")
    log(f"encoder: launches over the {steps} timed steps {launches}; layer "
        f"0's mask (seed {seed0}) drops {drop_share:.5f} of "
        f"{batch * heads * seq * seq} pairs (rate {DROP_RATE})")
    log(f"profile: one encoder step: {wall:.1f} ms wall, {busy:.1f} ms "
        f"device busy, idle share {1.0 - busy / wall:.3f}; device ms by "
        f"class " + ", ".join(f"{c} {ms:.1f}" for c, ms in sorted(
            classes.items(), key=lambda kv: -kv[1])) + f" [{card}]")
    for name, ms in res["profile"]["top_kernels_ms"]:
        log(f"profile:   {ms:8.3f} ms  {name}")
    del model, opt, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return res


def lse_entry(seed, dev, card, s=4096, heads=32):
    """(d) `flash_attention_with_lse_bshd` at [1, 4096, 32, 128] bf16
    causal: out, lse and the gradients of a loss on both against the plain
    versions (the lse cotangent folded into delta, which both take from the
    entry's stored output)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    q, k, v, g = (torch.randn(1, s, heads, 128, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    g_lse = torch.randn(1, heads, s, generator=gen, device=dev)
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    kfa.reset_launches()
    out, lse = kfa.flash_attention_with_lse_bshd(*ts, causal=True)
    torch.autograd.backward((out, lse), (g, g_lse))
    torch.cuda.synchronize()
    launches = {f"{p}_{v_}": n for (p, v_), n in kfa.variant_launches.items()
                if n}
    check(launches == {f"{p}_plain": 1 for p in kfa.PASSES},
          f"lse entry: launches {launches}")

    def bhsd(t):
        return t.transpose(1, 2).reshape(heads, s, 128).contiguous()

    scale = 128 ** -0.5
    qb, kb, vb, gb = map(bhsd, (q, k, v, g))
    out_r, lse_r = kfa.flash_fwd_ref(qb, kb, vb, scale, True)
    # delta from the stored output, as the backward kernels take it
    delta = kfa.flash_bwd_delta(bhsd(out.detach()), gb) - g_lse[0]
    dq_r, dk_r, dv_r = kfa.flash_bwd_ref(qb, kb, vb, gb, lse_r, delta,
                                         scale, True)
    tol = FLASH_TOL[torch.bfloat16]
    errs = {key: row_rel_err(bhsd(got), want) for key, got, want in (
        ("out", out.detach(), out_r), ("dq", ts[0].grad, dq_r),
        ("dk", ts[1].grad, dk_r), ("dv", ts[2].grad, dv_r))}
    lse_err = (lse[0] - lse_r).abs().max().item()
    for key, err in errs.items():
        check(err <= tol, f"lse entry {key}: row rel err {err} > {tol}")
    check(lse_err <= 1e-3, f"lse entry: lse max abs err {lse_err}")
    log(f"lse entry: [1, {s}, {heads}, 128] bf16 causal, out, lse and both "
        f"cotangents against the plain versions: row rel err " + ", ".join(
            f"{key} {e:.3g}" for key, e in errs.items())
        + f", lse max abs err {lse_err:.3g}; launches {launches} [{card}]")
    return dict(row_rel_err=errs, lse_err=lse_err, launches=launches)


def tiny_encoder_parity(seed, dev, layers=2):
    """(e) A tiny f32 stack of fused encoder layers (d 256, 2 heads of 128,
    ffn 512) with attention dropout 0.1 and no other dropout: CUDA through
    the drop kernels and the CPU through their plain versions, from the
    same weights and the same `paddle_tpu_torch.seed`, so the same masks:
    outputs and parameter gradients within the f32 bar."""
    ptt.seed(seed)

    def stack(d_):
        return torch.nn.Sequential(*(FusedTransformerEncoderLayer(
            256, 2, 512, dropout_rate=0.0, attn_dropout_rate=DROP_RATE,
            activation="gelu", normalize_before=True, device=d_)
            for _ in range(layers)))

    cpu, gpu = stack("cpu"), stack(dev)
    gpu.load_state_dict(fused_encoder_state_from_numpy(
        fused_encoder_state_to_numpy(cpu), gpu))
    x = torch.randn(2, 256, 256, generator=torch.Generator().manual_seed(
        seed))
    g = torch.randn(2, 256, 256, generator=torch.Generator().manual_seed(
        seed + 1))
    kfa.reset_launches()
    outs = []
    for model, d_ in ((cpu, "cpu"), (gpu, dev)):
        ptt.seed(seed + 2)
        out = model(x.to(d_))
        out.backward(g.to(d_))
        outs.append(out.detach().cpu())
    check(kfa.variant_launches[("fwd", "drop")] == layers
          and kfa.variant_launches[("bwd", "drop")] == layers,
          "tiny encoder: CUDA did not run the drop kernels")
    err = row_rel_err(outs[1], outs[0])
    tol = FLASH_TOL[torch.float32]
    check(err <= tol, f"tiny encoder: CUDA vs CPU out {err} > {tol}")
    worst = 0.0
    for (name, p), q_ in zip(cpu.named_parameters(), gpu.parameters()):
        if p.grad is None:
            continue
        worst = max(worst, row_rel_err(q_.grad.cpu().reshape(
            -1, p.shape[-1]), p.grad.reshape(-1, p.shape[-1])))
    check(worst <= tol, f"tiny encoder: gradients differ by {worst}")
    log(f"parity: tiny f32 fused encoder ({layers} layers, attention dropout "
        f"{DROP_RATE}), CUDA drop kernels vs CPU plain versions: out row rel "
        f"err {err:.3g}, gradients {worst:.3g} (bar {tol})")
    return dict(out_row_rel_err=err, grad_row_rel_err=worst)


def flash_variants(seed, dev, card):
    """Phase 9: (a) the variant kernels against their plain versions, with
    faults, then (b)-(e); returns every result, and the (a) cases whose
    times the kernels line reports."""
    old = get_flags(["FLAGS_flash_dropout_kernel"])
    set_flags({"FLAGS_flash_dropout_kernel": True})
    try:
        gen = torch.Generator(device=dev).manual_seed(seed + 5)
        rng = np.random.RandomState(seed + 5)
        bf16, f32 = torch.bfloat16, torch.float32
        cases = [
            variant_case("seg_causal_bf16", "seg", 2, 8, 4096, True, bf16,
                         gen, dev, rng, controls=True),
            variant_case("drop_full_bf16", "drop", 2, 16, 2048, False, bf16,
                         gen, dev, rng, controls=True),
            variant_case("seg_drop_causal_bf16", "seg_drop", 2, 8, 4096,
                         True, bf16, gen, dev, rng, controls=True),
            variant_case("seg_full_bf16", "seg", 2, 8, 4096, False, bf16,
                         gen, dev, rng),
            variant_case("drop_causal_bf16", "drop", 2, 8, 2048, True, bf16,
                         gen, dev, rng),
            variant_case("seg_causal_f32", "seg", 2, 2, 512, True, f32, gen,
                         dev, rng, controls=True),
            variant_case("drop_full_f32", "drop", 2, 2, 512, False, f32, gen,
                         dev, rng, controls=True),
            variant_case("seg_drop_full_f32", "seg_drop", 2, 2, 512, False,
                         f32, gen, dev, rng, controls=True)]
        for r in cases:
            for key in kfa.PASSES:
                log(f"kernel: flash {key} {r['variant']} {r['case']} "
                    f"({r['b']}x{r['heads']}x{r['s']}, causal {r['causal']}, "
                    f"rate {r['rate']}, visible share "
                    f"{r['pair_share']:.4f}): row rel err "
                    f"{r[key]['row_rel_err']:.3g} vs plain (bar "
                    f"{r['tol']:.3g}), max abs err "
                    f"{r[key]['max_abs_err']:.3g}")
            for fault, readings in r["controls"].items():
                log(f"kernel: flash {r['variant']} {r['case']} control "
                    f"'{fault}' (must exceed the bar {r['tol']:.3g}): row "
                    f"rel err " + ", ".join(f"{key} {err:.3g}" for key, err
                                            in readings.items()))
        timed = {}
        for r in cases[:3]:
            r.pop("timings")()
            timed[r["variant"]] = r
            for key in kfa.PASSES:
                t = r[key]
                log(f"kernel: flash {key} {r['variant']} {r['case']}: "
                    f"{t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, "
                    f"library {t['library_ms']:.4f} ms, bound "
                    f"{t['bound_ms']:.4f} ms ({t['bound_by']}), device time "
                    f"({t['timer']}) [{card}]")
        for r in cases[3:]:
            r.pop("timings")
        gc.collect()
        torch.cuda.empty_cache()
        varlen = varlen_7b(seed, dev, card)
        encoder = train_fused_encoder(seed, dev, card)
        lse = lse_entry(seed, dev, card)
        parity = tiny_encoder_parity(seed, dev)
    finally:
        set_flags(old)
    return dict(cases=cases, varlen=varlen, encoder=encoder, lse=lse,
                parity=parity), timed


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"device: {kind}, count {count}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    log(card)

    # 2. build
    secs = _build.build()
    log(f"build: {len(_build.SOURCES)} kernels in {secs:.1f} s")
    for name, out in sorted(_build.build_log.items()):
        fn = "?"  # ptxas names each instance before its report
        for line in out.splitlines():
            if "Function properties for" in line:
                fn = kernel_name(
                    line.split("Function properties for", 1)[1].strip())
            elif "registers" in line or "spill" in line:
                log(f"build: {name}: {fn}: {line.strip()}")

    # 3. kernels against their plain versions at the serving and training
    # shapes (the timings wait until after the serving run, so that no
    # profiler session precedes the serving measurements)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    lens = [0, 1, 15, 16, 17, 1000, 2049, 4096]
    bf16, f32 = torch.bfloat16, torch.float32
    f16 = torch.float16
    # timed: LLaMA-2-7B's and 13B's decode (8 rows) and prefill widths,
    # and float16; checked only: odd widths (the stream instances' edges),
    # rows past the ring (the two-pass stream instance), no weight, a
    # float32 weight, x 2 bytes off a 16-byte boundary
    rms = [rms_case("decode", 8, 4096, bf16, gen, dev),
           rms_case("prefill", 4096, 4096, bf16, gen, dev),
           rms_case("decode_13b", 8, 5120, bf16, gen, dev),
           rms_case("prefill_13b", 2512, 5120, bf16, gen, dev),
           rms_case("prefill_f16", 4096, 4096, f16, gen, dev)]
    rms += [rms_case(f"{rows}x{cols}_{dt}_w{wt}_off{off}", rows, cols,
                     {"bf16": bf16, "f16": f16, "f32": f32}[dt], gen, dev,
                     weight=wt, offset=off, timed=False)
            for rows, cols, dt, wt, off in RMS_UNTIMED]
    paged = [paged_case("mha_bf16", bf16, 32, 32, gen, dev, lens),
             paged_case("gqa_bf16", bf16, 32, 8, gen, dev, lens),
             paged_case("mha_f32", f32, 32, 32, gen, dev, lens),
             paged_case("mqa_bf16", bf16, 32, 1, gen, dev, lens),
             paged_case("g32_bf16", bf16, 64, 2, gen, dev, lens),
             paged_case("d256_bf16", bf16, 32, 2, gen, dev, lens, d=256)]
    rms_bwd = [rms_bwd_case("train", 4096, 4096, bf16, gen, dev),
               rms_bwd_case("rows8", 8, 4096, bf16, gen, dev),
               rms_bwd_case("train_f32", 4096, 4096, f32, gen, dev),
               rms_bwd_case("rows8_f32", 8, 4096, f32, gen, dev),
               rms_bwd_case("rows8_13b", 8, 5120, bf16, gen, dev),
               rms_bwd_case("train_13b", 2512, 5120, bf16, gen, dev),
               rms_bwd_case("train_f16", 4096, 4096, f16, gen, dev)]
    rms_bwd += [rms_bwd_case(f"{rows}x{cols}_{dt}_w{wt}_off{off}", rows,
                             cols, {"bf16": bf16, "f16": f16, "f32": f32}[dt],
                             gen, dev, weight=wt, offset=off, timed=False)
                for rows, cols, dt, wt, off in RMS_UNTIMED]
    qmm = [qmm_case(f"{k}->{n} m{m} {wd} g{gs}", m, k, n, wd, gs, bf16, gen,
                    dev)
           for k, n in ((5120, 5120), (5120, 13824), (13824, 5120))
           for m in (8, 2512)
           for wd, gs in (("int8", -1), ("int8", 64), ("int4", -1),
                          ("int4", 128))]
    qmm.append(qmm_case("512->1024 m33 int4 g64", 33, 512, 1024, "int4", 64,
                        f32, gen, dev))
    # the decode kernel's m and n tails and a k % 128 == 64 tail (checked,
    # not timed)
    qmm_tails = [qmm_case(f"{k}->{n} m{m} {wd} g{gs}", m, k, n, wd, gs, bf16,
                          gen, dev, timed=False)
                 for m, k, n, wd, gs in (
                     (1, 5120, 5120, "int8", -1), (16, 5120, 384, "int4", 128),
                     (9, 13824, 256, "int8", 64), (3, 320, 11008, "int4", 64),
                     (16, 5184, 384, "int8", -1))]
    paged_q8 = [paged_q8_case("mha_bf16_13b", bf16, 40, 40, gen, dev, lens),
                paged_q8_case("gqa_bf16", bf16, 32, 8, gen, dev, lens),
                paged_q8_case("mha_f32", f32, 32, 32, gen, dev, lens),
                paged_q8_case("mqa_bf16", bf16, 32, 1, gen, dev, lens),
                paged_q8_case("g32_bf16", bf16, 64, 2, gen, dev, lens),
                paged_q8_case("d256_bf16", bf16, 32, 2, gen, dev, lens,
                              d=256)]
    mm = [mm_case(f"{k}->{n} m{m}", m, k, n, bf16, gen, dev,
                  check_timer=(m, k, n) == (8, 4096, 4096))
          for k, n in ((4096, 4096), (4096, 11008), (11008, 4096),
                       (4096, 32000))
          for m in (8, 2512, 4096)]
    mm.append(mm_case("512->1024 m33", 33, 512, 1024, f32, gen, dev))
    # the m tails (1, 16, 17, 129, 4095) and n tails (256, 384: a 128 x 256
    # tile half past n; 11008 = 43 x 256), checked, not timed
    mm_tails = [mm_case(f"{k}->{n} m{m}", m, k, n, bf16, gen, dev,
                        timed=False)
                for m, k, n in ((1, 4096, 4096), (16, 4096, 11008),
                                (17, 4096, 4096), (129, 11008, 4096),
                                (4095, 4096, 4096), (4095, 4096, 11008),
                                (129, 4096, 384), (4095, 4096, 384),
                                (17, 512, 256), (16, 512, 384),
                                (8, 320, 256))]
    grouped = [grouped_case("mha_bf16", bf16, 32, 32, gen, dev,
                            GROUPED_LENS),
               grouped_case("gqa_bf16", bf16, 32, 8, gen, dev, GROUPED_LENS),
               grouped_case("mha_f32", f32, 32, 32, gen, dev, GROUPED_LENS),
               grouped_case("mqa_bf16", bf16, 32, 1, gen, dev, GROUPED_LENS),
               grouped_case("g32_bf16", bf16, 64, 2, gen, dev,
                            GROUPED_LENS)]
    for kind_, rs in (("quant_matmul", qmm + qmm_tails),
                      ("paged_attention_int8", paged_q8),
                      ("matmul", mm + mm_tails),
                      ("paged_attention_grouped", grouped)):
        for r in rs:
            log(f"kernel: {kind_} {r['case']} {r['dtype']}: row rel err "
                f"{r['row_rel_err']:.3g} vs plain (bar {r['tol']:.3g}), max "
                f"abs err {r['max_abs_err']:.3g}; controls (must exceed the "
                f"bar) " + ", ".join(f"{k} {v:.3g}"
                                     for k, v in r["controls"].items()))
    flash = [flash_case("causal_bf16", 32, 4096, 4096, True, bf16, gen, dev,
                        library=True),
             flash_case("full_bf16", 32, 4096, 4096, False, bf16, gen, dev),
             flash_case("rect_bf16", 32, 1024, 4096, True, bf16, gen, dev),
             flash_case("masked_bf16", 32, 256, 128, True, bf16, gen, dev),
             flash_case("causal_f32", 32, 1024, 1024, True, f32, gen, dev)]
    for r in rms:
        log(f"kernel: rms_norm {r['case']} {r['dtype']} ({r['route']}): y "
            f"rows {r['rows']}, rstd rel err {r['rstd_rel']:.3g} vs plain "
            f"(bars: 1 ulp, share {RMS_SHARE}, f32 {TOL[f32]}, rstd "
            f"{RSTD_TOL}); control (must fail a bar) "
            f"{r['controls']['vector_out_of_sum']}")
    for r in rms_bwd:
        log(f"kernel: rms_norm_bwd {r['case']} {r['dtype']} ({r['route']}, "
            f"grid {r['grid']}): dx row err {r['dx_row_err']:.3g} (bar "
            f"{TOL[getattr(torch, r['dtype'])]:.3g}), dw {r['dw']}; control "
            f"(must fail the bar) {r['controls']}")
    for kind_, rs in (("paged_attention", paged),):
        for r in rs:
            log(f"kernel: {kind_} {r['case']} {r['dtype']}: max abs err "
                f"{r['max_abs_err']:.3g} vs plain (tol {r['tol']:.3g})"
                + "".join(f"; control {k} (must exceed the tol) {v:.3g}"
                          for k, v in r.get("controls", {}).items()))
    for r in flash:
        for key in kfa.PASSES:
            log(f"kernel: flash {key} {r['case']} ({r['bh']}x{r['s_q']}x"
                f"{r['s_kv']}, causal {r['causal']}) {r['dtype']}: row rel "
                f"err {r[key]['row_rel_err']:.3g} vs plain (bar "
                f"{r['tol']:.3g}), max abs err {r[key]['max_abs_err']:.3g}"
                + (f", lse err {r['lse_err']:.3g}" if key == "fwd" else
                   " (" + ", ".join(f"{t} {e:.3g}" for t, e in
                                    r[key]["row_rel_errs"].items()) + ")"))
        for fault, readings in r["controls"].items():
            log(f"kernel: flash {r['case']} control '{fault}' (must exceed "
                f"the bar {r['tol']:.3g}): row rel err " + ", ".join(
                    f"{key} {err:.3g}" for key, err in readings.items()))

    # 4. the serving path: LLaMA-2-7B
    serving = serve_7b(args.seed, dev, card)

    # 4b. quantized serving: LLaMA-2-13B, int8 weights, then int4 g128,
    # over an int8 KV cache
    serving13 = serve_13b(args.seed, dev, card, "weight_only_int8", -1)
    serving13_int4 = serve_13b(args.seed, dev, card, "weight_only_int4", 128,
                               lone=False)

    # 3, continued: times at the serving and training shapes
    for kind_, rs in (("rms_norm", rms), ("paged_attention", paged),
                      ("rms_norm_bwd", rms_bwd), ("quant_matmul", qmm),
                      ("paged_attention_int8", paged_q8), ("matmul", mm),
                      ("paged_attention_grouped", grouped)):
        for r in rs:
            if "timings" not in r:  # checked, not timed
                continue
            r.update(r.pop("timings")())
            lib = "n/a" if r["library_ms"] is None \
                else f"{r['library_ms']:.4f}"
            log(f"kernel: {kind_} {r['case']} {r['dtype']}: {r['ms']:.4f} "
                f"ms, plain {r['plain_ms']:.4f} ms, library {lib} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), device time "
                f"({r['timer']}) [{card}]")
            if "tile_ms" in r:
                log(f"kernel: matmul {r['case']} by row tile: " + ", ".join(
                    f"{t} {ms:.4f} ms" for t, ms in r["tile_ms"].items())
                    + f" ({r['weight_copies']} weight copies in turn); the "
                    f"tuner's timer, one weight: kernel "
                    f"{r['graph_ms']['kernel']:.4f} ms, library "
                    f"{r['graph_ms']['library']:.4f} ms [{card}]")
            if "per_page_kernel_ms" in r:
                log(f"kernel: paged_attention_grouped {r['case']}: the "
                    f"per-page kernel on the same inputs "
                    f"{r['per_page_kernel_ms']:.4f} ms [{card}]")
            if "tuner_timer_ms" in r:
                tt = r["tuner_timer_ms"]
                log(f"kernel: matmul {r['case']} tile {tt['tile']}: the "
                    f"tuner's timer (CUDA graph of 20 launches, events) "
                    f"{tt['graph_events']:.4f} ms, the profiler "
                    f"{tt['profiler']:.4f} ms [{card}]")
    for r in flash:
        r.pop("timings")()
        for key in kfa.PASSES:
            t = r[key]
            extra = "" if t["plain_ms"] is None else (
                f", plain {t['plain_ms']:.3f} ms, library "
                f"{t['library_ms']:.4f} ms")
            log(f"kernel: flash {key} {r['case']} {r['dtype']}: "
                f"{t['ms']:.4f} ms{extra}, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), device time ({t['timer']}) [{card}]")
    split_sweep = qmm_split_sweep(gen, dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 5. a tiny model decodes the same on CUDA and CPU, float and quantized
    parity = tiny_parity(args.seed, dev)
    quant_parity = tiny_quant_parity(args.seed, dev)
    mqa_parity = tiny_mqa_parity(args.seed, dev)

    # 6. the training path: 20-layer LLaMA-2-7B widths, batch 1 x 4096
    training = train_7b(args.seed, dev, card)

    # 7. tiny training: CUDA kernels against the CPU's plain versions
    train_parity = tiny_train_parity(args.seed, dev)

    # 8. measured dispatch: serving and training with FLAGS_autotune and
    # FLAGS_paged_grouped_kernel on, then off again
    dispatch = measured_dispatch(args.seed, dev, card, serving)

    # 9. varlen and dropout flash attention: the seg, drop and seg_drop
    # kernels, packed LLaMA-2-7B attention, the fused GPT-3 1.3B encoder
    # with attention dropout, the lse entry, a tiny CUDA-vs-CPU encoder
    variants, timed = flash_variants(args.seed, dev, card)

    def row(name, source, replaces, r, launches):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])

    csrc = "paddle_tpu_torch/kernels/csrc/"
    ref = "paddle_tpu/kernels/"
    served, trained = serving["launches"], training["launches"]
    lse_launches = variants["lse"]["launches"]
    q8, q4 = serving13["launches"], serving13_int4["launches"]
    q8by = q8["quant_matmul_by_kernel"]
    q4by = q4["quant_matmul_by_kernel"]
    # the GEMM's variants in phase 8's counted runs
    by_variant = {}
    for run in (dispatch["serving"], dispatch["serving_pinned"],
                dispatch["training"]["readonly_pinned"]):
        for v, n in run["launches"]["matmul_by_variant"].items():
            by_variant[v] = by_variant.get(v, 0) + n
    check(sum(by_variant.get(v, 0) for v in ("128x256", "128x128")) > 0
          and sum(by_variant.get(v, 0) for v in ("skinny", "m16")) > 0,
          f"phase 8: the GEMM's wgmma or decode kernels did not run: "
          f"{by_variant}")
    check(q8by["prefill"] + q4by["prefill"] > 0
          and q8by["decode"] + q4by["decode"] > 0,
          f"13B: the dequant matmul's prefill or decode kernel did not run: "
          f"{q8by}, {q4by}")

    def case(rs, name):
        return next(r for r in rs if r["case"] == name)

    def variant_row(v, launches):
        r = case(mm, "4096->4096 m8" if v in ("skinny", "m16")
                 else "4096->4096 m4096")
        out = row(f"matmul_{v}", csrc + "matmul.cu", ref + "matmul.py:118",
                  r, launches)
        out["ms"] = r["tile_ms"][v]
        return out
    kernels = [
        # launches: the serving runs' counts plus the training run's
        row("rms_norm", csrc + "rms_norm.cu", ref + "rms_norm.py:71", rms[0],
            served["rms_norm"] + q8["rms_norm"] + q4["rms_norm"]
            + trained["rms_norm"]),
        row("rms_norm_bwd", csrc + "rms_norm.cu", ref + "rms_norm.py:101",
            rms_bwd[0], trained["rms_norm_bwd"]),
        row("paged_attention", csrc + "paged_attention.cu",
            ref + "paged_attention.py:584", paged[0],
            served["paged_attention"]),
        # the plain flash bodies: the training run's and phase 9 (d)'s
        row("flash_fwd", csrc + "flash_attention.cu",
            ref + "flash_attention.py:214", flash[0]["fwd"],
            trained["flash_fwd"] + lse_launches["fwd_plain"]),
        # the one backward kernel, under both sites it replaces: the dK/dV
        # pass and the dQ pass
        row("flash_bwd", csrc + "flash_attention.cu",
            ref + "flash_attention.py:473", flash[0]["bwd"],
            trained["flash_bwd"] + lse_launches["bwd_plain"]),
        row("flash_bwd", csrc + "flash_attention.cu",
            ref + "flash_attention.py:534", flash[0]["bwd"],
            trained["flash_bwd"] + lse_launches["bwd_plain"]),
        # the dequant matmul's two bf16 kernels: m > 16 and m <= 16
        row("quant_matmul_prefill", csrc + "quant_matmul.cu",
            ref + "quant_matmul.py:208",
            case(qmm, "5120->13824 m2512 int8 g-1"),
            q8by["prefill"] + q4by["prefill"]),
        row("quant_matmul_decode", csrc + "quant_matmul.cu",
            ref + "quant_matmul.py:208", case(qmm, "5120->13824 m8 int8 g-1"),
            q8by["decode"] + q4by["decode"]),
        row("paged_attention_int8", csrc + "paged_attention.cu",
            ref + "paged_attention.py:584", paged_q8[0],
            q8["paged_attention_int8"] + q4["paged_attention_int8"]),
        # the GEMM's variants that ran; launches: phase 8's counted runs
        *[variant_row(v, n) for v, n in sorted(by_variant.items()) if n],
        row("paged_attention_grouped", csrc + "paged_attention.cu",
            ref + "paged_attention.py:523", grouped[0],
            dispatch["serving"]["launches"]["paged_attention_grouped"]
            + dispatch["serving_pinned"]["launches"][
                "paged_attention_grouped"]),
    ]
    # the variant bodies; launches: phase 9's counted runs, (b) (both
    # rates) and (c)'s timed steps
    counted = [run["launches"] for run in variants["varlen"]["runs"].values()]
    counted.append(variants["encoder"]["launches"])
    for variant in ("seg", "drop", "seg_drop"):
        for p in kfa.PASSES:
            for line in VARIANT_REPLACES[(p, variant)]:
                kernels.append(row(
                    f"{PASS_KERNEL[p]}_{variant}",
                    csrc + f"flash_attention_{variant}.cu",
                    ref + f"flash_attention.py:{line}", timed[variant][p],
                    sum(c.get(f"{p}_{variant}", 0) for c in counted)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, kind=kind, torch=torch.__version__,
                           build_s=secs, rms_norm=rms, rms_norm_bwd=rms_bwd,
                           paged_attention=paged, flash=flash,
                           quant_matmul=qmm, paged_attention_int8=paged_q8,
                           quant_matmul_split_sweep=split_sweep,
                           serving=serving, serving13_int8=serving13,
                           serving13_int4=serving13_int4, parity=parity,
                           quant_parity=quant_parity,
                           mqa_parity=mqa_parity, training=training,
                           train_parity=train_parity, matmul=mm,
                           paged_attention_grouped=grouped,
                           dispatch=dispatch, flash_variants=variants,
                           kernels=kernels),
                      f, indent=1)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
