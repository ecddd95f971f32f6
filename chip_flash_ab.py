#!/usr/bin/env python3
"""Time the kernels of two checkouts of the port on one NVIDIA GPU, in turns
(A, B, B, A), each run in a process of its own.

    python3 chip_flash_ab.py ROOT_A ROOT_B [--parts gemm,decode] [--out f.json]

Each root is a checkout holding `paddle_tpu_torch/`; a run builds the
kernels from that root's sources (into its own `build/kernels/`) and times
the parts named by `--parts` (all by default):

- "flash": flash attention at two shapes, "plain", [32, 4096, 128] bf16
  causal (the training phase's attention), and "drop", [32, 2048, 128]
  bf16, not causal, dropout 0.1 (the fused encoder's attention at half its
  batch); at each the forward kernel ("fwd"), the root's whole backward
  (`flash_attention._backward`: delta = rowsum(dO * O), then the backward
  kernels, whatever launches they make), and beside them PyTorch's SDPA
  forward and backward on the same inputs (`dropout_p` 0.1 at the drop
  shape), the yardstick, which the port never calls;
- "prefill": the dequant matmul at LLaMA-2-13B's three projection shapes
  (5120->5120, 5120->13824, 13824->5120) at m = 2512 (a 2500-token
  prefill), bf16 x, int8 weights per channel and int4 in groups of 128,
  beside `torch.matmul` on the dequantized bf16 weight (the yardstick);
- "gemm": the dense bf16 matmul (`matmul.matmul_fused`, the root's default
  kernel, and where the root names its variants, `matmul.variants`, each
  of them) at LLaMA-2-7B's linears (4096->4096, 4096->11008, 11008->4096,
  4096->32000) at m = 8 (a decode step) and m = 4096 (a training
  sequence), beside `torch.matmul` (cuBLAS);
- "decode": the dequant matmul at the three 13B shapes at m = 8, int8 per
  channel and int4 in groups of 128, beside `torch.matmul` on the
  dequantized bf16 weight;
- "rms": RMSNorm, bf16, at LLaMA-2-7B's and 13B's widths, [8, 4096] and
  [8, 5120] (a decode step) and [4096, 4096] and [2512, 5120] (a training
  sequence, a 2500-token prefill): the forward kernel without rstd (as
  serving calls it) and the backward kernel (from the forward's rstd),
  beside PyTorch's `F.rms_norm` and its autograd backward (dx and dw), the
  yardstick. Every call of the kernels and the library's forward is timed
  as a CUDA graph of 20 calls taking their inputs in turn from copies
  worth 128 MB; the library's backward, which does not capture in a
  graph, by its kernels' device time under torch.profiler, beside the
  backward kernel's own ("bwd_kernel_time").

In "gemm" and "decode" each call finds its weight out of the 50 MB L2, as
on the serving path: the calls take turns over copies of the weight worth
at least 128 MB. Calls of 0.1 ms and more are timed by CUDA events around
back-to-back calls after warm ones (each keeps the device busy longer than
the host takes to launch the next); the m = 8 calls, shorter than their
host launch, are captured 20 at a time in a CUDA graph whose replays are
timed by events (the median of 5, over 20).

Prints one JSON object per run, then the card's name and power limit and
the mean of each root's two runs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

SHAPES = {"plain": dict(bh=32, s=4096, causal=True, rate=0.0),
          "drop": dict(bh=32, s=2048, causal=False, rate=0.1)}
QMM_M = 2512
QMM_SHAPES = ((5120, 5120), (5120, 13824), (13824, 5120))
QMM_CASES = (("int8", -1), ("int4", 128))
GEMM_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
GEMM_M = (8, 4096)
DECODE_M = 8
RMS_SHAPES = ((8, 4096), (8, 5120), (4096, 4096), (2512, 5120))
PARTS = ("flash", "prefill", "gemm", "decode", "rms")
ALGO = {"int8": "weight_only_int8", "int4": "weight_only_int4"}


def events_ms(fn, iters=20):
    """Device ms per call of `fn` by CUDA events around `iters` calls."""
    import torch

    for _ in range(3):
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


def graph_ms(fn, iters=20, reps=5):
    """Device ms per call of `fn` (which takes its next weight copy itself):
    `iters` calls captured in one CUDA graph, its replays timed by events,
    the median of `reps` replays over `iters`."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(times)[reps // 2]


def profiler_ms(fn, iters=20):
    """Device ms per call of `fn`: the sum of the kernel intervals that
    torch.profiler sees over `iters` calls (gaps between kernels left
    out)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kind = torch.autograd.DeviceType.CUDA
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == kind)
    return us / 1e3 / iters


def turns(make, nbytes):
    """A function returning, call after call, the next of copies of
    `make()` worth at least 128 MB together (each call finds its copy out
    of the 50 MB L2)."""
    copies = [make() for _ in range(max(1, -(-2 ** 27 // nbytes)))]
    state = [0]

    def nxt():
        state[0] = (state[0] + 1) % len(copies)
        return copies[state[0]]

    return nxt


def time_flash(res, dev, gen):
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import flash_attention as kfa

    d = 128
    scale = d ** -0.5
    for name, sh in SHAPES.items():
        bh, s, causal, rate = sh["bh"], sh["s"], sh["causal"], sh["rate"]
        q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        var = kfa.Variant(heads=1, rate=rate, seed=1234) if rate else None
        out, lse = kfa.flash_fwd(q, k, v, scale, causal, var)
        q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
        qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
        o4 = TF.scaled_dot_product_attention(qg, kg, vg, dropout_p=rate,
                                             is_causal=causal)
        do4 = do.view(1, bh, s, d)
        res[name] = {
            "fwd": events_ms(lambda: kfa.flash_fwd(q, k, v, scale, causal,
                                                   var)),
            "bwd": events_ms(lambda: kfa._backward(q, k, v, out, lse, do,
                                                   scale, causal, var)),
            "sdpa_fwd": events_ms(lambda: TF.scaled_dot_product_attention(
                q4, k4, v4, dropout_p=rate, is_causal=causal)),
            "sdpa_bwd": events_ms(lambda: torch.autograd.grad(
                o4, (qg, kg, vg), do4, retain_graph=True))}
        del q, k, v, do, out, lse, q4, k4, v4, qg, kg, vg, o4, do4
        torch.cuda.empty_cache()


def time_prefill(res, dev, gen):
    import torch

    from paddle_tpu_torch.kernels import quant_matmul as kqm
    from paddle_tpu_torch.nn.quant import weight_quantize

    for kk, n in QMM_SHAPES:
        w = torch.randn(kk, n, generator=gen, device=dev) * 0.02
        x = torch.randn(QMM_M, kk, generator=gen, device=dev) \
            .to(torch.bfloat16)
        for wd, gs in QMM_CASES:
            qw, sc = weight_quantize(w.to(torch.bfloat16), ALGO[wd],
                                     group_size=gs)
            w_deq = kqm.dequantize(qw, sc, wd, torch.bfloat16)
            res[f"qmm {kk}->{n} {wd} g{gs}"] = {
                "kernel": events_ms(lambda: kqm.quant_matmul(x, qw, sc, wd,
                                                             gs)),
                "matmul": events_ms(lambda: torch.matmul(x, w_deq))}
            del qw, sc, w_deq
        del w, x
        torch.cuda.empty_cache()


def time_gemm(res, dev, gen):
    import torch

    from paddle_tpu_torch.kernels import matmul as kmm

    for m in GEMM_M:
        for kk, n in GEMM_SHAPES:
            x = torch.randn(m, kk, generator=gen, device=dev) \
                .to(torch.bfloat16)
            base = (torch.randn(kk, n, generator=gen, device=dev)
                    * kk ** -0.5).to(torch.bfloat16)
            w = turns(base.clone, kk * n * 2)
            del base
            timer = graph_ms if m <= 16 else (lambda f: events_ms(f, 10))
            row = {"kernel": timer(lambda: kmm.matmul_fused(x, w())),
                   "torch": timer(lambda: torch.matmul(x, w()))}
            if hasattr(kmm, "variants"):
                for v in kmm.variants(torch.bfloat16, m):
                    row[v] = timer(lambda: kmm.matmul_fused(x, w(), v))
            res[f"gemm {kk}->{n} m{m}"] = row
            del x, w
            torch.cuda.empty_cache()


def time_decode(res, dev, gen):
    import torch

    from paddle_tpu_torch.kernels import quant_matmul as kqm
    from paddle_tpu_torch.nn.quant import weight_quantize

    for kk, n in QMM_SHAPES:
        w = (torch.randn(kk, n, generator=gen, device=dev) * 0.02) \
            .to(torch.bfloat16)
        x = torch.randn(DECODE_M, kk, generator=gen, device=dev) \
            .to(torch.bfloat16)
        for wd, gs in QMM_CASES:
            q = turns(lambda: weight_quantize(w, ALGO[wd], group_size=gs),
                      kk * n // (2 if wd == "int4" else 1))
            deq = turns(lambda: kqm.dequantize(*q(), wd, torch.bfloat16),
                        kk * n * 2)
            res[f"decode {kk}->{n} {wd} g{gs}"] = {
                "kernel": graph_ms(lambda: kqm.quant_matmul(x, *q(), wd,
                                                            gs)),
                "matmul": graph_ms(lambda: torch.matmul(x, deq()))}
            del q, deq
            torch.cuda.empty_cache()
        del w, x
        torch.cuda.empty_cache()


def time_rms(res, dev, gen):
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import rms_norm as krms

    eps = 1e-6
    for rows, cols in RMS_SHAPES:
        # copies of x and g worth 128 MB, taken in turn: each call finds
        # its inputs out of L2 (at [4096, 4096] two copies, a third of
        # them in L2)
        nbytes = rows * cols * 2
        x, g = (turns(lambda: torch.randn(rows, cols, generator=gen,
                                          device=dev).to(torch.bfloat16),
                      nbytes) for _ in range(2))
        w = torch.randn(cols, generator=gen, device=dev).to(torch.bfloat16)
        x0, g0 = x(), g()
        _, rstd = krms.rms_norm(x0, w, eps, with_rstd=True)
        xl = x0.detach().requires_grad_()
        wl = w.detach().requires_grad_()
        yl = TF.rms_norm(xl, (cols,), wl, eps)
        # the library's autograd backward does not capture in a CUDA
        # graph: both backwards also by their kernels' device time under
        # torch.profiler
        row = {"fwd": graph_ms(lambda: krms.rms_norm(x(), w, eps)),
               "library_fwd": graph_ms(
                   lambda: TF.rms_norm(x(), (cols,), w, eps)),
               "bwd": graph_ms(lambda: krms.rms_norm_bwd(x(), w, rstd,
                                                         g())),
               "bwd_kernel_time": profiler_ms(lambda: krms.rms_norm_bwd(
                   x(), w, rstd, g())),
               "library_bwd": profiler_ms(lambda: torch.autograd.grad(
                   yl, (xl, wl), g(), retain_graph=True))}
        res[f"rms {rows}x{cols}"] = row
        del x, g, x0, g0, xl, wl, yl, rstd
        torch.cuda.empty_cache()


def time_root(root, parts):
    """One run: ms of each timed call for the port under `root`."""
    sys.path.insert(0, root)
    import torch

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    steps = {"flash": time_flash, "prefill": time_prefill,
             "gemm": time_gemm, "decode": time_decode, "rms": time_rms}
    for part in parts:
        # each part from its own seed: the same inputs whatever else runs
        steps[part](res, dev, torch.Generator(device=dev).manual_seed(
            PARTS.index(part)))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--time", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    parts = [p for p in args.parts.split(",") if p]
    if any(p not in PARTS for p in parts):
        ap.error(f"--parts takes {', '.join(PARTS)}")
    if args.time is not None:
        print(json.dumps(time_root(args.time, parts)))
        return 0
    if len(args.roots) != 2:
        ap.error("give two roots")
    a, b = args.roots
    runs = []
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, __file__, "--time", root,
                              "--parts", ",".join(parts)],
                             capture_output=True, text=True, timeout=1200)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            raise RuntimeError(f"the run of {root} failed (exit "
                               f"{out.returncode})")
        ms = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(dict(root=root, ms=ms))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    mean = {}
    for root in (a, b):
        mine = [r["ms"] for r in runs if r["root"] == root]
        mean[root] = {case: {t: sum(r[case][t] for r in mine) / len(mine)
                             for t in timed}
                      for case, timed in mine[0].items()}
    print(card)
    print(json.dumps(dict(card=card, mean_ms=mean)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, parts=parts, shapes=SHAPES,
                           qmm_m=QMM_M, runs=runs, mean_ms=mean), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
