#!/usr/bin/env python3
"""Time the flash-attention and dequant-matmul kernels of two checkouts of
the port on one NVIDIA GPU, in turns (A, B, B, A), each run in a process of
its own.

    python3 chip_flash_ab.py ROOT_A ROOT_B [--out file.json]

Each root is a checkout holding `paddle_tpu_torch/`; a run builds the
kernels from that root's sources (into its own `build/kernels/`) and times,
by CUDA events around 20 back-to-back calls after 3 warm ones (each call
keeps the device busy far longer than the host takes to launch the next):

- flash attention at two shapes: "plain", [32, 4096, 128] bf16 causal (the
  training phase's attention), and "drop", [32, 2048, 128] bf16, not
  causal, dropout 0.1 (the fused encoder's attention at half its batch);
  at each the forward kernel ("fwd"), the root's whole backward
  (`flash_attention._backward`: delta = rowsum(dO * O), then the backward
  kernels, whatever launches they make), and beside them PyTorch's SDPA
  forward and backward on the same inputs (`dropout_p` 0.1 at the drop
  shape), the yardstick, which the port never calls;
- the dequant matmul at LLaMA-2-13B's three projection shapes (5120->5120,
  5120->13824, 13824->5120) at m = 2512 (a 2500-token prefill), bf16 x,
  int8 weights per channel and int4 in groups of 128, beside
  `torch.matmul` on the dequantized bf16 weight (the yardstick).

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


def time_root(root):
    """One run: ms of each timed call for the port under `root`."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import quant_matmul as kqm
    from paddle_tpu_torch.nn.quant import weight_quantize

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    d = 128
    scale = d ** -0.5
    res = {}
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
    algo = {"int8": "weight_only_int8", "int4": "weight_only_int4"}
    for kk, n in QMM_SHAPES:
        w = torch.randn(kk, n, generator=gen, device=dev) * 0.02
        x = torch.randn(QMM_M, kk, generator=gen, device=dev) \
            .to(torch.bfloat16)
        for wd, gs in QMM_CASES:
            qw, sc = weight_quantize(w.to(torch.bfloat16), algo[wd],
                                     group_size=gs)
            w_deq = kqm.dequantize(qw, sc, wd, torch.bfloat16)
            res[f"qmm {kk}->{n} {wd} g{gs}"] = {
                "kernel": events_ms(lambda: kqm.quant_matmul(x, qw, sc, wd,
                                                             gs)),
                "matmul": events_ms(lambda: torch.matmul(x, w_deq))}
            del qw, sc, w_deq
        del w, x
        torch.cuda.empty_cache()
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--time", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.time is not None:
        print(json.dumps(time_root(args.time)))
        return 0
    if len(args.roots) != 2:
        ap.error("give two roots")
    a, b = args.roots
    runs = []
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, __file__, "--time", root],
                             capture_output=True, text=True, check=True,
                             timeout=900)
        ms = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(dict(root=root, ms=ms))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    mean = {root: {case: {t: sum(r["ms"][case][t] for r in runs
                                 if r["root"] == root) / 2
                          for t in timed}
                   for case, timed in runs[0]["ms"].items()}
            for root in (a, b)}
    print(card)
    print(json.dumps(dict(card=card, mean_ms=mean)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, shapes=SHAPES, qmm_m=QMM_M, runs=runs,
                           mean_ms=mean), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
