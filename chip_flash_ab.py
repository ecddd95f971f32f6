#!/usr/bin/env python3
"""Time the flash-attention kernels of two checkouts of the port on one
NVIDIA GPU, in turns (A, B, B, A), each run in a process of its own.

    python3 chip_flash_ab.py ROOT_A ROOT_B [--out file.json]

Each root is a checkout holding `paddle_tpu_torch/`; a run builds the
flash kernels from that root's sources (into its own `build/kernels/`) and
times, by the device time torch.profiler sees over 20 calls after 3 warm
ones (CUDA events where it sees none):

- "plain": [32, 4096, 128] bf16 causal, the training phase's attention;
- "drop": [32, 2048, 128] bf16, not causal, dropout 0.1 (the fused
  encoder's attention at half its batch);

at each shape the forward kernel and the root's whole backward
(`flash_attention._backward`: delta = rowsum(dO * O), then the backward
kernels, whatever launches they make), and beside them PyTorch's SDPA
backward on the same inputs (`torch.autograd.grad` of
`scaled_dot_product_attention`, with `dropout_p` 0.1 at the drop shape),
the yardstick, which the port never calls. Prints one JSON object per run,
then the card's name and power limit and the mean of each root's two runs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

SHAPES = {"plain": dict(bh=32, s=4096, causal=True, rate=0.0),
          "drop": dict(bh=32, s=2048, causal=False, rate=0.1)}
TIMED = ("fwd", "bwd", "sdpa_bwd")


def device_ms(fn, iters=20):
    """Device ms per call of `fn`: the kernel intervals torch.profiler saw,
    or CUDA events around the calls where it saw none."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us > 0:
        return us / 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_root(root):
    """One run: device ms of the forward, the backward and SDPA's backward
    at each shape, for the port under `root`."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import flash_attention as kfa

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
        q4, k4, v4 = (t.view(1, bh, s, d).requires_grad_()
                      for t in (q, k, v))
        o4 = TF.scaled_dot_product_attention(q4, k4, v4, dropout_p=rate,
                                             is_causal=causal)
        do4 = do.view(1, bh, s, d)
        res[name] = {
            "fwd": device_ms(lambda: kfa.flash_fwd(q, k, v, scale, causal,
                                                   var)),
            "bwd": device_ms(lambda: kfa._backward(q, k, v, out, lse, do,
                                                   scale, causal, var)),
            "sdpa_bwd": device_ms(lambda: torch.autograd.grad(
                o4, (q4, k4, v4), do4, retain_graph=True))}
        del q, k, v, do, out, lse, q4, k4, v4, o4, do4
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
    mean = {root: {shape: {t: sum(r["ms"][shape][t] for r in runs
                                  if r["root"] == root) / 2
                           for t in TIMED}
                   for shape in SHAPES}
            for root in (a, b)}
    print(card)
    print(json.dumps(dict(card=card, mean_ms=mean)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, shapes=SHAPES, runs=runs,
                           mean_ms=mean), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
