#!/usr/bin/env python3
"""Time the plain flash-attention kernels of two checkouts of the port on
one NVIDIA GPU, in turns (A, B, B, A), each run in a process of its own.

    python3 chip_flash_ab.py ROOT_A ROOT_B [--out file.json]

Each root is a checkout holding `paddle_tpu_torch/`; a run builds the
flash kernels from that root's sources (into its own `build/kernels/`) and
times the forward, dK/dV and dQ passes at [32, 4096, 128] bf16 causal, the
training phase's attention, by the device time torch.profiler sees over
20 launches after 3 warm ones. Prints one JSON object per run, then the
card's name and power limit and the mean of each root's two runs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def time_passes(root):
    """One run: device ms of each pass for the port under `root`."""
    sys.path.insert(0, root)
    import torch

    from paddle_tpu_torch.kernels import flash_attention as kfa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bh, s, d = 32, 4096, 128
    scale = d ** -0.5
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = kfa.flash_fwd(q, k, v, scale, True)
    delta = kfa.flash_bwd_delta(out, do)
    passes = {
        "fwd": lambda: kfa.flash_fwd(q, k, v, scale, True),
        "dkv": lambda: kfa.flash_bwd_dkv(q, k, v, do, lse, delta, scale,
                                         True),
        "dq": lambda: kfa.flash_bwd_dq(q, k, v, do, lse, delta, scale,
                                       True)}
    res = {}
    for name, fn in passes.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us <= 0:
            raise RuntimeError(f"the profiler saw no device time for {name}")
        res[name] = us / 1e3 / 20
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--time", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.time is not None:
        print(json.dumps(time_passes(args.time)))
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
    mean = {root: {p: sum(r["ms"][p] for r in runs if r["root"] == root) / 2
                   for p in ("fwd", "dkv", "dq")} for root in (a, b)}
    print(card)
    print(json.dumps(dict(card=card, mean_ms=mean)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, runs=runs, mean_ms=mean), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
