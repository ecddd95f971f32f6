#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out chip_smoke.json]

Run from the repository root; it builds its CUDA kernels itself. Phases:

1. device: the card's name, count, and `nvidia-smi` name and power limit;
2. build: every kernel under paddle_tpu_torch/kernels/csrc with nvcc;
3. each kernel against its plain PyTorch version at the serving shapes;
   after phase 4, its device time, the plain version's, a library call's,
   and its bound;
4. LLaMA-2-7B (32 layers, hidden 4096, bf16, random weights from --seed)
   served by the paged-KV ServingEngine: one 2500-token request decoding
   past a 2048-token context, then 10 requests of 5-1000 tokens, greedy
   and sampled, through 8 slots; the kernels' launch counts are reset just
   before and checked just after; then a profiled warm 2500-token prefill
   and a profiled window of batch-8 decode steps give the device's busy
   time and idle share;
5. a tiny f32 LLaMA gives the same greedy streams on CUDA and on the CPU.

Any failure raises and exits non-zero. The second-to-last line is the JSON
list of kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as TF

from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as kpa
from paddle_tpu_torch.kernels import rms_norm as krms
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_llama_state

# H100 SXM data-sheet peaks (dense): HBM bytes/s, f32 FLOP/s off the tensor
# cores (both kernels do their arithmetic in f32 on the CUDA cores)
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
# bf16: one output rounding (2^-7 relative); f32: summation order
TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def log(*parts):
    print(*parts, flush=True)


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


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype] * max(1.0, want.float().abs().max().item())
    return err, tol


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def rms_case(name, rows, cols, dtype, gen, dev):
    x = (torch.randn(rows, cols, generator=gen, device=dev) * 2).to(dtype)
    w = torch.randn(cols, generator=gen, device=dev).to(dtype)
    got = krms.rms_norm(x, w, 1e-6)
    torch.cuda.synchronize()
    err, tol = max_err(got, krms.rms_norm_ref(x, w, 1e-6), dtype)
    check(err <= tol, f"rms_norm {name}: max abs err {err} > tol {tol}")
    it = 500 if rows <= 64 else 100
    lib = getattr(TF, "rms_norm", None)
    elt = x.element_size()
    b_ms, b_by = bound((2 * rows * cols + cols) * elt, 4 * rows * cols)

    def timings():
        ms, timer = time_ms(lambda: krms.rms_norm(x, w, 1e-6), it)
        return dict(
            ms=ms, timer=timer,
            plain_ms=time_ms(lambda: krms.rms_norm_ref(x, w, 1e-6),
                             it // 5)[0],
            library_ms=None if lib is None else time_ms(
                lambda: lib(x, (cols,), w, 1e-6), it // 5)[0])

    return dict(case=name, shape=[rows, cols],
                dtype=str(dtype).split(".")[-1], max_abs_err=err, tol=tol,
                bound_ms=b_ms, bound_by=b_by, timings=timings)


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
    err, tol = max_err(got, kpa.paged_attention_ref(*args), dtype)
    check(err <= tol, f"paged_attention {name}: max abs err {err} > {tol}")
    check(not got[lens.index(0)].any() if 0 in lens else True,
          f"paged_attention {name}: a ctx 0 row is not zero")
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
        max_abs_err=err, tol=tol, bound_ms=b_ms, bound_by=b_by,
        timings=timings)


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
    return dict(requests=len(want), ttft_ms=ttft,
                decode_steps=len(step_ms),
                ms_per_decode_step_p50=float(np.median(step_ms))
                if step_ms else None,
                decode_tokens_per_s=dec_tok / dec_s if dec_s else None)


def profile_decode(eng, rng, card, steps=8):
    """Profile `steps` pure decode steps at batch 8 (contexts ~1000): wall
    ms per step, device busy ms per step (the sum of kernel intervals on
    the one stream), the device's idle share, and device time by kernel."""
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
    res = dict(prompt=n, wall_ms=wall * 1e3, device_busy_ms=busy / 1e3,
               top_kernels_ms=[(k[:90], us / 1e3) for k, us in top])
    log(f"profile: warm prefill of a {n}-token prompt: {res['wall_ms']:.1f} "
        f"ms wall, {res['device_busy_ms']:.1f} ms device busy [{card}]")
    for name, ms in res["top_kernels_ms"]:
        log(f"profile:   {ms:8.3f} ms  {name}")
    return res


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
    long_req = [(rng.randint(0, cfg.vocab_size, 2500), 64, {})]
    batch = []
    for i in range(10):
        n = int(rng.randint(5, 1001))
        kw = {} if i % 2 == 0 else dict(decode_strategy="sampling",
                                        temperature=0.8, top_k=50,
                                        top_p=0.95)
        batch.append((rng.randint(0, cfg.vocab_size, n),
                      int(rng.randint(16, 65)), kw))
    # the main path: counts from zero, read right after
    krms.launches = 0
    kpa.launches = 0
    t0 = time.perf_counter()
    lone = drive(eng, long_req)
    mixed = drive(eng, batch)
    wall = time.perf_counter() - t0
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
    log(f"serve: {eng.prefills} prefills, {eng.decode_steps} decode steps, "
        f"{eng.preemptions} preemptions, launches {launches}, peak "
        f"{res['max_memory_allocated_gb']:.2f} GiB allocated, "
        f"{wall:.1f} s [{card}]")
    res["prefill_profile"] = profile_prefill(eng, rng, card)
    res["decode_profile"] = profile_decode(eng, rng, card)
    del eng, model
    torch.cuda.empty_cache()
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
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    # 3. kernels against their plain versions at the serving shapes (the
    # timings wait until after the serving run, so that no profiler session
    # precedes the serving measurements)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    lens = [0, 1, 15, 16, 17, 1000, 2049, 4096]
    rms = [rms_case("decode", 8, 4096, torch.bfloat16, gen, dev),
           rms_case("prefill", 4096, 4096, torch.bfloat16, gen, dev)]
    paged = [paged_case("mha_bf16", torch.bfloat16, 32, 32, gen, dev, lens),
             paged_case("gqa_bf16", torch.bfloat16, 32, 8, gen, dev, lens),
             paged_case("mha_f32", torch.float32, 32, 32, gen, dev, lens)]
    for r in rms + paged:
        log(f"kernel: {'rms_norm' if r in rms else 'paged_attention'} "
            f"{r['case']} {r['dtype']}: max abs err {r['max_abs_err']:.3g} "
            f"vs plain (tol {r['tol']:.3g})")

    # 4. the main path: LLaMA-2-7B serving
    serving = serve_7b(args.seed, dev, card)

    # 3, continued: times at the serving shapes
    for r in rms + paged:
        r.update(r.pop("timings")())
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernel: {'rms_norm' if r in rms else 'paged_attention'} "
            f"{r['case']} {r['dtype']}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), device time "
            f"({r['timer']}) [{card}]")

    # 5. a tiny model decodes the same on CUDA and CPU
    parity = tiny_parity(args.seed, dev)

    def row(name, source, replaces, r):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces,
                    launches=serving["launches"][name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])

    kernels = [
        row("rms_norm", "paddle_tpu_torch/kernels/csrc/rms_norm.cu",
            "paddle_tpu/kernels/rms_norm.py:71", rms[0]),
        row("paged_attention",
            "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            "paddle_tpu/kernels/paged_attention.py:584", paged[0]),
    ]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, kind=kind, torch=torch.__version__,
                           build_s=secs, rms_norm=rms, paged_attention=paged,
                           serving=serving, parity=parity, kernels=kernels),
                      f, indent=1)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
