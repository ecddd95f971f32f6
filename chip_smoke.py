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
   head_dim 256, each called twice (bitwise equal) and held beside faults
   (two chunks of a group's queries swapped, one split's partial left out
   of the in-launch combine), and untimed at contexts on the split edges
   of each plan, one 4096-token row among rows of 0 and 1, batch 1 x 4096
   and 5-token pages; each new case held row by row and beside faults made
   from the plain version); after phase 4b, its device time, the plain version's, a
   library call's, and its bound;
4. LLaMA-2-7B (32 layers, hidden 4096, bf16, random weights from --seed)
   served by the paged-KV ServingEngine: one 2500-token request decoding
   past a 2048-token context, then 10 requests of 5-1000 tokens, greedy
   and sampled, through 8 slots; the kernels' launch counts are reset just
   before and checked just after; then a profiled warm 2500-token prefill
   and a profiled window of batch-8 decode steps give the device's busy
   time and idle share;
4b. LLaMA-2-13B's widths at 5 of its 40 layers (hidden 5120; the
   script's time limit, `SERVE13_LAYERS`; phases 12-13 build it at 20),
   bf16, random weights from --seed, PyTorch's default initialisation):
   the last-position logits of a 64-token prompt in f32, in bf16, and
   after weight-only int8 quantization (lm_head kept in bf16): int8 and
   bf16 agree within 0.05 of the largest, the bf16-f32 distance is read
   beside it; then served with an int8 paged KV cache, the same traffic as
   phase 4, the launch counts reset just before and checked just after
   (dequant matmul 7L and RMSNorm 2L + 1 per forward, int8 paged decode L
   per decode step, the float paged kernel none), a profiled
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
   forward and backward 20 each, RMSNorm forward and backward 41 each, the
   Adam kernel 183, once per parameter tensor); then one profiled step
   gives the device's busy time, idle share and top kernels;
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
   weights and seed;
10. the rest of the training step: (a) the Adam / AdamW update kernel
   against its plain version at LLaMA-2-7B's parameter shapes ([4096,
   4096], [11008, 4096], [4096, 11008], [32000, 4096], [4096]) and a
   4097-element tail, in bf16, bf16 with an f32 master weight and f32, as
   Adam with L2 decay and as AdamW, at steps 1 and 1000 (moments within 2
   f32 ulps of their summed terms, p and the master weight within one
   rounding), beside three faults made from the plain version (the bias
   corrections from the previous step's powers, the decay after the step,
   the tail left out), each of which must fail the same bars where it can
   show; the [11008, 4096] bf16 AdamW case timed beside the plain version
   and `torch.optim.AdamW(fused=True)`; (b) phase 6's model made again
   (LLaMA-2-7B widths, 20 layers, bf16 O2) through the new surface:
   recompute, the chunked LM-head loss over 8 chunks, LinearWarmup over
   CosineAnnealingDecay stepped each call, AdamW without decay on the norm
   weights, gradient merge over 2 calls, batches from a DataLoader over a
   TensorDataset of two seeded sequences through prefetch_batches: 2 warm
   calls, then 4 counted from zero (per call flash forward 40, backward
   20, RMSNorm forward 81, backward 41; Adam 183 on each applying call),
   losses finite and falling, the peak memory beside phase 6's, and the
   optimizer's device ms from one profiled applying call; (c) 4 layers of
   those widths in f32 trained eagerly under auto_cast O1 (bf16) with a
   GradScaler (2^15) and AdamW clipped by global norm 1.0: an inf planted
   in one gradient skips that step (every parameter and moment bitwise
   unchanged) and halves the scale; (d) a tiny f32 LLaMA (head_dim 128)
   through (b)'s options on CUDA and on the CPU from the same weights;
11. multi-step serving decode, each cell and mode in a process of its own
   (`--phase11 CELL`, started by this script): phase 4's model cut to
   `BURST7_LAYERS` (8) of its 32 layers (the script's time) and phase 4's
   traffic on an engine with decode_burst=8 (each (greedy or mixed, 1 or 8
   steps) program a captured CUDA graph, all four captured by `warmup`),
   synchronous and then with async_depth=2: every greedy stream equal to
   its eager engine's, sampled streams in the vocabulary and of their
   length, no capture during traffic, no token emitted past a finish, the
   launches inside the graphs counted from the profiler's device records
   (paged decode L a step, RMSNorm 2L + 1 a forward) over the 10 requests
   and over a profiled window of 3 bursts at batch 8 (context ~1000: wall,
   device busy and operations per token step, idle share, beside phase
   4's); the eos check and two planted faults that must each break the
   check guarding them (a replay without the block-table copy; a burst
   body that ignores eos); then phase 4b's 13B engine (int8 weights, int8
   KV) the same way, held to its own eager engine's streams, the dequant
   matmul's decode kernel counted inside the graphs (7L a step);
12. the prefix cache and chunked prefill, each cell in a process of its
   own (`--phase12 CELL`): (a) LLaMA-2-7B's widths at `CELL7_LAYERS` (16)
   of its 32 layers (the script's time) on phase 11's engine
   (decode_burst 8, graphs captured by warmup) with `prefix_cache=1,
   prefill_chunk=512`, with `prefix_cache=1` alone and with both off, each
   serving the same greedy traffic: 12 requests that share a 1024-token
   system prompt (the first alone, to fill the trie, then the other 11
   together), each with its own 16-600-token tail and 32-64 new tokens,
   then a lone 2500-token request; after every finished request the page
   invariant (exact refcounts against the rows and the trie) and every
   trie page's checksum since its insert; every greedy stream equal to
   the off engine's, or differing first at a near tie (the off engine's
   top-2 gap within the chunked-vs-dense first-token logit distance times
   its largest |logit|); prefix hit and miss tokens, chunk rounds, TTFT
   p50 with and without a hit, tokens/s, peak memory, launches (the
   wrappers' counts plus the captured programs' replays times the kernels
   a profiled replay holds); a fresh 2500-token prefill alone, chunked
   (each round profiled) against dense; three planted faults, each caught
   by the holds (a chunk round that ignores `limit_lens`, a match that
   shares the partial tail page, a release that skips a decref); (b) phase
   4b's LLaMA-2-13B (int8 weights, int8 KV) on the traffic's first 4
   requests, chunked engine against the off engine, under the same holds;
13. speculative decoding, each cell in a process of its own (`--phase13
   CELL`): (a) LLaMA-2-7B's widths at `CELL7_LAYERS` (16) of its 32 layers
   on phase 11's engine (decode_burst 8) over phase 4's 10 requests made
   greedy, off (the burst graphs alone) and with spec_decode=4: shallow
   exit at the default half depth, at the full depth (the target's own
   decode: acceptance at least 0.9), a 2-layer
   draft model at the same widths (weights from --seed + 1), and (in a
   process of its own, `7b_target_draft`, beside its own off engine) the
   target as its own draft model (acceptance at least 0.9), each
   round's draft and verify captured CUDA graphs built by `warmup` and
   the verify's attention on the paged decode kernel; every greedy stream
   equal to the off engine's or differing first at a near tie (the off
   engine's top-2 gap within the verify-vs-decode logit distance of a
   first window times its largest |logit|), no capture during traffic, no
   gathered window, no token past a finish; proposed and accepted drafts,
   rounds, tokens/s, peak memory, the launches inside the graphs from the
   profiler's device records (exact: per round n draft steps of the draft
   depth and one verify of 32 layers); a profiled window of 3 rounds at
   batch 8, context ~1000 (per round the draft's and the verify's device
   ms, the round's wall ms, the idle share; device and wall ms per
   committed token, beside the off engine's burst window); then the
   shallow engine with the prefix cache and chunks of 512 over phase 12's
   first 4 shared-prompt requests, the page holds after each, against the
   off engine; four planted faults, each caught (a commit that also
   accepts the draft at the first mismatch; a verify whose window
   positions all attend up to lens + window; on the target as its own
   draft model, a prefill that skips the draft's pools and a draft scan
   one step short); (b) phase 4b's LLaMA-2-13B
   (int8 weights, int8 KV), shallow, on the first 4 requests against its
   off engine, the dequant matmul's kernels counted inside the graphs;
14. the GPT family, each cell in a process of its own (`--phase14 CELL`):
   (a) `serve`: GPT-3 1.3B (24 layers, hidden 2048, 16 heads of 128,
   vocab 50304, tied head; bf16, random weights from --seed) through the
   paged engine at max_batch 8, max_seq_len 2048, page 16: a lone
   1500-token prompt (64 new), then phase 4's 10 requests, on the eager
   engine and on a burst engine (decode_burst 8, graphs captured by
   `warmup`), 24 paged decodes a token step inside the graphs counted from
   the profiler, every greedy stream equal to the eager engine's or
   differing first at a near tie (the verify-vs-decode bar); a profiled
   window of 3 bursts at batch 8, context ~1000; a planted fault
   (`forward_paged` positions that ignore `context_lens`) caught by the
   stream hold; a shallow-exit spec engine (spec_decode 4, 12 of 24
   layers) over the 10 requests made greedy against the off engine, its
   acceptance recorded; (b) `train`: GPT-3 1.3B, 24 layers, bf16 O2,
   AdamW(1e-4), batch 4 x 2048 through build_train_step: a warm step, 5
   timed steps with exact launches a step (flash forward and backward 24
   each, Adam 292, RMSNorm none), losses finite and falling, tokens/s,
   step ms p50, peak memory, the model-FLOPs share by GPT's own count, a
   profiled step; in one process `fmt_tiny` (each part takes less time
   than a process takes to start): (c) FusedMultiTransformer at GPT-3
   1.3B widths
   (bf16): a 2 x 1024 context forward with exactly 24 flash launches, then
   16 decode steps at `time_step` over bf16 caches, each held row by row
   against the context forward (1e-2), beside a planted fault (the K/V
   written one slot late) that must fail the bar; (d) a tiny f32
   GPT at head_dim 128 on CUDA and on the CPU from the same weights: burst
   and shallow spec streams and `generate` equal, 3 AdamW steps' losses
   and updates agree;
15. the data-parallel fine-tune, each part in processes of its own started
   by `distributed.spawn`: (a) LLaMA-2-7B widths at `FT_LAYERS` (2)
   layers, bf16 O2, AdamW(1e-4), batch 1 x 4096 of one seeded sequence,
   at world 1 over
   NCCL (`init_parallel_env`, `init_mesh(dp=1)`, `DataParallel`, a
   `DataLoader` of 2 worker processes over a `DistributedBatchSampler`):
   NCCL's all_reduce, broadcast and all_gather return their inputs; 4
   steps with the kernels' launches exact, the model's and the optimizer's
   state_dict saved by `paddle_tpu_torch.save` after step 2; a new process
   loads them (digests of the bits equal to the saved state's), resumes
   steps 3-4 (loss 3 within 1e-6, loss 4 within `FT_LOSS4_TOL` of the
   uninterrupted run's, the probe parameters within `FT_PARAM_BAR` of the update since
   step 2) and, as the planted fault, resumes without the optimizer's
   state, which the probe parameters must catch; save and load seconds,
   step ms and tokens/s; (b) two ranks on the one card over gloo (named by
   PADDLE_DISTRI_BACKEND) with CUDA tensors, a 2-layer f32 LLaMA at hidden
   512: after `sync_gradients` each rank's gradients within 1e-5 of one
   process's on the global batch, one all_reduce a bucket, bucketed equal
   to per-parameter bit for bit, a bucket slice one element off caught;
   (c) in (a)'s second process, the tensor checker names the op of a NaN
   planted in a layer's output, and `check_numerics` passes clean logits.
   `--phase15` runs the build and this phase alone;
16. tensor parallelism through fleet: `fleet.init` (mp_degree),
   `distributed_model` (TensorParallel), `distributed_optimizer`
   (HybridParallelOptimizer) and `build_train_step`, every rank on the one
   card over gloo (named by PADDLE_DISTRI_BACKEND; NCCL refuses two ranks a
   card), each cell held against this process training the same full
   model at tp 1 from the same seeded weights (drawn on the card per
   tensor, then sliced to each rank's shard): (a) GPT-3 1.3B (24 layers,
   hidden 2048, 16 heads of 128, vocab 50304; BASELINE.json config 3) at
   TP 4, bf16 O2, AdamW(1e-4, f32 masters) under ClipGradByGlobalNorm(1.0),
   batch 1 x 2048, 3 steps through the chunked vocab-parallel loss; (b)
   LLaMA-2-7B widths at 2 layers at TP 2, batch 1 x 4096, 2 steps, the
   dense head into ParallelCrossEntropy, with sequence parallelism where
   gloo carries all_gather and reduce_scatter on CUDA tensors (probed
   first). Held: every rank's losses bit for bit equal, each step's loss
   within `TP_LOSS_TOL` of tp 1's, the probe parameters' gradients at the
   initial weights within `TP_GRAD_BAR` of their norm and their f32
   masters after the last step within `TP_PARAM_BAR` of their update
   (replicated ones equal on every rank), the global norm the clip scales
   by within 1e-3, the flash, RMSNorm and Adam launches a rank exact; in
   (a) three planted faults caught (a `_c_identity` without its backward
   all_reduce in layer 0 and a vocab-parallel cross entropy at the wrong
   rank offset, each held by its loss and gradients; the program's
   `HybridParallelClipGrad` taking every parameter for a shard, which
   counts the replicated gradients 4 times); step ms, all_reduces and
   bytes a step (four ranks on one card: no tensor-parallel speed).
   `--phase16` runs the build and this phase alone;
17. tensor-parallel serving: two ranks on the one card over gloo, each
   running `fleet.init` (mp_degree 2), building its model under the mesh
   (its shards; weights drawn per tensor on the card, `tp_load`) and
   serving through its own `ServingEngine` (the global mesh; no CUDA graph
   at tp > 1), against this process serving the same full model at tp 1:
   (a) LLaMA-2-7B's widths at `CELL7_LAYERS` (16) of its 32 layers, bf16,
   max_batch 8, 4096 positions, page 16, 8 requests of 5-1000 tokens with
   32 new each, greedy and sampled alternating, on the eager engine and at
   decode_burst 8, the GEMM's buckets tuned on each rank and the kernel
   pinned in every one (the ranks time candidates against each other);
   (b) LLaMA-2-13B's widths at `SERVE13_LAYERS` (5), int8 weights per
   channel (lm_head kept) and int8 KV, 4 of (a)'s requests made greedy.
   First the kernels at the shard shapes against their plain versions
   (decode at 16 heads of 128 and int8 decode at 20, the dequant matmul's
   row shard 6912 -> 5120 and column shard 5120 -> 6912, the GEMM at the
   head's shard 4096 -> 16000). Held: every rank's streams equal bit for
   bit, greedy and sampled; each greedy stream equal to tp 1's or first
   differing at a near tie (`TPS_LOGIT_BAR` in (a), set before the first
   run; `TPS13_LOGIT_BAR` in (b), from its readings at 5 layers), the
   prefill's gathered last logits within that bar of tp 1's; each
   rank's pools at kv_heads / 2; the paged decode, RMSNorm, GEMM and
   dequant matmul launches exact a rank; in (b) the probes' quantized
   shards equal to slices of the tp-1 quantization bit for bit. Three
   planted faults caught: layer 0's o_proj without its all_reduce (the
   logits bar), the engine sampling the rank's vocab shard (the streams),
   a row shard quantized with its local absmax (the slice check). Logged:
   decode ms a step and collectives and bytes a step by rank (two ranks
   on one card: no tensor-parallel speed). `--phase17` runs the build and
   this phase alone;
18. ZeRO: two ranks on the one card over gloo, `fleet.init`
   (sharding_degree 2), LLaMA-2-7B's widths at `ZERO_LAYERS` (2) layers,
   bf16 O2, AdamW(1e-4) with f32 masters, the chunked LM-head loss, batch
   1 x 4096 a rank (each rank its own rows), 2 steps of build_train_step
   at each stage in turn from the same seeded weights: 0 (each gradient
   averaged over "sharding"), 1 (`fleet.distributed_optimizer`), 2 and 3
   (`group_sharded_parallel`). Held: every rank's losses equal, each
   stage's within `TP_LOSS_TOL` of stage 0's, the probes' f32 masters
   (their pieces joined over the ranks) within `TP_PARAM_BAR` of stage 0's
   over their update and first moments within `ZERO_MOMENT_BAR` (bit
   equality logged: the flash backward's dQ atomics make two backwards
   differ by a rounding); the bytes a rank holds (optimizer state from
   stage 1, gradients after the backward from stage 2, parameters between
   steps at stage 3: half of stage 0's) and `max_memory_allocated`
   falling from stage to stage; flash, RMSNorm and Adam launches exact a
   rank (Adam once a piece of the rank's slice). Three planted faults
   caught: a reduce_scatter without its division (the first moments),
   rank 1 gathering its slice at rank 0's offset (the next step's loss),
   stage 3 without the gather before a block's backward (the first
   moments). DTensor: `shard_tensor` / `reshard` of a [4096, 11008] bf16
   tensor on the card over both ranks (or at world 1 over NCCL where gloo
   does not carry DTensor's collectives on CUDA tensors), each local shard
   equal to the slice of the whole. Logged: step ms, reduce_scatters,
   all_gathers and bytes a step by rank (two ranks on one card: no ZeRO
   speed). `--phase18` runs the build and this phase alone.
19. Pipeline parallelism, in phase 18's two spawned ranks (after its
   results are saved, before its DTensor check): `fleet.init` at
   pp_degree 2, LLaMA-2-7B's widths at `PP_LAYERS` (4) of 32 layers, bf16
   O2, AdamW(1e-4) with f32 masters, the dense loss (of f32 logits),
   batch 4 x 4096 (the
   same rows on both stages) cut into M = 4 microbatches, 2 steps of
   build_train_step at each of "gpipe", "1f1b" and "vpp" (v = 2: rank r
   holds layers r and 2 + r) from the same seeded weights (`tp_load`),
   against pp = 1 on rank 0 (the mesh set aside, one plain step over the
   batch). Held: every rank's losses equal and each schedule's within
   `TP_LOSS_TOL` of pp 1's; the probes' f32 masters (each from the stage
   that holds it) within `TP_PARAM_BAR` of pp 1's over their update;
   stage 0's `max_memory_allocated` lower under 1F1B than under GPipe (at
   most 2 microbatches in flight against 4); flash, RMSNorm and Adam
   launches exact a rank; (2v - 1) M sends and receives a step a rank,
   each a staged [1, 4096, 4096] bf16 activation. Three planted faults
   caught: a 1F1B that skips the last microbatch's backward (the masters),
   the last stage sending zeros for its cotangent (stage 0's masters), a
   loss not divided by M (the loss against pp 1). Logged: step ms, sends,
   receives and staged bytes a step by rank (two ranks on one card over
   gloo: no pipeline speed). Then GPT-3 1.3B whole, the tied embedding on
   both stages, 2 1F1B steps of 4 x 2048 against pp 1 (losses, masters,
   the tied copies equal). `--phase19` runs the build and this phase
   alone.
20. BASELINE.json config 4 (LLaMA-2 13B, TP x PP x sharding stage 2), in
   phase 16 (a)'s four spawned ranks after their results are saved:
   `fleet.init` at pp 2 x sharding 2, LLaMA-2-13B's widths (hidden 5120,
   intermediate 13824, 40 heads of 128, vocab 32000, untied) at
   `ZPP_LAYERS` (2) of 40 layers, one a stage, bf16 O2, AdamW(1e-4) with
   f32 masters, the dense loss of f32 logits, ZeRO stage 2 through
   build_train_step, 1F1B, each sharding rank 2 x 4096 rows in M = 2
   microbatches, 2 steps, from phase 16's seeded weights (`tp_load`),
   against pp 1 x sharding 1 on rank 0 over the whole 4 x 4096 (the mesh
   set aside). Held: every rank's losses equal and within `TP_LOSS_TOL`
   of pp 1's; the probes' f32 masters (joined from the ranks' pieces)
   within `TP_PARAM_BAR` of pp 1's over their update; each rank holding
   half of stage 0's optimizer-state and gradient bytes (within 1 %);
   flash, RMSNorm and Adam launches exact a rank (Adam once a piece of
   the rank's slice); exactly one reduce_scatter a bucket a step. The
   checkpoint of step 1 (`CheckpointManager.save` of the tree
   `fleet.save` writes, every rank writing its pieces) saved in the
   background while step 2 runs; a second save of step 2 whose COMMITTED
   marker is withheld; fresh models, optimizers and engines restored by
   `CheckpointManager.restore` (falling back past step 2 to step 1):
   their optimizer state bit-equal to the uninterrupted run's after step 1
   (masters, moments, bias corrections), their step 2's loss bit-equal to
   the uninterrupted run's, and the probes' masters after it within
   `ZPP_RESUME_BAR` of the uninterrupted run's own over its step-2 update
   (the bf16 flash backward's dQ atomics), and within `TP_PARAM_BAR` of
   pp 1's. Four planted faults caught: the withheld marker (the restore
   falls back, counted), a restore that leaves the Adam moments at zero
   (the state check, and step 2's masters beyond `ZPP_RESUME_BAR`), a
   checkpoint piece written one element off (`fleet.save`'s writer; the
   forward loss of `fleet.load_model`'s model differs from the correct
   restore's), a reduce_scatter in every microbatch (M a bucket
   counted). Logged: step ms, reduce_scatters, all_gathers, sends,
   receives and staged bytes a step by rank (four ranks on one card over
   gloo: counts, not a speed), the checkpoint's bytes and its save and
   load seconds. `--phase20` runs the build and this phase alone.
21. the Paddle-shaped core (`to_tensor`, the dtypes and places,
   `backward` / `grad` / `no_grad` / `PyLayer`, the ops of
   paddle_tpu_torch/ops), in this process after phase 10: (a) the core's
   ops of every family (math, reduction, manipulation, logic, search,
   linalg, activation) at LLaMA-2-7B's widths ([4096, 4096] and
   [8, 4096, 11008]), bf16 and f32, on the card's tensors against the
   same calls on the CPU (`CORE_BAR`), every output on the card, every
   creation op after `set_device("gpu")` with no place on CUDAPlace(0),
   beside a planted fault (scatter(overwrite=False) adding into the old
   rows); (b) LLaMA-2-7B's widths at `CORE_LAYERS` (4) layers, bf16 O2,
   AdamW(1e-4), 1 x 4096, a warm step and `CORE_STEPS` (3) counted steps
   driven through the core (`to_tensor` ids, `paddle.autograd.backward`,
   `opt.step()`, `opt.clear_grad()`, a last forward under
   `paddle.no_grad()`) against the same steps through torch's calls, run
   twice: the first loss bit-equal, the later losses and the probe
   weights within `CORE_SPREAD` times the two torch runs' own spread (a
   loss also within 2 of its bf16 ulps),
   launches exact a step (flash 4 and 4, RMSNorm 9 and 9, Adam once a
   parameter tensor), `paddle.grad` of the final norm's weight bit-equal
   to backward's `.grad`; (c) a `PyLayer` over the RMSNorm kernels at
   [4096, 4096] bf16 bit-equal to `RMSNormFunction` (y, dx, dw; one
   launch each way) beside a planted fault (a non-scalar backward seeded
   with zeros). `--phase21` runs the build and this phase alone.

Every child process (a cell of phases 11-14, the ranks of a spawn in
phases 15-20) starts while the work before it runs, and waits for a go
file once it has imported this script and made its CUDA context (and its
process group), so its start hides behind that work and no two processes
work on the card at once (`run_child`, `start_spawn`, `join_spawn`).

Any failure raises and exits non-zero. The second-to-last line is the JSON
list of kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as TF

import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp, get_flags, set_flags
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.incubate.nn import (FusedMultiTransformer,
                                          FusedTransformerEncoderLayer)
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference import prefix_cache as tpc
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.io import DataLoader, TensorDataset
from paddle_tpu_torch.kernels import _build, autotune
from paddle_tpu_torch.kernels import adam as kadam
from paddle_tpu_torch.kernels import flash_attention as kfa
from paddle_tpu_torch.kernels import matmul as kmm
from paddle_tpu_torch.kernels import paged_attention as kpa
from paddle_tpu_torch.kernels import quant_matmul as kqm
from paddle_tpu_torch.kernels import rms_norm as krms
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     build_train_step, prefetch_batches)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Embedding, LayerNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.quant import quantize_for_inference, weight_quantize
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as lr_mod
from paddle_tpu_torch.weights import (fused_encoder_state_from_numpy,
                                      fused_encoder_state_to_numpy,
                                      gpt_state_to_numpy,
                                      llama_state_to_numpy, load_gpt_state,
                                      load_llama_state)

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


def process_age():
    """Seconds since this process started (its interpreter's start, from
    /proc), so that a child's log says what its start cost."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def stage(proc, what):
    """Log one step of a child process's time: `what` done at its age."""
    log(f"process {proc}: {what} at {process_age():.1f} s")


# Child processes started ahead of their turn. A child (a cell of phases
# 11-14, or the ranks of a spawn in phases 15-20) takes 11-16 s to import
# this script and make its CUDA context (PERF.md §6): started while the
# process before it still runs, it does that meanwhile, then waits for its
# go file, so no two processes work on the card at once.
_RUN_DIR = None
_STARTED = {}  # name -> a Popen (phases 11-14) or a _Spawn (15-20)
_PARENT = os.getppid()  # who started this process (at its start)


def run_dir():
    """The run's scratch directory (removed at exit)."""
    global _RUN_DIR
    if _RUN_DIR is None:
        _RUN_DIR = tempfile.mkdtemp(prefix="chip_smoke-")
        atexit.register(shutil.rmtree, _RUN_DIR, True)
    return _RUN_DIR


def phase_dir(phase):
    path = os.path.join(run_dir(), f"phase{phase}")
    os.makedirs(path, exist_ok=True)
    return path


def drop_phase_dir(phase):
    """Remove a phase's directory once its results are read (phases 15
    and 20 leave 10-14 GB checkpoints there)."""
    shutil.rmtree(os.path.join(run_dir(), f"phase{phase}"), True)


def wait_go(go, who):
    """Block until `go` exists (the parent's signal that the card is this
    process's), ending if the parent ends or writes `go`.stop first."""
    while not os.path.exists(go):
        if os.getppid() != _PARENT or os.path.exists(go + ".stop"):
            sys.exit(f"{who}: stopped before its go")
        time.sleep(0.02)
    stage(who, "go")


def child_go(phase, cell):
    return os.path.join(phase_dir(phase), f"go-{cell}")


def start_child(phase, cell, seed):
    """Start phase `phase`'s `cell` in a process of its own, to wait for
    its go file after its imports and CUDA context."""
    key = f"{phase}/{cell}"
    if key not in _STARTED:
        _STARTED[key] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             f"--phase{phase}", cell, "--io", phase_dir(phase), "--go",
             child_go(phase, cell)])
    return _STARTED[key]


def run_child(phase, cell, seed, timeout, then=()):
    """Run a cell's process (started ahead, or now) to its end, starting
    the processes `then` lists first ((phase, cell) pairs to start ahead,
    or functions that start something); (exit code, seconds from its
    go)."""
    proc = start_child(phase, cell, seed)
    for t in then:
        t() if callable(t) else start_child(*t, seed)
    t0 = time.perf_counter()
    open(child_go(phase, cell), "w").close()
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    finally:
        del _STARTED[f"{phase}/{cell}"]
    return rc, time.perf_counter() - t0


class _Spawn:
    """`distributed.spawn` of ranks in a thread: they start now, wait for
    `go` after their process group is up, and run when `join` makes it."""

    def __init__(self, fn, args, nprocs, timeout, go):
        from paddle_tpu_torch.distributed import spawn

        self.go, self.error = go, None

        def body():
            try:
                spawn(fn, args=args, nprocs=nprocs, timeout=timeout)
            except BaseException as e:  # re-raised by join
                self.error = e

        self.thread = threading.Thread(target=body, daemon=True)
        self.thread.start()

    def join(self):
        t0 = time.perf_counter()
        open(self.go, "w").close()
        self.thread.join()
        if self.error is not None:
            raise self.error
        return time.perf_counter() - t0


def rank_go(io, name):
    return os.path.join(io, f"go-{name}")


def start_spawn(name, io, fn, args, nprocs, timeout):
    """Start the ranks of spawn `name` ahead: `fn(*args)` in each, its go
    file `rank_go(io, name)`; `timeout` counts from the go."""
    if name not in _STARTED:
        _STARTED[name] = _Spawn(fn, args, nprocs, timeout + 1200,
                                rank_go(io, name))
    return _STARTED[name]


def join_spawn(name, then=None):
    """Run the started spawn `name` to its end, calling `then` (which
    starts the next processes ahead) first; seconds from its go."""
    sp = _STARTED[name]
    if then is not None:
        then()
    try:
        return sp.join()
    finally:
        del _STARTED[name]


def end_started():
    """End what was started ahead and never run (a failed run): a cell's
    process is killed; a spawn's ranks are told to stop (they end at their
    go, and the spawn's thread with them)."""
    for key, h in list(_STARTED.items()):
        if isinstance(h, subprocess.Popen):
            if h.poll() is None:
                h.kill()
                h.wait()
        else:
            open(h.go + ".stop", "w").close()
            h.thread.join(timeout=120)
        _STARTED.pop(key)


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


# torch.profiler loses device records at the ends of a session: the first
# few (more, the more sessions the process has run) and now and then a chunk
# of the last ones. On the H100 (`chip_profiler_loss.py`), 3 replays of a
# 20200-kernel graph lost their first 1 to 6 records in 9 of 10 sessions
# and their last 3, 916 and 3670 in 3; between runs of a pad kernel, none
# of theirs in 10. So `device_profiler` encloses the block between such
# runs, and `_device_events` strips them.
PAD_HEAD, PAD_TAIL = 128, 64
_PAD = {}


def _pad_kernels(n):
    """n launches of a kernel that no path of the port runs (NOT of a short
    int16 vector, made once, outside any session), then a sync."""
    if "x" not in _PAD:
        _PAD["x"] = torch.zeros(8, dtype=torch.int16, device="cuda")
    for _ in range(n):
        _PAD["x"].bitwise_not_()
    torch.cuda.synchronize()


def _pad_name():
    """The pad kernel's name in the profiler's records (found once)."""
    if "name" not in _PAD:
        _pad_kernels(2)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _pad_kernels(64)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        check(names, "the profiler recorded no launch of the pad kernel")
        _PAD["name"] = max(set(names), key=names.count)
    return _PAD["name"]


@contextlib.contextmanager
def device_profiler(cpu=False):
    """torch.profiler (device records, with `cpu` the host's too) over the
    block, which runs of the pad kernel enclose."""
    pad = _pad_name()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _pad_kernels(PAD_HEAD)
        yield prof
        torch.cuda.synchronize()
        _pad_kernels(PAD_TAIL)
        time.sleep(0.05)
    prof.pad_name = pad


def _strip_pads(prof):
    """(the block's device records, the head pad's and the tail pad's
    records kept): the records between the two runs of pad records, which
    the widest step between pad records in time order splits; a stray
    record before the first pad or after the last is left out. Where one
    of each pad was kept, the pads took every loss."""
    kind = torch.autograd.DeviceType.CUDA
    ev = sorted((e for e in prof.events() if e.device_type == kind),
                key=lambda e: e.time_range.start)
    at = [i for i, e in enumerate(ev) if e.name == prof.pad_name]
    if not at:
        return ev, 0, 0
    cut = max(range(1, len(at)), key=lambda j: at[j] - at[j - 1],
              default=0)
    if cut and at[cut] - at[cut - 1] > 1:
        return ev[at[cut - 1] + 1:at[cut]], cut, len(at) - cut
    # one run of pad records: the head's if records follow it
    if at[-1] + 1 < len(ev):
        return ev[at[-1] + 1:], len(at), 0
    return ev[:at[0]], 0, len(at)


def _device_events(prof):
    events, head, tail = _strip_pads(prof)
    if not (head and tail):
        log(f"profiler: a session lost device records past its pads (kept "
            f"{head} of {PAD_HEAD} before, {tail} of {PAD_TAIL} after)")
    return events


def time_ms(fn, iters, warmup=3):
    """(ms, timer): device ms per call, the sum of the kernel intervals that
    torch.profiler saw over `iters` calls; where it sees none, or lost
    records past its pads, CUDA events around the calls (which then include
    the host's launch time)."""
    for _ in range(warmup):
        fn()
    with device_profiler(cpu=True) as prof:
        for _ in range(iters):
            fn()
    events, head, tail = _strip_pads(prof)
    us = sum(e.time_range.elapsed_us() for e in events)
    if us > 0 and head and tail:
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


def paged_bound(nbytes, ctx, q_heads, d, dtype):
    """`bound` of a paged decode over `ctx` context tokens in all: q . k's
    2 * ctx * q_heads * d flops at the tensor cores' bf16 rate for bf16 q
    (bf16 and int8 K are exact in bf16), else at f32's, then P . V's as
    many at f32's (the softmax weights stay f32)."""
    flops = 2 * ctx * q_heads * d
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    qk_rate = BF16_FLOP_S if dtype == torch.bfloat16 else F32_FLOP_S
    t_ops = (flops / qk_rate + flops / F32_FLOP_S) * 1e3
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
    chunk. Both decode kernels take `kpa.QUERY_CHUNK` queries a unit."""
    b, qh, d = out.shape
    g = qh // kv_heads
    if g <= chunk:
        return None
    idx = torch.arange(g, device=out.device)
    idx[:chunk], idx[chunk:2 * chunk] = idx[chunk:2 * chunk].clone(), \
        idx[:chunk].clone()
    return out.reshape(b, kv_heads, g, d)[:, :, idx].reshape(b, qh, d)


def decode_plan(q, kp, tables):
    """The split plan the wrapper gives the decode kernel for these
    inputs (`kpa.split_plan`)."""
    b, qh, d = q.shape
    kvh, _, page, _ = kp.shape
    return kpa.split_plan(b, kvh, qh // kvh, d, page, tables.shape[1],
                          kpa.sm_count(q.device))


def split_lens(q_heads, kv_heads, d, page=16, pages_per_seq=256, b=8):
    """Contexts at the decode kernel's split edges for its plan at this
    shape: one split's tokens -1, +0 and +1, two splits' -1 and +1, the
    full table, and 0."""
    plan = kpa.split_plan(b, kv_heads, q_heads // kv_heads, d, page,
                          pages_per_seq, kpa.sm_count(torch.device("cuda")))
    span = plan["split_pages"] * page
    full = pages_per_seq * page
    return [0, span - 1, span, span + 1, 2 * span - 1, 2 * span + 1,
            full - 1, full][:b]


def without_split_partial_paged(args, scales, plan):
    """The plain decode with the first split's partial left out of the
    combine in every row combined from two or more (the fault of a combine
    that skips a slot): such a row attends only the pages past its first
    unit (`kpa.split_bounds`), its table shifted past them and its context
    (clipped to the table) cut by them; None where no row has two live
    splits."""
    q, kp, vp, tables, ln = args
    page = kp.shape[2]
    cut_tables, cut_lens = tables.clone(), ln.clone()
    for row, ctx in enumerate(ln.tolist()):
        ctx = max(0, min(ctx, tables.shape[1] * page))  # as the kernel
        bounds = kpa.split_bounds(ctx, page, plan["split_pages"])
        if len(bounds) >= 2:
            skip = bounds[0][1]
            cut_tables[row] = tables[row].roll(-skip)
            cut_lens[row] = ctx - skip * page
    if torch.equal(cut_lens, ln):
        return None
    return kpa.paged_attention_ref(q, kp, vp, cut_tables, cut_lens, None,
                                   **scales)


def paged_case(name, dtype, q_heads, kv_heads, gen, dev, lens, d=128,
               page=16, pages_per_seq=256, timed=True):
    """The per-page decode against the dense plain version (one bf16 ulp at
    the largest magnitude), bitwise equal over two calls, beside the faults
    of a swapped query chunk and a split partial left out. `timed`: time it
    after the serving phases (edge cases: no)."""
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
    again = kpa.paged_attention(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"paged_attention {name}: two calls "
          f"differ")
    del again
    want = kpa.paged_attention_ref(*args)
    err, tol = max_err(got, want, dtype)
    check(err <= tol, f"paged_attention {name}: max abs err {err} > {tol}")
    check(not got[lens.index(0)].any() if 0 in lens else True,
          f"paged_attention {name}: a ctx 0 row is not zero")
    ctl = {}
    swapped = chunk_swapped(want, kv_heads, kpa.QUERY_CHUNK)
    if swapped is not None:
        ctl["chunk_swapped"] = max_err(swapped, want, dtype)[0]
    plan = decode_plan(q, kp, tables)
    cut = without_split_partial_paged(args, {}, plan)
    if cut is not None:
        ctl["split_partial_left_out"] = max_err(cut, want, dtype)[0]
    for fault, r in ctl.items():
        check(r > tol, f"paged_attention {name}: the {fault} control reads "
              f"{r}, within {tol}")
    del got, want, swapped, cut
    elt = q.element_size()
    ctx = sum(lens)
    nbytes = (2 * ctx * kv_heads * d * elt + 2 * q.numel() * elt
              + 4 * sum(math.ceil(c / page) for c in lens) + 4 * b)
    b_ms, b_by = paged_bound(nbytes, ctx, q_heads, d, dtype)

    def timings():
        ms, timer = time_ms(lambda: kpa.paged_attention(*args), 50)
        return dict(
            ms=ms, timer=timer,
            plain_ms=time_ms(lambda: kpa.paged_attention_ref(*args), 5)[0],
            library_ms=time_ms(lambda: sdpa_paged(*args), 10)[0])

    return dict(
        case=name, batch=b, q_heads=q_heads, kv_heads=kv_heads, head_dim=d,
        page=page, lens=list(lens), dtype=str(dtype).split(".")[-1],
        split_pages=plan["split_pages"], n_splits=plan["n_splits"],
        max_abs_err=err, tol=tol, controls=ctl, bound_ms=b_ms,
        bound_by=b_by, **({"timings": timings} if timed else {}))


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
                  page=16, pages_per_seq=256, timed=True):
    """The int8 decode against the dense plain version, row by row
    (QUANT_TOL), bitwise equal over two calls, beside the faults of the K
    scales left out, a swapped query chunk and a split partial left out."""
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
    again = kpa.paged_attention(*args, **sc)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"paged_attention_int8 {name}: two "
          f"calls differ")
    del again
    want = kpa.paged_attention_ref(*args, **sc)
    err = row_rel_err(got, want)
    tol = QUANT_TOL[dtype]
    check(err <= tol, f"paged_attention_int8 {name}: row rel err {err} > "
          f"{tol}")
    check(not got[lens.index(0)].any() if 0 in lens else True,
          f"paged_attention_int8 {name}: a ctx 0 row is not zero")
    ctl = {"k_scales_left_out": row_rel_err(kpa.paged_attention_ref(
        *args, k_scales=torch.ones_like(ks), v_scales=vs), want)}
    swapped = chunk_swapped(want, kv_heads, kpa.QUERY_CHUNK)
    if swapped is not None:
        ctl["chunk_swapped"] = row_rel_err(swapped, want)
    plan = decode_plan(q, kp, tables)
    cut = without_split_partial_paged(args, sc, plan)
    if cut is not None:
        ctl["split_partial_left_out"] = row_rel_err(cut, want)
    del swapped, cut
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
    b_ms, b_by = paged_bound(nbytes, ctx, q_heads, d, dtype)

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
        split_pages=plan["split_pages"], n_splits=plan["n_splits"],
        row_rel_err=err, max_abs_err=abs_err, tol=tol, controls=ctl,
        bound_ms=b_ms, bound_by=b_by,
        **({"timings": timings} if timed else {}))


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
        got = kmm.matmul_fused(x, w, tile=tile)
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
        tile_ms = {t: time_ms(lambda: kmm.matmul_fused(x, w_next(), tile=t), it)
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
                       lambda a, b: kmm.matmul_fused(a, b, tile=best), (x, w)),
                       "library": autotune.default_timer(torch.matmul,
                                                         (x, w))})
        del w_next
        if check_timer:
            t = kmm.default_variant(m, n, dtype)
            res["tuner_timer_ms"] = {
                "tile": t, "graph_events": autotune.default_timer(
                    lambda a, b: kmm.matmul_fused(a, b, tile=t), (x, w), iters=20),
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
    in the wrong order against their V); "chunk_swapped" (groups above
    `kpa.QUERY_CHUNK` queries), two chunks of a group's queries swapped;
    "split_partial_left_out", the first split's partial left out of every
    row combined from two or more. Each must exceed the bar."""
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
    swapped = chunk_swapped(want, kp.shape[0], kpa.QUERY_CHUNK)
    if swapped is not None:
        ctl["chunk_swapped"] = row_rel_err(swapped, want)
    cut = without_split_partial_paged((q, kp, vp, tables, ln), {},
                                      decode_plan(q, kp, tables))
    if cut is not None:
        ctl["split_partial_left_out"] = row_rel_err(cut, want)
    return ctl


def grouped_case(name, dtype, q_heads, kv_heads, gen, dev, lens, d=128,
                 page=16, pages_per_seq=256, timed=True):
    """The grouped-fetch decode against the plain dense version, row by row
    (bar GROUPED_TOL), bitwise equal over two calls, beside the faults of
    `grouped_controls`, and against the per-page kernel."""
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
    again = kpa.paged_attention_grouped(*args)
    paged = kpa.paged_attention(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"paged_attention_grouped {name}: two "
          f"calls differ")
    del again
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
    b_ms, b_by = paged_bound(nbytes, ctx, q_heads, d, dtype)

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
        bound_by=b_by, **({"timings": timings} if timed else {}))


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


def drive(eng, requests, via_run=False):
    """Queue `requests` [(prompt, max_new, kwargs)], step the engine until
    idle, and time it: TTFT per request, and the steps that only decoded
    (a step of a burst engine decodes k token steps). `via_run`: one
    `eng.run()` instead (the async pipeline runs only there), timed whole."""
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
    finished, step_ms, dec_tok, dec_s, token_steps = [], [], 0, 0.0, 0
    t_all = time.perf_counter()
    while via_run and eng.has_work():
        finished += eng.run()
    while eng.has_work():
        p0, d0, k0 = eng.prefills, eng.decode_steps, n_tok[0]
        t0 = time.perf_counter()
        finished += eng.step()  # ends in a device->host read of the tokens
        dt = time.perf_counter() - t0
        if eng.prefills == p0 and eng.decode_steps > d0:
            step_ms.append(dt * 1e3)
            dec_tok += n_tok[0] - k0
            dec_s += dt
            token_steps += eng.decode_steps - d0
    wall = time.perf_counter() - t_all
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
                decode_tokens_per_s=dec_tok / dec_s if dec_s else None,
                ms_per_token_step=dec_s * 1e3 / token_steps
                if token_steps else None,
                wall_s=wall, tokens_per_s=n_tok[0] / wall)


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
    the one stream), the device's idle share, device time by kernel, and
    the paged decode kernel's ms per step and share of device time.
    `quant`: also the dequant matmul's device ms per step, which must come
    from the one-launch decode kernel (no split-summing kernel)."""
    for _ in range(eng.max_batch):
        eng.add_request(rng.randint(0, eng.cfg.vocab_size, 1000),
                        max_new_tokens=steps + 4)
    eng.step()  # admission, batched prefill, first decode step
    with device_profiler() as prof:
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
    res["paged_ms_per_step"] = sum(
        us for n, us in by_name.items() if "paged_decode_kernel" in n) \
        / 1e3 / steps
    res["paged_share"] = res["paged_ms_per_step"] / max(
        res["device_busy_ms_per_step"], 1e-9)
    log(f"profile:   the paged decode kernel: "
        f"{res['paged_ms_per_step']:.3f} ms/step of "
        f"{res['device_busy_ms_per_step']:.3f}, share "
        f"{res['paged_share']:.3f} [{card}]")
    for name, ms in res["top_kernels_ms_per_step"]:
        log(f"profile:   {ms:8.3f} ms/step  {name}")
    return res


def profile_prefill(eng, rng, card, n=2500):
    """One warm, profiled prefill of an n-token prompt (the request ends at
    its first token): wall ms, device busy ms, device time by kernel."""
    eng.add_request(rng.randint(0, eng.cfg.vocab_size, n), max_new_tokens=1)
    with device_profiler() as prof:
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
    forward, the prefill path; at tp > 1 the vocab shards gathered)."""
    with torch.no_grad():
        logits, _ = model.forward_cached(
            torch.from_numpy(ids)[None].to(dev),
            model.init_kv_caches(1, len(ids)), 0)
        return model.gather_logits(logits[:, -1])[0].float()


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


# The depths the 1200 s limit leaves: LLaMA-2-13B's widths at 5 of its 40
# layers in phases 4b, 11 and 17 (10 until phase 20 came, whose config-4
# run needs its own minute) and at 20 in phases 12's and 13's cells (at
# 10 the phase-12 cell's chunked stream differed from the dense one at a
# top-2 gap of 0.0156 against its near-tie bar of 0.0132, on one H100),
# and LLaMA-2-7B's at 16 of 32 in phases 11's, 12's and 13's cells, each
# held to its own eager or off engine. With phase 16 the whole script took
# 1029-1184 s on H100s where the script without it had taken 802-1247 s;
# the cells' host-bound work scales with their depth (PERF.md, §5).
SERVE13_LAYERS = 5
CELL13_LAYERS = 20
CELL7_LAYERS = 16
# phase 11's 7B cells: held to their own eager engine's streams (one
# program, bit for bit), so their depth only sets the host's work
BURST7_LAYERS = 8


def llama13b_cut(layers=SERVE13_LAYERS):
    cfg = LlamaConfig.llama2_13b()
    cfg.num_hidden_layers = layers
    return cfg


def llama7b_cell():
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = CELL7_LAYERS
    return cfg


def serve_13b(seed, dev, card, algo, group_size, lone=True):
    """LLaMA-2-13B (random weights, `init_default`), quantized weight-only
    (lm_head kept in bf16) and served over an int8 paged KV cache: the
    last-position logits of a 64-token prompt in bf16 and after quantizing
    (int8: held to the reference's 0.05 of the largest; with `lone` also
    read in f32 first, the floor bf16 rounding alone sets), then the
    phase-4 traffic (`lone`: also the 2500-token request) with the
    kernels' launch counts reset just before and checked just after."""
    cfg = llama13b_cut()
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
                  ("rms_norm_bwd", krms, "bwd_launches"),
                  ("adam", kadam, "launches"))


def _device_profile(fn):
    """Run fn() under the profiler: (wall ms, {kernel name: device us})."""
    with device_profiler() as prof:
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
                "rms_norm_bwd": 2 * layers + 1,
                "adam": n_param_tensors(layers)}
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
                     ("rms_norm", krms, "launches"),
                     ("adam", kadam, "launches"))


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
            if not kmm.supports(m, k, n, dtype=dtype):
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
    for mode in ("off", "on", "readonly_pinned"):
        got = res[mode]["launches"]["adam"]
        check(got == n_param_tensors(layers) * steps, f"dispatch (c): "
              f"{mode}: adam launched {got} times in {steps} steps, expected "
              f"{n_param_tensors(layers)} per step")
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


# ---------------------------------------------------------------------------
# phase 10: the rest of the training step: the Adam kernel, the 7B step
# through the new surface, an O1 + GradScaler loop, tiny CUDA-vs-CPU parity
# ---------------------------------------------------------------------------


# (a) the Adam update's shapes: LLaMA-2-7B's parameters and an odd tail
ADAM_SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096),
               (4096,), (4097,))
ADAM_MODES = (("bf16", torch.bfloat16, False), ("bf16_master",
                                                torch.bfloat16, True),
              ("f32", torch.float32, False))
ADAM_LR, ADAM_DECAY, ADAM_BETAS, ADAM_EPS = 1e-3, 0.1, (0.9, 0.999), 1e-8
# the timed case (the kernels line's row): the 7B step's MLP weights
ADAM_TIMED = ((11008, 4096), "bf16", "adamw", 1000)
# bars: each moment within 2 f32 ulps of the larger of its two summed terms
# and its value (a sum that cancels is held to its terms' rounding), p
# and the master weight within one rounding of their dtype (one ulp of the
# plain version's value)
ADAM_MOMENT_ULPS = 2
MANTISSA_BITS = {torch.float32: 24, torch.bfloat16: 8, torch.float16: 11}


def ulp(x, dtype):
    """One unit in the last place of each element of x in `dtype`."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       e - MANTISSA_BITS[dtype])


def adam_plain_fault(fault, p, g, m1, m2, master, lr, coeff, wd, bc1, bc2,
                     bc_prev):
    """The plain update (`kadam.adam_update_ref`) with one fault:
    "bias_previous" (the bias corrections from the previous step's
    powers), "decay_after" (AdamW's decay applied after the step, not
    before), "tail_left_out" (the numel % 8 elements past the last whole
    8-element vector not updated)."""
    b1, b2 = ADAM_BETAS
    if fault == "bias_previous":
        return kadam.adam_update_ref(p, g, m1, m2, master, b1, b2, ADAM_EPS,
                                     lr, coeff, wd, *bc_prev)
    if fault == "tail_left_out":
        n = p.numel() - p.numel() % 8
        flat = [None if t is None else t.view(-1)[:n]
                for t in (p, g, m1, m2, master)]
        return kadam.adam_update_ref(*flat, b1, b2, ADAM_EPS, lr, coeff, wd,
                                     bc1, bc2)
    # decay_after: the plain update without the decay, then the decay
    kadam.adam_update_ref(p, g, m1, m2, master, b1, b2, ADAM_EPS, lr, 0.0,
                          wd, bc1, bc2)
    if coeff:
        work = master if master is not None else p.detach().float()
        work.mul_(1 - lr * coeff)
        if work.data_ptr() != p.data_ptr():
            p.copy_(work)


def adam_case(shape, mode, kind, step, gen, dev, timed=False):
    """One update from random state at `step` (its beta powers) by the
    kernel and by the plain version on copies of the same tensors, held by
    the bars above; each fault made from the plain version read against
    the same bars (ratio of error to bar; > 1 fails). `kind` "adamw"
    (decoupled decay ADAM_DECAY) or "adam" (L2 ADAM_DECAY). timed: also
    the kernel's, the plain version's and `torch.optim.AdamW(fused=True)`'s
    time (bf16 parameters and moments), CUDA events."""
    name, dtype, with_master = mode
    b1, b2 = ADAM_BETAS
    p = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
    g = (torch.randn(shape, generator=gen, device=dev) * 1e-2).to(dtype)
    m1 = torch.randn(shape, generator=gen, device=dev) * 1e-3
    m2 = torch.randn(shape, generator=gen, device=dev).square() * 1e-6
    master = p.float() + torch.randn(shape, generator=gen, device=dev) \
        * 1e-5 if with_master else None
    pows = [np.float32(1.0), np.float32(1.0)]
    prev = pows
    for _ in range(step):
        prev = pows
        pows = [np.float32(pows[0] * np.float32(b1)),
                np.float32(pows[1] * np.float32(b2))]
    bc = (1 - pows[0], 1 - pows[1])
    bc_prev = (1 - prev[0], 1 - prev[1])
    coeff, wd = (ADAM_DECAY, 0.0) if kind == "adamw" else (0.0, ADAM_DECAY)
    state = (p, g, m1, m2, master)

    def copy():
        return [None if t is None else t.clone() for t in state]

    def run(fn, ts):
        fn(*ts, b1, b2, ADAM_EPS, ADAM_LR, coeff, wd, *bc)
        return ts

    n0 = kadam.launches
    got = run(kadam.adam_update, copy())
    check(kadam.launches == n0 + 1, "adam: the kernel did not launch")
    want = run(kadam.adam_update_ref, copy())
    torch.cuda.synchronize()
    # each moment's two summed terms, from the inputs
    gf = g.float() + (wd * (master if with_master else p.float())
                      if wd else 0.0)
    terms = {2: ((m1 * b1).abs(), (gf * (1 - b1)).abs()),
             3: ((m2 * b2).abs(), (gf.square() * (1 - b2)).abs())}

    def ratios(ts):
        out = {}
        for i, key in ((2, "m1"), (3, "m2")):
            scale = torch.maximum(torch.maximum(*terms[i]), want[i].abs())
            bar = ADAM_MOMENT_ULPS * ulp(scale, torch.float32)
            out[key] = ((ts[i] - want[i]).abs() / bar).max().item()
        out["p"] = ((ts[0].float() - want[0].float()).abs()
                    / ulp(want[0], dtype)).max().item()
        if with_master:
            out["master"] = ((ts[4] - want[4]).abs()
                             / ulp(want[4], torch.float32)).max().item()
        return out

    r = ratios(got)
    check(max(r.values()) <= 1.0, f"adam {shape} {name} {kind} step {step}: "
          f"kernel against plain, error over bar {r}")
    controls = {}
    for fault in ("bias_previous", "decay_after", "tail_left_out"):
        ts = copy()
        adam_plain_fault(fault, *ts, ADAM_LR, coeff, wd, *bc, bc_prev)
        fr = ratios(ts)
        # an inf or NaN reading (a bias correction of 1 - 1 = 0) fails
        controls[fault] = max(v if math.isfinite(v) else math.inf
                              for v in fr.values())
    res = dict(case=f"{'x'.join(map(str, shape))} {name} {kind} step {step}",
               dtype=str(dtype).split(".")[-1], ratios=r, controls=controls,
               max_abs_err=(got[0].float() - want[0].float()).abs().max()
               .item())
    # where each fault can show, it must fail the bar: the previous
    # powers at step 1 (1 - 1 = 0), the decay's place where the working
    # copy is f32, the tail at an odd numel
    if step == 1:
        check(controls["bias_previous"] > 1.0,
              f"adam {res['case']}: fault bias_previous passed the bar")
    if kind == "adamw" and (dtype == torch.float32 or with_master):
        check(controls["decay_after"] > 1.0,
              f"adam {res['case']}: fault decay_after passed the bar")
    if math.prod(shape) % 8:
        check(controls["tail_left_out"] > 1.0,
              f"adam {res['case']}: fault tail_left_out passed the bar")
    if timed:
        ts = copy()
        res["ms"] = events_ms(lambda: run(kadam.adam_update, ts), 20)
        res["plain_ms"] = events_ms(lambda: run(kadam.adam_update_ref, ts),
                                    20)
        q = torch.nn.Parameter(p.clone())
        q.grad = g.clone()
        lib = torch.optim.AdamW([q], lr=ADAM_LR, betas=ADAM_BETAS,
                                eps=ADAM_EPS, weight_decay=ADAM_DECAY,
                                fused=True)
        res["library_ms"] = events_ms(lib.step, 20)
        res["library_dtypes"] = f"{q.dtype} parameters and moments"
        nbytes = p.numel() * (2 * p.element_size() + g.element_size() + 16
                              + (8 if with_master else 0))
        res["bound_ms"], res["bound_by"] = bound(nbytes, 15 * p.numel())
        del lib, q
    return res


def adam_kernel_cases(gen, dev, card):
    """(a) every shape x mode x kind at steps 1 and 1000, one of them
    timed (`ADAM_TIMED`)."""
    rows = []
    for shape in ADAM_SHAPES:
        for mode in ADAM_MODES:
            for kind in ("adam", "adamw"):
                for step in (1, 1000):
                    rows.append(adam_case(
                        shape, mode, kind, step, gen, dev,
                        timed=(shape, mode[0], kind, step) == ADAM_TIMED))
                    torch.cuda.empty_cache()
    worst = {k: max(r["ratios"].get(k, 0.0) for r in rows)
             for k in ("m1", "m2", "p", "master")}
    shown = {f: sum(r["controls"][f] > 1.0 for r in rows)
             for f in ("bias_previous", "decay_after", "tail_left_out")}
    timed = next(r for r in rows if "ms" in r)
    log(f"adam (a): {len(rows)} cases (shapes {ADAM_SHAPES}, bf16, bf16 "
        f"with a master weight, f32; Adam-L2 and AdamW; steps 1 and 1000): "
        f"largest error over its bar {worst} (bars: moments "
        f"{ADAM_MOMENT_ULPS} f32 ulps of their terms, p and master one "
        f"rounding); faults failing the bar in {shown} of {len(rows)} cases")
    log(f"adam (a): {timed['case']}: kernel {timed['ms']:.4f} ms, plain "
        f"{timed['plain_ms']:.4f} ms, torch.optim.AdamW(fused=True) "
        f"{timed['library_ms']:.4f} ms ({timed['library_dtypes']}), bound "
        f"{timed['bound_ms']:.4f} ms ({timed['bound_by']}), CUDA events "
        f"[{card}]")
    return dict(cases=rows, worst=worst, faults_failing=shown, timed=timed)


def n_param_tensors(layers):
    """Parameter tensors of the LLaMA model: the embedding, 9 per layer (7
    linears, 2 norms), the final norm and the head."""
    return 9 * layers + 3


def surface_parts(cfg, model_params, seq, rows=2, seed=0, lr=1e-4,
                  chunks=8):
    """The new surface's pieces for a model: a scheduler (LinearWarmup over
    CosineAnnealingDecay), AdamW without decay on the norm weights, and a
    DataLoader over a TensorDataset of `rows` seeded sequences (labels the
    next token, the last ignored)."""
    sched = lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(lr, 50), 2,
                                lr / 10, lr)
    opt = AdamW(learning_rate=sched, parameters=model_params,
                weight_decay=0.01,
                apply_decay_param_fun=lambda n: "norm" not in n)
    rng = np.random.RandomState(seed)
    x = rng.randint(0, cfg.vocab_size, (rows, seq)).astype(np.int64)
    y = np.roll(x, -1, axis=1)
    y[:, -1] = -100
    loader = DataLoader(TensorDataset([x, y]), batch_size=1)
    return sched, opt, loader


def use_surface(model, chunks=8):
    model.config.use_recompute = True
    model.config.fused_ce_chunks = chunks
    for layer in model.llama.layers:
        layer.use_recompute = True


def train_surface(peak6_gib, seed, dev, card, layers=20, seq=4096, warm=2,
                  timed=4):
    """(b) phase 6's model (LLaMA-2-7B widths, 20 layers, bf16 O2, made
    again from the same seed) through
    the new surface: recompute, the chunked loss over 8 chunks, the
    scheduler stepped each call, AdamW without decay on the norms, gradient
    merge over 2 calls, batches from a DataLoader through
    prefetch_batches; `warm` calls, then `timed` calls with the launch
    counts from zero (per call: flash forward 2L, backward L, RMSNorm
    forward 4L + 1, backward 2L + 1; Adam once per tensor on every second
    call); losses finite and each sequence's falling; the peak memory
    against phase 6's; one profiled apply call gives the optimizer's
    device ms."""
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = layers
    model = amp.decorate(LlamaForCausalLM(cfg, device=dev, seed=seed),
                         level="O2", dtype="bfloat16")
    L = layers
    use_surface(model)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sched, opt, loader = surface_parts(model.config, model.parameters(), seq,
                                       seed=seed)
    step = build_train_step(model, opt, gradient_merge_steps=2)
    batches = prefetch_batches(step, (b for _ in range(warm + timed + 2)
                                      for b in loader))
    losses, call_ms = [], []

    def call():
        x, y = next(batches)
        t0 = time.perf_counter()
        loss = float(step(x, y))
        torch.cuda.synchronize()
        sched.step()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)

    for _ in range(warm):
        call()
    for _, mod, attr in TRAIN_COUNTERS:
        setattr(mod, attr, 0)
    for _ in range(timed):
        call()
    launches = {name: getattr(mod, attr) for name, mod, attr in
                TRAIN_COUNTERS}
    want = {"flash_fwd": 2 * L * timed, "flash_bwd": L * timed,
            "rms_norm": (4 * L + 1) * timed,
            "rms_norm_bwd": (2 * L + 1) * timed,
            "adam": n_param_tensors(L) * (timed // 2)}
    for name, n in want.items():
        check(launches[name] == n, f"surface: {name} launched "
              f"{launches[name]} times in {timed} calls, expected {n}")
    check(all(math.isfinite(v) for v in losses), f"surface: loss {losses}")
    # the loader alternates two sequences: each one's loss must fall
    check(losses[-2] < losses[0] and losses[-1] < losses[1],
          f"surface: losses did not fall: {losses}")
    check(opt._step_count == warm + timed, "surface: step count")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # one profiled merge cycle: the accumulating call, then the applying one
    wall_a, dev_a = _device_profile(call)
    wall_b, dev_b = _device_profile(call)
    opt_ms = sum(us for n, us in dev_b.items() if "adam_kernel" in n) / 1e3
    check(opt_ms > 0, "surface: the profiled apply call shows no Adam kernel")
    busy_b = sum(dev_b.values()) / 1e3
    timed_ms = call_ms[warm:warm + timed]
    res = dict(card=card, layers=L, seq=seq, losses=losses,
               call_ms=call_ms, accumulate_ms=timed_ms[0::2],
               apply_ms=timed_ms[1::2], launches=launches,
               max_memory_allocated_gib=peak_gib,
               phase6_max_memory_allocated_gib=peak6_gib,
               profile=dict(accumulate_wall_ms=wall_a,
                            accumulate_busy_ms=sum(dev_a.values()) / 1e3,
                            apply_wall_ms=wall_b, apply_busy_ms=busy_b,
                            optimizer_device_ms=opt_ms))
    log(f"surface (b): LLaMA-2-7B widths, {L} layers, batch 1 x {seq}, bf16 "
        f"O2, recompute, chunked loss (8), LinearWarmup(cosine), AdamW "
        f"(no decay on norms), gradient merge 2, DataLoader + "
        f"prefetch_batches: losses {', '.join(f'{v:.4f}' for v in losses)}")
    log(f"surface (b): timed calls {', '.join(f'{v:.1f}' for v in timed_ms)}"
        f" ms (accumulate, apply, ...); peak {peak_gib:.2f} GiB allocated "
        f"(phase 6: {peak6_gib:.2f}); launches {launches} [{card}]")
    log(f"surface (b): profiled apply call {wall_b:.1f} ms wall, "
        f"{busy_b:.1f} ms device busy, optimizer (Adam kernel) "
        f"{opt_ms:.2f} ms device; accumulate call {wall_a:.1f} ms wall "
        f"[{card}]")
    del model, step, opt, batches
    gc.collect()
    torch.cuda.empty_cache()
    return res


def o1_scaler_loop(seed, dev, card, layers=4, seq=2048, steps=5,
                   inf_step=2):
    """(c) LLaMA-2-7B widths at 4 layers, f32 parameters, an eager loop
    under auto_cast(O1, bf16) with GradScaler(2^15) and AdamW with
    ClipGradByGlobalNorm(1.0): at `inf_step` an inf planted in one
    gradient; that step is skipped (every parameter and moment bitwise
    unchanged) and the scale halves; the other losses finite."""
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = layers
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq))).to(dev)
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq))).to(dev)
    losses, scales, n0 = [], [], kfa.fwd_launches
    for i in range(steps):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model.compute_loss(model(x), y)
        check(loss.dtype == torch.float32, f"O1: loss dtype {loss.dtype}")
        scaler.scale(loss).backward()
        before = scale = None
        if i == inf_step:
            model.llama.layers[1].mlp.up_proj.weight.grad[3, 5] = math.inf
            before = [p.detach().clone() for p in model.parameters()]
            moments = {k: v.clone() for k, v in opt.state_dict().items()
                       if isinstance(v, torch.Tensor)}
            scale = scaler.get_loss_scaling()
        scaler.step(opt)
        opt.clear_grad()
        losses.append(loss.item())
        scales.append(scaler.get_loss_scaling())
        if before is not None:
            check(all(torch.equal(b, p.detach()) for b, p in
                      zip(before, model.parameters())),
                  "O1: the step with an inf gradient changed a parameter")
            check(all(torch.equal(v, opt.state_dict()[k])
                      for k, v in moments.items()),
                  "O1: the step with an inf gradient changed a moment")
            check(scales[-1] == scale / 2, f"O1: scale {scale} -> "
                  f"{scales[-1]}, expected half")
    check(all(math.isfinite(v) for v in losses), f"O1: losses {losses}")
    check(kfa.fwd_launches - n0 == layers * steps,
          "O1: attention did not run the bf16 flash kernel")
    log(f"o1 (c): LLaMA-2-7B widths, {layers} layers, f32 parameters, "
        f"auto_cast O1 bf16, GradScaler(2^15), AdamW + "
        f"ClipGradByGlobalNorm(1.0), batch 1 x {seq}: losses {losses}, "
        f"scales {scales} (inf planted at step {inf_step}: skipped, every "
        f"parameter and moment bitwise unchanged) [{card}]")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, scales=scales, inf_step=inf_step)


def tiny_surface_parity(seed, dev, calls=4):
    """(d) a tiny f32 LLaMA (head_dim 128) through (b)'s options on CUDA
    and on the CPU from the same weights: losses within 1e-4 relative and
    updates within 1e-2 of their norm, phase 7's bars."""
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2,
                           seq=256)
    cfg.num_key_value_heads = 1
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu = LlamaForCausalLM(cfg, device=dev)
    load_llama_state(gpu, {k: v.numpy() for k, v in cpu.state_dict().items()})
    before = {k: v.clone() for k, v in cpu.state_dict().items()}
    losses = []
    n0 = kadam.launches
    for model in (cpu, gpu):
        use_surface(model, chunks=8)
        sched, opt, loader = surface_parts(cfg, model.parameters(), 256,
                                           seed=seed, lr=1e-3)
        step = build_train_step(model, opt, gradient_merge_steps=2)
        seen = []
        for _ in range(calls // 2):
            for x, y in prefetch_batches(step, loader):
                seen.append(float(step(x, y)))
                sched.step()
        losses.append(seen)
    check(kadam.launches - n0 == n_param_tensors(2) * (calls // 2),
          "tiny surface: the Adam kernel did not run on CUDA")
    rel = max(abs(a - b) / abs(a) for a, b in zip(*losses))
    check(rel <= 1e-4, f"tiny surface: losses cpu {losses[0]} cuda "
          f"{losses[1]}")
    worst = 0.0
    g_state = gpu.state_dict()
    for name, c in cpu.state_dict().items():
        dc = c - before[name]
        dg = g_state[name].cpu() - before[name]
        worst = max(worst, ((dg - dc).norm() / dc.norm()).item())
    check(worst <= 1e-2, f"tiny surface: updates differ by {worst} of norm")
    log(f"parity (d): tiny f32 LLaMA (2 layers, 2 heads of 128) with "
        f"recompute, chunked loss, scheduler, AdamW, gradient merge 2, "
        f"DataLoader: losses cpu {losses[0]} cuda {losses[1]} (max rel "
        f"diff {rel:.2e}); updates differ by at most {worst:.2e} of their "
        f"norm")
    return dict(losses_cpu=losses[0], losses_cuda=losses[1],
                max_rel_loss_diff=rel, max_rel_update_diff=worst)


# ---------------------------------------------------------------------------
# phase 11: multi-step serving decode (decode_burst as CUDA graphs, async)
# ---------------------------------------------------------------------------

BURST = 8        # decode steps a program runs (one captured graph)
ASYNC_DEPTH = 2  # bursts kept in flight by the async engine


def count_kernels(events, part):
    return sum(part in e.name for e in events)


def profiled(fn):
    """fn() under torch.profiler (device records): (its result, wall s, the
    records)."""
    with device_profiler() as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, _device_events(prof)


def rms_per_forward(cfg, depth):
    """RMSNorm launches of one forward through `depth` layers: 2 a layer
    and the final norm for LLaMA; none for GPT, whose norms are
    LayerNorms."""
    return 2 * depth + 1 if hasattr(cfg, "rms_norm_eps") else 0


def graph_launches(events, cfg, token_steps, forwards, quant):
    """The kernels the device ran for `token_steps` decode steps and
    `forwards` forwards in all (prefills and decode steps), counted from
    the profiler's records (a graph replay bypasses the wrappers'
    counters), and what they must be: the paged decode L a step, RMSNorm
    `rms_per_forward` a forward, with int8 weights the dequant matmul's
    decode kernel 7L a step and no split-summing kernel. Returns (got,
    want)."""
    L = cfg.num_hidden_layers
    got = dict(paged_attention=count_kernels(events, "paged_decode_kernel"),
               rms_norm=count_kernels(events, "rms_norm_fwd"))
    want = dict(paged_attention=L * token_steps,
                rms_norm=rms_per_forward(cfg, L) * forwards)
    if quant:
        got["quant_matmul_decode"] = count_kernels(events, "skinny_kernel")
        want["quant_matmul_decode"] = 7 * L * token_steps
        got["split_sum"] = count_kernels(events, "split_sum_kernel")
        want["split_sum"] = 0
    return got, want


def counted(tag, run, card, phase=11):
    """run() -> (result, got, want) of one profiled window; again, up to
    twice, if the profiler's records fall short (it loses records at the
    ends of a session, which `device_profiler`'s pads take, and has lost a
    chunk at the end past them), so the launches must be exact in one of
    three windows. A window with MORE launches than the path implies fails
    at once."""
    res, got, want = run()
    for _ in range(2):
        if got == want or any(got[k] > want[k] for k in want):
            break
        log(f"phase {phase} {tag}: the profiler kept {got} of {want} device "
            f"records; the window runs once more [{card}]")
        res, got, want = run()
    check(got == want, f"{tag}: device launches {got}, expected {want}")
    return res, got


def burst_engine(model, seed, dev, kv, max_seq_len=4096, **kw):
    """The phase-4 engine at decode_burst=BURST, warmed: its four programs
    ((greedy or mixed) x (1 or BURST steps)) captured before traffic."""
    eng = ServingEngine(model, max_batch=8, max_seq_len=max_seq_len,
                        page_size=16, seed=seed, device=dev,
                        kv_cache_quant=kv, decode_burst=BURST, **kw)
    secs = eng.warmup(sampling=True)
    keys = {(g, k) for g in (True, False) for k in (1, BURST)}
    check(eng.graph_captures == 4 and set(eng._burst_fns) == keys,
          f"warmup captured {eng.graph_captures} graphs, keys "
          f"{sorted(eng._burst_fns)}")
    return eng, secs


def profile_burst(eng, rng, card, tag, bursts=3, via_run=False,
                  quant=False, phase=11):
    """Profile `bursts` bursts of pure decode at batch 8 (contexts ~1000),
    as `profile_decode` does for single steps: per token step, the wall
    ms, device busy ms, device operations; the idle share; the kernels'
    launches in the window, exact. Then as many bursts again with the
    profiler off: the wall ms a token step without its cost on each
    launch (a graph launch of ~1800 kernels is one host call, which the
    profiler makes dearer). `via_run`: through `run()` (the async
    pipeline), else one `step()` a burst."""
    k = eng.decode_burst

    def window():
        d0 = eng.decode_steps
        t0 = time.perf_counter()
        if via_run:
            eng.run(max_steps=bursts)
        else:
            for _ in range(bursts):
                eng.step()
        torch.cuda.synchronize()
        return eng.decode_steps - d0, time.perf_counter() - t0

    def run():
        for _ in range(eng.max_batch):
            eng.add_request(rng.randint(0, eng.cfg.vocab_size, 1000),
                            max_new_tokens=k * (2 * bursts + 2) + 1)
        eng.step()  # admission, batched prefill, first tokens, a burst
        r0 = eng.graph_replays
        (steps, _), wall, events = profiled(window)
        check(steps == bursts * k and eng.graph_replays - r0 == bursts,
              f"{tag}: {steps} token steps in {eng.graph_replays - r0} "
              f"replays, expected {bursts * k} in {bursts}")
        steps2, wall2 = window()
        check(steps2 == steps, f"{tag}: the unprofiled window ran {steps2} "
              f"token steps")
        eng.run()
        return ((wall, events, steps, wall2),
                *graph_launches(events, eng.cfg, steps, steps, quant))

    (wall, events, steps, wall2), launches = counted(f"{tag} window", run,
                                                     card, phase)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    res = dict(token_steps=steps, bursts=bursts,
               wall_ms_per_token_step=wall * 1e3 / steps,
               unprofiled_wall_ms_per_token_step=wall2 * 1e3 / steps,
               device_busy_ms_per_token_step=busy / 1e3 / steps,
               idle_share=1.0 - busy / (wall * 1e6),
               device_ops_per_token_step=len(events) / steps,
               paged_ms_per_token_step=sum(
                   us for n, us in by_name.items()
                   if "paged_decode_kernel" in n) / 1e3 / steps,
               launches=launches,
               top_kernels_ms_per_token_step=[(n[:90], us / 1e3 / steps)
                                              for n, us in top])
    if quant:
        res["dequant_ms_per_token_step"] = sum(
            us for n, us in by_name.items() if "skinny_kernel" in n) \
            / 1e3 / steps
    log(f"phase {phase} {tag}: batch-8 decode at context ~1000, {bursts} "
        f"bursts of {k}: {res['wall_ms_per_token_step']:.3f} ms/token-step "
        f"wall ({res['unprofiled_wall_ms_per_token_step']:.3f} unprofiled), "
        f"{res['device_busy_ms_per_token_step']:.3f} device busy, idle share "
        f"{res['idle_share']:.3f}, {res['device_ops_per_token_step']:.0f} "
        f"device operations a token step, paged kernel "
        f"{res['paged_ms_per_token_step']:.3f} ms"
        + (f", dequant decode kernel {res['dequant_ms_per_token_step']:.3f} "
           f"ms" if quant else "") + f", launches {launches} [{card}]")
    for name, ms in res["top_kernels_ms_per_token_step"]:
        log(f"phase {phase} {tag}:   {ms:8.4f} ms/token-step  {name}")
    return res


def burst_traffic(eng, long_req, batch, want, tag, card, via_run=False):
    """Phase 4's traffic on a warmed burst engine: the lone request, then
    the 10 requests under the profiler (launches counted from its
    records); greedy streams against `want` (the eager engine's) must be
    identical, no program may be captured during traffic, and no token may
    be emitted past a finish."""
    c0, r0 = eng.graph_captures, eng.graph_replays

    def run():
        lone = drive(eng, long_req, via_run=via_run)
        p0, d0 = eng.prefills, eng.decode_steps
        mixed, _, events = profiled(
            lambda: drive(eng, batch, via_run=via_run))
        steps = eng.decode_steps - d0
        agree = stream_agreement(want, lone, mixed)
        check(agree["greedy_identical"] == agree["greedy"] > 0,
              f"{tag}: greedy streams against the eager engine's: {agree}")
        return ((lone, mixed, agree),
                *graph_launches(events, eng.cfg, steps,
                                eng.prefills - p0 + steps,
                                eng.kv_cache_quant == "int8"))

    (lone, mixed, agree), launches = counted(f"{tag} traffic", run, card)
    check(eng.graph_captures == c0 and eng.graph_replays > r0,
          f"{tag}: {eng.graph_captures - c0} captures during traffic, "
          f"{eng.graph_replays - r0} replays")
    check(eng.discarded_tokens == 0,
          f"{tag}: {eng.discarded_tokens} tokens emitted past a finish")
    res = dict(lone_2500=lone, mixed_10=mixed, launches=launches,
               streams_vs_eager=agree, captures=eng.graph_captures,
               replays=eng.graph_replays, decode_steps=eng.decode_steps,
               prefills=eng.prefills)
    step_ms = "" if via_run else (
        f"; lone {lone['ms_per_token_step']:.3f} ms/token-step, mixed "
        f"{mixed['ms_per_token_step']:.3f}")
    log(f"phase 11 {tag}: phase 4's traffic: TTFT lone "
        f"{lone['ttft_ms'][0]:.1f} ms, mixed p50 "
        f"{np.median(mixed['ttft_ms']):.1f} ms; {lone['tokens_per_s']:.1f} / "
        f"{mixed['tokens_per_s']:.1f} tok/s whole{step_ms}; greedy streams "
        f"{agree['greedy_identical']} of {agree['greedy']} identical to the "
        f"eager engine's; {eng.graph_replays} replays of "
        f"{eng.graph_captures} graphs; mixed launches {launches} [{card}]")
    return res


def planted_faults(eng, long_req, lone_stream, card):
    """The eos check, and two faults that must break the check guarding
    each: a replay without the block-table copy (guard: the lone
    request's greedy stream equals the eager engine's), a burst body that
    ignores eos (guard: the stream stops at eos and the device emits
    nothing past it)."""
    prompt, s = long_req[0][0], lone_stream
    p = next(i for i in range(1, len(s))
             if s[i] not in s[:i] and (i - 1) % BURST != BURST - 1)

    def serve_lone(max_new, **kw):
        rid = eng.add_request(prompt, max_new_tokens=max_new, **kw)
        d0 = eng.discarded_tokens
        out = {f.request_id: f.output_ids.tolist() for f in eng.run()}
        return out[rid], eng.discarded_tokens - d0

    got, discarded = serve_lone(len(s), eos_token_id=s[p])
    check(got == s[:p + 1] and discarded == 0,
          f"eos at stream position {p}: got {len(got)} tokens, "
          f"{discarded} emitted past the eos")
    # fault 1: the block table is never copied to the program's buffer
    eng._buf.tables.zero_()
    eng._put_tables = lambda: None
    try:
        bad, _ = serve_lone(16)
    finally:
        del eng._put_tables
    first = next((i for i, (u, v) in enumerate(zip(bad, s)) if u != v), None)
    check(first is not None, "planted fault (replay without the block-table "
          "copy): the stream check did not catch it")
    # fault 2: the burst body keeps a row active past its eos
    rules = tserving.burst_rules
    tserving.burst_rules = lambda tok, lens, act, rem, nxt, eos: rules(
        tok, lens, act, rem, nxt, torch.full_like(eos, -1))
    eng._burst_fns.clear()
    try:
        got2, discarded2 = serve_lone(len(s), eos_token_id=s[p])
    finally:
        tserving.burst_rules = rules
        eng._burst_fns.clear()
    check(discarded2 > 0, "planted fault (a burst body that ignores eos): "
          "the check of tokens past the eos did not catch it")
    res = dict(eos_position=p, eos_stream_ok=True,
               no_table_copy_first_diff=first,
               eos_ignored_tokens_past_eos=discarded2,
               eos_ignored_stream_still_host_truncated=got2 == s[:p + 1])
    log(f"phase 11 faults: eos at position {p} (mid-burst) stops the lone "
        f"request there with nothing emitted past it; a replay without the "
        f"block-table copy differs from the eager stream at token {first} "
        f"(caught); a body that ignores eos emits {discarded2} tokens past "
        f"it (caught) [{card}]")
    return res


CELLS = ("7b_sync", "7b_async", "13b_int8_sync", "13b_int8_async")


def multi_step_cell(cell, seed, dev, card, io):
    """One phase-11 cell and mode, in a process of its own: the 7B cell
    (phase 4's model, LLaMA-2-7B bf16 from `seed`, at `BURST7_LAYERS` of
    its layers) or the 13B int8 cell (LLaMA-2-13B bf16 by `init_default`,
    int8 weights but lm_head, int8 KV); each cell's eager engine's
    streams, taken by its sync process into io/eager_<cell>.json, are what
    both modes are held to; phase 4's traffic on a burst engine,
    synchronous or with async_depth, then a profiled burst window; the 7B
    sync process also runs the planted faults."""
    big = cell.startswith("13b")
    mode = cell.rsplit("_", 1)[1]
    if big:
        cfg = llama13b_cut()
    else:
        cfg = LlamaConfig.llama2_7b()
        cfg.num_hidden_layers = BURST7_LAYERS
    cfg.dtype = "bfloat16"
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    kv = None
    if big:
        init_default(model, seed, dev)
        quantize_for_inference(model, "weight_only_int8", -1,
                               exclude=("lm_head",))
        kv = "int8"
        gc.collect()
        torch.cuda.empty_cache()
    stage(cell, "model built")
    rng = np.random.RandomState(seed)
    long_req, batch = traffic(rng, cfg.vocab_size)
    res = dict(card=card, layers=cfg.num_hidden_layers)
    eager_file = os.path.join(io, f"eager_{cell.rsplit('_', 1)[0]}.json")
    if mode == "async":
        with open(eager_file) as f:
            want = json.load(f)
    else:
        eng = ServingEngine(model, max_batch=8, max_seq_len=4096,
                            page_size=16, seed=seed, device=dev,
                            kv_cache_quant=kv)
        want = res["eager"] = dict(lone_2500=drive(eng, long_req),
                                   mixed_10=drive(eng, batch))
        del eng
        with open(eager_file, "w") as f:
            json.dump(want, f)
    tag = f"{'13B int8' if big else '7B'} {mode}"
    stage(cell, "eager streams")
    eng, secs = burst_engine(model, seed, dev, kv,
                             async_depth=ASYNC_DEPTH if mode == "async"
                             else 0)
    stage(cell, "burst engine warm")
    log(f"phase 11 {tag}: warmup (4 graphs captured) {secs:.2f} s")
    res.update(burst_traffic(eng, long_req, batch, want, tag, card,
                             via_run=mode == "async"))
    res["warmup_s"] = secs
    res["profile"] = profile_burst(eng, rng, card, tag,
                                   via_run=mode == "async", quant=big)
    if not big and mode == "sync":
        res["faults"] = planted_faults(
            eng, long_req, want["lone_2500"]["streams"][0], card)
    return res


def next_cells(phase, cells, then, ahead=1):
    """(cell, what to start before it runs) of a phase's cells in turn:
    the `ahead` cells after it, and with the last one `then` (the next
    phase's first cell, or a function that starts it; None: nothing)."""
    return [(c, [(phase, n) for n in cells[i + 1:i + 1 + ahead]]
             + ([then] if then is not None and i + 1 == len(cells) else []))
            for i, c in enumerate(cells)]


def multi_step_serving(seed, card, serving, serving13, then=None):
    """Phase 11: each cell and mode in a process of its own (late in a long
    run the profiler drops device records, and the launch counts here come
    from them), each cell's sync process taking its eager engine's streams
    for both modes; prints the burst decode beside phase 4's and 4b's
    single-step numbers. Each process starts while the one before runs
    (`run_child`); `then` starts after the last."""
    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    io = phase_dir("11")
    for cell, nxt in next_cells("11", CELLS, then):
        rc, secs = run_child("11", cell, seed, 900, nxt)
        check(rc == 0, f"phase 11 ({cell}) failed: exit {rc}")
        with open(os.path.join(io, f"{cell}.json")) as f:
            res[cell] = json.load(f)
        res[cell]["process_s"] = secs
    for cell, base, depth in (
            ("7b", serving, LlamaConfig.llama2_7b().num_hidden_layers),
            ("13b_int8", serving13, SERVE13_LAYERS)):
        eager = base["decode_profile"]
        line = ", ".join(
            f"{mode} {p['wall_ms_per_token_step']:.3f} ms/token-step wall "
            f"({p['unprofiled_wall_ms_per_token_step']:.3f} unprofiled), "
            f"{p['device_busy_ms_per_token_step']:.3f} device, idle "
            f"{p['idle_share']:.3f}, {p['device_ops_per_token_step']:.0f} "
            f"ops" for mode in ("sync", "async")
            for p in (res[f"{cell}_{mode}"]["profile"],))
        log(f"phase 11 {cell} ({res[f'{cell}_sync']['layers']} layers): "
            f"batch-8 decode at context ~1000, burst {BURST} graphs: {line}; "
            f"phase {'4b' if cell.startswith('13b') else '4'}'s eager step "
            f"({depth} layers): "
            f"{eager['wall_ms_per_step']:.3f} ms wall, "
            f"{eager['device_busy_ms_per_step']:.3f} device, idle "
            f"{eager['idle_share']:.3f}, {eager['device_ops_per_step']:.0f} "
            f"ops [{card}]")
    return res


# ---------------------------------------------------------------------------
# phase 12: the prefix cache and chunked prefill
# ---------------------------------------------------------------------------

SYSTEM_PROMPT = 1024  # tokens the shared requests start with (64 pages)
CHUNK = 512           # prefill_chunk of the chunked engine
PREFIX_CELLS = ("7b", "13b_int8")
# (name, engine arguments): chunked prefill over the prefix cache, the cache
# alone (a hit's suffix is one chunk round), and both off
PREFIX_ENGINES = (("chunk_cache", dict(prefix_cache=1, prefill_chunk=CHUNK)),
                  ("cache", dict(prefix_cache=1)), ("off", {}))
PREFIX_PARTS = ("first", "shared_11", "lone_2500")


def prefix_traffic(rng, vocab):
    """Phase 12's requests, all greedy, in three parts run one after the
    other: the first of 12 requests that share one 1024-token system
    prompt, each with a tail of its own (16-600 tokens) and 32-64 new
    tokens, alone (it fills the trie); the other 11 together (through 8
    slots); a lone 2500-token prompt with 64 new tokens. Returns (the
    system prompt, the parts)."""
    system = rng.randint(0, vocab, SYSTEM_PROMPT)
    shared = [(np.concatenate([system, rng.randint(0, vocab, int(
        rng.randint(16, 601)))]), int(rng.randint(32, 65)), {})
        for _ in range(12)]
    return system, [shared[:1], shared[1:],
                    [(rng.randint(0, vocab, 2500), 64, {})]]


def page_pools(eng):
    return eng.k_pages + eng.v_pages + (
        eng.k_scales + eng.v_scales if eng.kv_cache_quant else [])


def page_sums(eng, pages):
    """An integer checksum of each page over every layer's K and V pools
    (and int8 scales): the raw bits of each element times a weight of its
    place, summed exactly in int64."""
    idx = torch.tensor(pages, dtype=torch.long, device=eng.device)
    total = torch.zeros(len(pages), dtype=torch.int64, device=eng.device)
    bits = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32, torch.int8: torch.int8}
    for j, pool in enumerate(page_pools(eng)):
        x = pool[:, idx].transpose(0, 1).contiguous()
        x = x.view(bits[pool.dtype]).reshape(len(pages), -1).long()
        w = torch.arange(x.shape[1], device=x.device) % 65521 + 1 + j
        total += (x * w).sum(dim=1)
    return total.tolist()


def page_invariant(eng):
    """The page accounting after a request: the free list without
    duplicates, held + free == n, no free page with a reference, a page in
    two live rows owned by the trie, the scratch page off the books, and
    (the exact form) every page's count equal to the rows that hold it
    plus one if the trie owns it."""
    refs, free, n = eng._page_refs, eng._free_pages, len(eng._page_refs)
    trie = eng._prefix_cache
    check(len(set(free)) == len(free), "page invariant: a page is twice on "
          "the free list")
    held = sum(1 for r in refs if r > 0)
    check(held + len(free) == n, f"page invariant: held {held} + free "
          f"{len(free)} != {n}")
    check(all(refs[p] == 0 for p in free), "page invariant: a free page "
          "has a reference")
    check(eng._scratch == n and eng._scratch not in free, "page invariant: "
          "the scratch page is on the books")
    rows = {}
    for si, s in enumerate(eng.slots):
        if s.active:
            for p in eng.block_tables[si, :s.n_pages].tolist():
                rows[p] = rows.get(p, 0) + 1
    for p, c in rows.items():
        check(c == 1 or (trie is not None and trie.owns(p)),
              f"page invariant: page {p} in {c} rows without the trie")
    bad = [p for p in range(n) if refs[p] != rows.get(p, 0) + int(
        trie is not None and trie.owns(p))]
    check(not bad, f"page invariant: pages {bad[:8]} have counts "
          f"{[refs[p] for p in bad[:8]]} against their rows and the trie")


class PageHolds:
    """The page invariant and the trie's pages: each page's checksum is
    taken when it enters the trie and must stay the same until the trie
    drops it (`check`)."""

    def __init__(self, eng):
        self.eng, self.sums, self.checks = eng, {}, 0
        trie = eng._prefix_cache
        if trie is None:
            return
        insert, drop = trie.insert, trie._drop

        def held_insert(ctx, row):
            n = insert(ctx, row)
            new = [p for p in trie.pages() if p not in self.sums]
            if new:
                self.sums.update(zip(new, page_sums(eng, new)))
            return n

        def held_drop(node):
            self.sums.pop(node.page, None)
            drop(node)

        trie.insert, trie._drop = held_insert, held_drop
        held_insert([], [])  # the pages already cached (warmup's)

    def check(self):
        page_invariant(self.eng)
        self.checks += 1
        if not self.sums:
            return
        pages = sorted(self.sums)
        now = dict(zip(pages, page_sums(self.eng, pages)))
        moved = [p for p in pages if now[p] != self.sums[p]]
        check(not moved, f"trie pages {moved[:8]} changed after their "
              f"insert ({len(moved)} of {len(pages)})")


def drive_held(eng, requests, holds):
    """Queue `requests` [(prompt, max_new, kwargs)] and step the engine
    until idle, the page holds after every step that finished a request:
    TTFT per request, the streams, wall s and tokens."""
    t_add, t_first, n_tok = {}, {}, [0]

    def on_token(rid, _tok):
        n_tok[0] += 1
        t_first.setdefault(rid, time.perf_counter())

    rids, out = [], {}
    t0 = time.perf_counter()
    for prompt, max_new, kw in requests:
        rid = eng.add_request(prompt, max_new_tokens=max_new,
                              on_token=on_token, **kw)
        t_add[rid] = time.perf_counter()
        rids.append((rid, max_new))
    while eng.has_work():
        done = eng.step()
        for f in done:
            out[f.request_id] = f.output_ids.tolist()
        if done:
            holds.check()
    wall = time.perf_counter() - t0
    holds.check()
    check(sorted(out) == sorted(r for r, _ in rids)
          and all(len(out[r]) == m for r, m in rids),
          "phase 12: a request did not finish with its tokens")
    return dict(ttft_ms=[1e3 * (t_first[r] - t_add[r]) for r, _ in rids],
                streams=[out[r] for r, _ in rids], wall_s=wall,
                tokens=n_tok[0])


PREFIX_KERNELS = (("paged_attention", "paged_decode_kernel"),
                  ("rms_norm", "rms_norm_fwd"),
                  ("quant_matmul_decode", "skinny_kernel"))


def graph_kernels(eng):
    """The kernels each captured decode program holds, from the profiler's
    records of one replay of it with every row inactive (it writes only
    the scratch page); then each program's replays are counted. Returns
    ({key: {kernel: n}}, {key: replays})."""
    per_key, replays = {}, {}
    for key, fn in list(eng._burst_fns.items()):
        eng._buf.idle()
        _, _, events = profiled(fn)
        per_key[key] = {name: count_kernels(events, part)
                        for name, part in PREFIX_KERNELS}

        def counted_fn(_fn=fn, _key=key):
            replays[_key] = replays.get(_key, 0) + 1
            _fn()

        eng._burst_fns[key] = counted_fn
    return per_key, replays


def reset_prefix_counters():
    krms.launches = 0
    kpa.launches = 0
    kpa.q8_launches = 0
    kqm.reset_launches()


def prefix_launches(eng, per_key, replays):
    """Every launch of the path's kernels since `reset_prefix_counters`:
    the wrappers' counts (prefills and chunk rounds run eagerly) plus each
    program's replays times the kernels it holds (a replay bypasses the
    wrappers)."""
    quant = eng.kv_cache_quant == "int8"
    graph = {name: sum(n * per_key[k][name] for k, n in replays.items())
             for name, _ in PREFIX_KERNELS}
    out = dict(rms_norm=krms.launches + graph["rms_norm"])
    out["paged_attention_int8" if quant else "paged_attention"] = \
        (kpa.q8_launches if quant else kpa.launches) \
        + graph["paged_attention"]
    if kqm.launches or graph["quant_matmul_decode"]:
        out["quant_matmul_prefill"] = kqm.kernel_launches["prefill"]
        out["quant_matmul_decode"] = kqm.kernel_launches["decode"] \
            + graph["quant_matmul_decode"]
    return out


def first_token_logits(eng):
    """Record the logits every prefill-time sample is drawn from (dense
    prefill and chunk rounds; decode samples inside its programs): a list
    the engine's `_sample` appends to."""
    seen = []
    real = eng._sample

    def sample(logits, all_greedy, params):
        seen.append(logits.float().cpu())
        return real(logits, all_greedy, params)

    eng._sample = sample
    return seen


def logit_distance(a, b):
    return float((a - b).abs().max() / b.abs().max())


def profile_lone_prefill(eng, prompt, card, tag):
    """A fresh prompt's prefill alone (the request ends at its first
    token), each forward under the profiler on its own (the chunk rounds
    one by one): device busy ms and wall ms a forward, the peak memory
    above what was resident, and the first token's logits."""
    rounds = []
    real_chunk, real_batch = eng._prefill_chunk_round, eng._prefill_batch

    def timed(real):
        def run(*a):
            _, wall, events = profiled(lambda: real(*a))
            rounds.append(dict(device_ms=sum(
                e.time_range.elapsed_us() for e in events) / 1e3,
                wall_ms=wall * 1e3))
        return run

    eng._prefill_chunk_round = timed(real_chunk)
    eng._prefill_batch = timed(real_batch)
    seen = first_token_logits(eng)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        eng.add_request(prompt, max_new_tokens=1)
        done = eng.run()
    finally:
        for name in ("_prefill_chunk_round", "_prefill_batch", "_sample"):
            delattr(eng, name)
    check(len(done) == 1, f"{tag}: the lone prefill did not finish")
    res = dict(forwards=rounds, device_ms=sum(r["device_ms"] for r in rounds),
               wall_ms=sum(r["wall_ms"] for r in rounds),
               peak_above_resident_gib=(torch.cuda.max_memory_allocated()
                                        - base) / 2 ** 30)
    log(f"phase 12 {tag}: a {len(prompt)}-token prefill alone in "
        f"{len(rounds)} forward(s): device " + ", ".join(
            f"{r['device_ms']:.2f}" for r in rounds)
        + f" ms (sum {res['device_ms']:.2f}), wall {res['wall_ms']:.1f} ms, "
        f"peak {res['peak_above_resident_gib']:.3f} GiB above the resident "
        f"[{card}]")
    return res, seen[-1][0]


def prefix_engine_run(model, name, kw, parts, seed, dev, card, kv, tag,
                      lone_probe=None):
    """One engine of phase 12 (decode_burst 8, its four programs captured
    by warmup), the traffic's parts in turn under the page holds, the
    launches counted from zero; with `lone_probe`, then a profiled
    prefill of that fresh prompt alone."""
    eng = ServingEngine(model, max_batch=8, max_seq_len=4096, page_size=16,
                        seed=seed, device=dev, kv_cache_quant=kv,
                        decode_burst=BURST, **kw)
    secs = eng.warmup()
    captures = eng.graph_captures
    per_key, replays = graph_kernels(eng)
    holds = PageHolds(eng)
    logits = first_token_logits(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_prefix_counters()
    r0, c0 = eng.graph_replays, eng.chunk_rounds
    res = dict(engine=name, warmup_s=secs)
    t0 = time.perf_counter()
    for part, reqs in zip(PREFIX_PARTS, parts):
        res[part] = drive_held(eng, reqs, holds)
        if part == "first":
            res["first_logits"] = logits[-1][0]
    wall = time.perf_counter() - t0
    del eng._sample
    res["launches"] = prefix_launches(eng, per_key, replays)
    check(eng.graph_captures == captures,
          f"{tag} {name}: {eng.graph_captures - captures} captures during "
          f"traffic")
    check(sum(replays.values()) == eng.graph_replays - r0 > 0,
          f"{tag} {name}: {sum(replays.values())} counted replays of "
          f"{eng.graph_replays - r0}")
    check(all(n > 0 for n in res["launches"].values()),
          f"{tag} {name}: a kernel of the path never ran: "
          f"{res['launches']}")
    tokens = sum(res[p]["tokens"] for p in PREFIX_PARTS if p in res)
    hit = res["shared_11"]["ttft_ms"] if eng._prefix_cache else []
    miss = res["first"]["ttft_ms"] + res.get("lone_2500", {}).get(
        "ttft_ms", []) + ([] if eng._prefix_cache
                          else res["shared_11"]["ttft_ms"])
    res.update(
        hits=eng._prefix_hits_total, misses=eng._prefix_misses_total,
        chunk_rounds=eng.chunk_rounds - c0, prefills=eng.prefills,
        replays={f"{'greedy' if g else 'mixed'}_{k}": n
                 for (g, k), n in replays.items()},
        wall_s=wall, tokens_per_s=tokens / wall,
        ttft_hit_p50_ms=float(np.median(hit)) if hit else None,
        ttft_miss_p50_ms=float(np.median(miss)), holds_checked=holds.checks,
        trie_pages=len(holds.sums), peak_gib=torch.cuda.max_memory_allocated()
        / 2 ** 30)
    log(f"phase 12 {tag} {name}: prefix hit {res['hits']} / miss "
        f"{res['misses']} tokens, {res['chunk_rounds']} chunk rounds, "
        f"{res['prefills']} dense prefills; TTFT p50 with a hit "
        + ("n/a" if res["ttft_hit_p50_ms"] is None
           else f"{res['ttft_hit_p50_ms']:.1f}")
        + f" ms, without {res['ttft_miss_p50_ms']:.1f} ms; "
        f"{res['tokens_per_s']:.1f} tok/s over the whole traffic "
        f"({wall:.2f} s); peak {res['peak_gib']:.2f} GiB; holds checked "
        f"{holds.checks} times over {len(holds.sums)} trie pages; launches "
        f"{res['launches']}; warmup {secs:.2f} s [{card}]")
    if lone_probe is not None:
        res["lone_prefill"], res["lone_logits"] = profile_lone_prefill(
            eng, lone_probe, card, f"{tag} {name}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def judge_streams(model, dev, prompts, got, want, dist, tag, card,
                  phase=12):
    """Every stream of `got` equal to the off engine's `want`, or, where
    one differs, the off engine's top-2 logit gap at the first differing
    token at most `dist` times its largest |logit| (a near tie that a
    change of summation order may flip). Returns the differences."""
    diffs = []
    for i, (prompt, g, w) in enumerate(zip(prompts, got, want)):
        k = next((j for j, (u, v) in enumerate(zip(g, w)) if u != v), None)
        if k is None:
            continue
        lg = last_logits(model, np.concatenate(
            [prompt, np.asarray(w[:k], np.int64)]), dev)
        top = torch.topk(lg, 2).values
        gap, bar = float(top[0] - top[1]), dist * float(lg.abs().max())
        diffs.append(dict(request=i, token=k, gap=gap, bar=bar))
        log(f"phase {phase} {tag}: request {i} first differs at token "
            f"{k}: the off engine's top-2 gap {gap:.4g} against the bar "
            f"{bar:.4g} [{card}]")
        check(gap <= bar, f"{tag}: request {i} differs at token {k} where "
              f"the off engine's top-2 gap {gap:.4g} exceeds {bar:.4g}")
    return diffs


def fault_caught(run, what):
    """run() must fail a page hold: the hold's message."""
    try:
        run()
    except AssertionError as e:
        msg = str(e)
        check(msg.startswith(("page invariant", "trie pages")),
              f"planted fault ({what}) failed elsewhere: {msg}")
        return msg
    raise AssertionError(f"planted fault ({what}): the holds did not catch "
                         f"it")


class TailSharingCache(tpc.PrefixCache):
    """Planted fault 2: a trie that caches a prompt's partial tail page too
    and whose match shares it (padding the last chunk to a full page)."""

    def _padded(self, ctx):
        return list(ctx) + [-1] * (-len(ctx) % self.page_size)

    def insert(self, ctx, page_row):
        return super().insert(self._padded(ctx), page_row)

    def match(self, ctx):
        pages, _ = super().match(self._padded(ctx) + [-1])
        return pages, min(len(pages) * self.page_size, len(ctx) - 1)


def prefix_faults(model, system, rng, seed, dev, card):
    """Three planted faults, each on a small fresh engine beside the same
    scenario on a sound one (which must pass the holds): a chunk round that
    ignores `limit_lens` (a short prompt's chunk then writes into the stale
    tail of its table row, the trie pages of the slot's last tenant), a
    match that also shares the partial tail page, a `_release_slot` that
    skips one decref."""
    vocab = model.config.vocab_size
    long_p = np.concatenate([system, rng.randint(0, vocab, 100)])
    short_p = rng.randint(0, vocab, 40)
    tail_p = np.concatenate([system, rng.randint(0, vocab, 37)])

    def engine(**kw):
        eng = ServingEngine(model, max_batch=2, max_seq_len=2048,
                            page_size=16, seed=seed, device=dev,
                            prefix_cache=1, **kw)
        return eng

    def scenario(eng, prompts):
        holds = PageHolds(eng)
        for p in prompts:
            drive_held(eng, [(p, 4, {})], holds)

    def no_limit(real):
        def fwd(ids, *a, limit_lens=None, **kw):
            return real(ids, *a, **kw)
        return fwd

    def leaky_release(eng):
        real_release, real_decref = eng._release_slot, eng._decref_page

        def release(slot_idx):
            skip = [True]

            def decref(page):
                if skip[0]:
                    skip[0] = False
                    return
                real_decref(page)

            eng._decref_page = decref
            try:
                real_release(slot_idx)
            finally:
                del eng._decref_page

        eng._release_slot = release

    def tail_sharing(eng):
        eng._prefix_cache = TailSharingCache(eng.page_size, eng._page_refs,
                                             eng._free_pages)

    res = {}
    cases = (("chunk_ignores_limit", dict(prefill_chunk=CHUNK),
              [long_p, short_p], None),
             ("match_shares_tail_page", {}, [tail_p, tail_p], tail_sharing),
             ("release_skips_a_decref", {}, [tail_p], leaky_release))
    for name, kw, prompts, plant in cases:
        scenario(engine(**kw), prompts)  # sound: the holds pass
        eng = engine(**kw)
        if plant is not None:
            plant(eng)
            res[name] = fault_caught(lambda: scenario(eng, prompts), name)
        else:
            model.forward_paged = no_limit(model.forward_paged)
            try:
                res[name] = fault_caught(lambda: scenario(eng, prompts),
                                         name)
            finally:
                del model.forward_paged
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 12 fault '{name}': caught by the holds: {res[name]} "
            f"[{card}]")
    return res


def prefix_cell(cell, seed, dev, card):
    """One phase-12 cell in a process of its own. 7b: LLaMA-2-7B's widths
    at `CELL7_LAYERS` layers, bf16 from `seed`, through the three engines
    (PREFIX_ENGINES), each the whole
    traffic, then the streams judged against the off engine's and the
    planted faults. 13b_int8: LLaMA-2-13B (`init_default`, int8 weights
    but lm_head, int8 KV) through the chunked engine and the off engine on
    the traffic's first 4 requests, at `CELL13_LAYERS` layers."""
    big = cell == "13b_int8"
    cfg = llama13b_cut(CELL13_LAYERS) if big else llama7b_cell()
    cfg.dtype = "bfloat16"
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    kv = None
    if big:
        init_default(model, seed, dev)
        quantize_for_inference(model, "weight_only_int8", -1,
                               exclude=("lm_head",))
        kv = "int8"
        gc.collect()
        torch.cuda.empty_cache()
    stage(cell, "model built")
    rng = np.random.RandomState(seed + 12)
    system, parts = prefix_traffic(rng, cfg.vocab_size)
    lone_probe = rng.randint(0, cfg.vocab_size, 2500)
    engines = PREFIX_ENGINES
    tag = "13B int8" if big else "7B"
    if big:
        parts = [parts[0], parts[1][:3]]
        engines = (engines[0], engines[2])
    res = dict(card=card, layers=cfg.num_hidden_layers)
    for name, kw in engines:
        res[name] = prefix_engine_run(
            model, name, kw, parts, seed, dev, card, kv, tag,
            lone_probe=None if big or name == "cache" else lone_probe)
    off = res["off"]
    chunk = res["chunk_cache"]
    dist = {"first": logit_distance(chunk["first_logits"],
                                    off["first_logits"])}
    if not big:
        dist["lone_2500"] = logit_distance(chunk["lone_logits"],
                                           off["lone_logits"])
        a, b = chunk["lone_prefill"], off["lone_prefill"]
        log(f"phase 12 {tag}: the lone 2500-token prefill, chunked at "
            f"{CHUNK} against dense: device {a['device_ms']:.2f} against "
            f"{b['device_ms']:.2f} ms, peak "
            f"{a['peak_above_resident_gib']:.3f} against "
            f"{b['peak_above_resident_gib']:.3f} GiB above the resident "
            f"[{card}]")
    bar = max(dist.values())
    log(f"phase 12 {tag}: chunked-vs-dense first-token logit distance (max "
        f"|a - b| over max |b|) " + ", ".join(
            f"{k} {v:.4g}" for k, v in dist.items()) + f" [{card}]")
    prompts = [p for part in parts for p, _, _ in part]
    want = [s for part in PREFIX_PARTS if part in off
            for s in off[part]["streams"]]
    res["distance"] = dist
    res["diffs"] = {}
    for name, _ in engines[:-1]:
        got = [s for part in PREFIX_PARTS if part in res[name]
               for s in res[name][part]["streams"]]
        res["diffs"][name] = judge_streams(model, dev, prompts, got, want,
                                           bar, f"{tag} {name}", card)
        log(f"phase 12 {tag} {name}: {len(got) - len(res['diffs'][name])} "
            f"of {len(got)} greedy streams equal to the off engine's [{card}]")
    for r in (res[name] for name, _ in engines):
        for k in ("first_logits", "lone_logits"):
            r.pop(k, None)
    res["launches"] = {}
    for name, _ in engines:
        for k, n in res[name]["launches"].items():
            res["launches"][k] = res["launches"].get(k, 0) + n
    if not big:
        res["faults"] = prefix_faults(model, system, rng, seed, dev, card)
    return res


def prefix_serving(seed, card, then=None):
    """Phase 12: each cell in a process of its own (its launches inside the
    captured programs come from profiled replays), started while the one
    before runs."""
    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    io = phase_dir("12")
    for cell, nxt in next_cells("12", PREFIX_CELLS, then):
        rc, secs = run_child("12", cell, seed, 900, nxt)
        check(rc == 0, f"phase 12 ({cell}) failed: exit {rc}")
        with open(os.path.join(io, f"{cell}.json")) as f:
            res[cell] = json.load(f)
        res[cell]["process_s"] = secs
        log(f"phase 12 {cell}: process {secs:.1f} s from its go, "
            f"launches {res[cell]['launches']} [{card}]")
    return res


# ---------------------------------------------------------------------------
# phase 13: speculative decoding (the draft and the verify as CUDA graphs)
# ---------------------------------------------------------------------------

SPEC_WINDOW = 4      # spec_decode of the speculative engines
DRAFT_LAYERS = 2     # the separate draft model: LLaMA-2-7B widths, 2 layers
FULL_ACCEPTANCE = 0.9  # the full-depth draft's acceptance at least
# the target as its own draft model runs in a process of its own: beside
# the 7B cell's engines its process outgrew what the profiler records
# whole (a dropped device record, twice, in the last profiled program)
SPEC_CELLS = ("7b", "7b_target_draft", "13b_int8")
SPEC_KERNELS = (("paged_attention", "paged_decode_kernel"),
                ("rms_norm", "rms_norm_fwd"),
                ("quant_matmul_decode", "skinny_kernel"),
                ("quant_matmul_prefill", "qmm_wgmma_kernel"),
                ("split_sum", "split_sum_kernel"))


def greedy(requests):
    """The requests with their sampling arguments dropped: a sampling row in
    the batch sends the whole round to the classic path."""
    return [(p, n, {}) for p, n, _ in requests]


def verify_distance(model, prompts, window, dev, kv):
    """The verify-vs-decode logit distance of one window at the engine's
    geometry (one row a prompt, 8 rows: the decode's linears then run at
    m = 8 and the verify's at m = 8 * window, as in the engine): each
    prompt's K/V in fresh pages of its row, its first token from its
    prefill, `window` single-token decode steps (the decode kernel at
    context lens + 1), each feeding the last one's greedy tokens, then the
    verify's forward over the same windows on the same pages
    (`window_rows`, the decode rows clamped to each row's limit). Returns
    (max |verify - decode| over max |decode| of the row with the largest,
    row 0's window)."""
    cfg = model.config
    kvh = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
    hd = cfg.hidden_size // cfg.num_attention_heads
    page = 16
    b = len(prompts)
    lens = [len(p) for p in prompts]
    width = max(-(-(n + window) // page) for n in lens)
    dtype = torch.int8 if kv else next(model.parameters()).dtype
    pools = []
    for _ in range(cfg.num_hidden_layers):
        kp, vp = kpa.alloc_pages(b * width + 1, page, kvh, hd, dtype, dev)
        sc = kpa.alloc_page_scales(b * width + 1, page, kvh, dev) if kv \
            else ()
        pools.append((kp, vp, *sc))
    tables = torch.arange(b * width, dtype=torch.int32,
                          device=dev).reshape(b, width)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    with torch.no_grad():
        first = []
        for r, prompt in enumerate(prompts):
            logits, caches = model.forward_cached(
                torch.from_numpy(prompt)[None].to(dev),
                model.init_kv_caches(1, lens[r]), 0)
            tserving.ServingEngine._write_prompts(
                pools, caches, tables[r:r + 1],
                torch.tensor([lens[r]], dtype=torch.int32), 1)
            first.append(logits[0, -1].float().argmax())
            del caches
        tok = torch.stack(first)
        win, dec = [], []
        for j in range(window):
            win.append(tok)
            lg, _ = model.forward_paged(tok[:, None], pools, tables,
                                        lens_t + j)
            dec.append(lg[:, 0].float())
            tok = lg[:, 0].float().argmax(dim=-1)
        ver, _ = model.forward_paged(
            torch.stack(win, dim=1), pools, tables, lens_t,
            active=torch.ones(b, dtype=torch.bool, device=dev),
            scratch_page=b * width, limit_lens=lens_t + window,
            window_rows=True)
    dec = torch.stack(dec, dim=1)  # [b, window, vocab]
    dist = ((ver.float() - dec).abs().amax(dim=(1, 2))
            / dec.abs().amax(dim=(1, 2)))
    del pools
    return float(dist.max()), torch.stack(win, dim=1)[0].tolist()


def spec_engine(model, seed, dev, kv, max_seq_len=4096, **kw):
    """An engine of phase 13 (phase 11's: decode_burst 8), warmed: a spec
    engine's draft and verify graphs (and the single-step graph the last
    tokens take) captured before traffic."""
    eng = ServingEngine(model, max_batch=8, max_seq_len=max_seq_len,
                        page_size=16, seed=seed, device=dev,
                        kv_cache_quant=kv, decode_burst=BURST, **kw)
    secs = eng.warmup()
    if eng.spec_decode:
        n_scan = eng.spec_decode - (eng._draft_model is None)
        check(set(eng._spec_draft_fns) == {n_scan}
              and set(eng._spec_verify_fns) == {eng.spec_decode},
              f"warmup built draft programs {sorted(eng._spec_draft_fns)} "
              f"and verify programs {sorted(eng._spec_verify_fns)}")
    check(eng.graph_captures == len(eng._burst_fns) + len(
        eng._spec_draft_fns) + len(eng._spec_verify_fns),
          f"warmup captured {eng.graph_captures} graphs")
    return eng, secs


def spec_shape(eng):
    """(scan length, draft depth, target depth) of a spec engine's round."""
    L = eng.cfg.num_hidden_layers
    if eng._draft_model is not None:
        return eng.spec_decode, eng._draft_model.config.num_hidden_layers, L
    return eng.spec_decode - 1, eng.spec_draft_layers, L


class SpecCounts:
    """What an engine ran from a mark on: prefills, classic token steps,
    spec rounds, proposed and accepted drafts, and the wrappers' launches
    (eager prefills and chunk rounds; a graph replay bypasses them)."""

    def __init__(self, eng):
        self.eng = eng
        self.start = self.now()

    def now(self):
        e = self.eng
        return dict(prefills=e.prefills, steps=e.decode_steps,
                    rounds=e.spec_rounds, proposed=e._spec_proposed_total,
                    accepted=e._spec_accepted_total,
                    rms=krms.launches, paged=kpa.launches + kpa.q8_launches,
                    qdec=kqm.kernel_launches["decode"],
                    qpre=kqm.kernel_launches["prefill"],
                    split=kqm.kernel_launches["split"])

    def delta(self):
        now = self.now()
        return {k: now[k] - self.start[k] for k in now}

    def want(self):
        """The launches the device must have run since the mark: the eager
        ones as the wrappers counted them, plus a single-step program's
        kernels per classic token step and a draft's and a verify's per
        spec round (`program_want`)."""
        d = self.delta()
        eng = self.eng
        want = dict(paged_attention=d["paged"], rms_norm=d["rms"])
        if eng.kv_cache_quant == "int8":
            want.update(quant_matmul_decode=d["qdec"],
                        quant_matmul_prefill=d["qpre"], split_sum=d["split"])
        parts = [(d["steps"], program_want(eng, "burst", (True, 1)))]
        if eng.spec_decode:
            n = spec_shape(eng)[0]
            parts += [(d["rounds"], program_want(eng, "draft", n)),
                      (d["rounds"], program_want(eng, "verify",
                                                 eng.spec_decode))]
        for times, per in parts:
            for name in want:
                want[name] += times * per[name]
        return want


def spec_launches(events, quant):
    names = [k for k in SPEC_KERNELS if quant or not k[0].startswith(
        ("quant", "split"))]
    return {name: count_kernels(events, part) for name, part in names}


def library_attention(events):
    """Names of attention kernels that are not the port's paged decode."""
    return sorted({e.name[:60] for e in events
                   if "paged_decode_kernel" not in e.name and any(
                       w in e.name.lower()
                       for w in ("fmha", "flash", "sdpa", "attention"))})


def program_want(eng, kind, key):
    """The kernels one replay of a captured program holds: a (greedy, k)
    burst k forwards of the target (L paged decodes, `rms_per_forward`
    RMSNorms, 7L dequant decode kernels each), a draft of n steps n forwards of the
    draft depth Ld, a verify one forward of the target over window *
    batch rows (its dequant linears at m > 16: the prefill kernel)."""
    quant = eng.kv_cache_quant == "int8"
    L = eng.cfg.num_hidden_layers
    if kind == "verify":
        steps, depth, dec, pre = 1, L, 0, 7 * L
    elif kind == "draft":
        steps, depth = key, spec_shape(eng)[1]
        dec, pre = 7 * depth * key, 0
    else:
        steps, depth, dec, pre = key[1], L, 7 * L * key[1], 0
    want = dict(paged_attention=steps * depth,
                rms_norm=steps * rms_per_forward(eng.cfg, depth))
    if quant:
        want.update(quant_matmul_decode=dec, quant_matmul_prefill=pre,
                    split_sum=0)
    return want


def program_kernels(eng, tag, card):
    """The kernels each captured program of the engine holds, from the
    profiler's records of one replay of it with every row inactive (it
    writes only the scratch page), exact against `program_want`, with no
    library attention; then each program's replays are counted. Returns
    ({(kind, key): {kernel: n}}, {(kind, key): replays})."""
    quant = eng.kv_cache_quant == "int8"
    per, replays = {}, {}
    for kind, fns in (("burst", eng._burst_fns),
                      ("draft", eng._spec_draft_fns),
                      ("verify", eng._spec_verify_fns)):
        for key, fn in list(fns.items()):
            def run(_fn=fn, _kind=kind, _key=key):
                eng._buf.idle()
                _, _, events = profiled(_fn)
                check(not library_attention(events), f"{tag}: library "
                      f"attention in {_kind} {_key}: "
                      f"{library_attention(events)}")
                return None, spec_launches(events, quant), program_want(
                    eng, _kind, _key)

            _, per[(kind, key)] = counted(f"{tag} {kind} {key}", run, card,
                                          13)

            def counting(_fn=fn, _k=(kind, key)):
                replays[_k] = replays.get(_k, 0) + 1
                _fn()

            fns[key] = counting
    return per, replays


def spec_traffic_run(eng, requests, tag, card, holds=None, phase=13):
    """`requests` through the engine (one part after the other, each part
    together, the page holds after every finish with `holds`): the
    streams, tokens/s, what ran, and the launches: the wrappers' counts
    (prefills and chunk rounds run eagerly) plus each program's replays
    times the kernels a profiled replay of it holds (`program_kernels`).
    No graph captured, no window gathered but in chunk rounds, no token
    emitted past a finish."""
    quant = eng.kv_cache_quant == "int8"
    per, replays = program_kernels(eng, tag, card)
    gathers = [0]
    real_window = kpa.paged_attention_window

    def counting(*a, **kw):
        gathers[0] += 1
        return real_window(*a, **kw)

    counts = SpecCounts(eng)
    c0, r0 = eng.graph_captures, eng.graph_replays
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kpa.paged_attention_window = counting
    t0 = time.perf_counter()
    try:
        out = [drive(eng, requests)] if holds is None else [
            drive_held(eng, part, holds) for part in requests]
    finally:
        kpa.paged_attention_window = real_window
    wall = time.perf_counter() - t0
    check(eng.graph_captures == c0, f"{tag}: "
          f"{eng.graph_captures - c0} graphs captured during traffic")
    check(sum(replays.values()) == eng.graph_replays - r0 > 0,
          f"{tag}: {sum(replays.values())} counted replays of "
          f"{eng.graph_replays - r0}")
    d = counts.delta()
    launches = dict(paged_attention=d["paged"], rms_norm=d["rms"])
    if quant:
        launches.update(quant_matmul_decode=d["qdec"],
                        quant_matmul_prefill=d["qpre"], split_sum=d["split"])
    for k, n in replays.items():
        for name in launches:
            launches[name] += n * per[k][name]
    check(launches == counts.want(), f"{tag}: launches {launches}, "
          f"expected {counts.want()}")
    check(eng.discarded_tokens == 0,
          f"{tag}: {eng.discarded_tokens} tokens emitted past a finish")
    if eng.spec_decode and not eng.prefill_chunk:
        check(gathers[0] == 0 and not eng.chunk_rounds,
              f"{tag}: {gathers[0]} gathered windows")
    streams = [s for part in out for s in part["streams"]]
    tokens = sum(len(s) for s in streams)
    res = dict(streams=streams, wall_s=wall, tokens=tokens,
               tokens_per_s=tokens / wall, counts=d,
               acceptance=d["accepted"] / d["proposed"]
               if d["proposed"] else None,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               window_gathers=gathers[0], launches=launches,
               replays={f"{kind}_{key}": n
                        for (kind, key), n in replays.items()})
    acc = "n/a" if res["acceptance"] is None else f"{res['acceptance']:.3f}"
    log(f"phase {phase} {tag}: {len(streams)} requests, {tokens} tokens in "
        f"{wall:.2f} s ({res['tokens_per_s']:.1f} tok/s); {d['rounds']} "
        f"spec rounds, proposed {d['proposed']}, accepted {d['accepted']} "
        f"(acceptance {acc}); {d['steps']} classic token steps, "
        f"{d['prefills']} prefills; peak {res['peak_gib']:.2f} GiB; "
        f"launches {launches} ({res['replays']} replays) [{card}]")
    return res


def marked(fn):
    """fn behind a `spin_kernel` of the device: the profiler's records of
    a round then split at these markers."""
    def run():
        torch.cuda._sleep(1)
        fn()
    return run


def split_round_events(events):
    """Device ms of the draft replays, the verify replays and the copies,
    from records whose draft and verify replays each follow a
    `spin_kernel` (`marked`)."""
    out = dict(draft=0.0, verify=0.0, copies=0.0, other=0.0)
    part = "other"
    for e in sorted(events, key=lambda e: e.time_range.start):
        us = e.time_range.elapsed_us()
        if "spin_kernel" in e.name:
            part = "verify" if part == "draft" else "draft"
        elif e.name.startswith(("Memcpy", "Memset")):
            out["copies"] += us / 1e3
        else:
            out[part] += us / 1e3
    return out


def profile_spec(eng, rng, card, tag, rounds=3):
    """A window of `rounds` speculative rounds at batch 8, contexts ~1000,
    under the profiler (each draft and verify replay behind a marker):
    per round the device ms of the draft and of the verify replay, the
    round's wall ms, the idle share; per committed token the device and
    wall ms; the launches in the window, exact. Then as many rounds with
    the profiler off: wall ms per committed token."""
    w = eng.spec_decode
    n = spec_shape(eng)[0]
    quant = eng.kv_cache_quant == "int8"

    def committed():
        return sum(len(s.tokens) for s in eng.slots if s.active)

    def window():
        t0, r0 = committed(), eng.spec_rounds
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        check(eng.spec_rounds - r0 == rounds and
              sum(s.active for s in eng.slots) == eng.max_batch,
              f"{tag}: {eng.spec_rounds - r0} rounds in the window")
        return committed() - t0

    def run():
        for _ in range(eng.max_batch):
            eng.add_request(rng.randint(0, eng.cfg.vocab_size, 1000),
                            max_new_tokens=w * (2 * rounds + 2) + 2)
        eng.step()  # admission, batched prefill, first tokens, a round
        fns = dict(eng._spec_draft_fns), dict(eng._spec_verify_fns)
        eng._spec_draft_fns.update({k: marked(f)
                                    for k, f in fns[0].items()})
        eng._spec_verify_fns.update({k: marked(f)
                                     for k, f in fns[1].items()})
        try:
            tokens, wall, events = profiled(window)
        finally:
            eng._spec_draft_fns.update(fns[0])
            eng._spec_verify_fns.update(fns[1])
        t1 = time.perf_counter()
        tokens2 = window()
        wall2 = time.perf_counter() - t1
        eng.run()
        draft, verify = (program_want(eng, "draft", n),
                         program_want(eng, "verify", w))
        want = {k: rounds * (draft[k] + verify[k]) for k in draft}
        return (tokens, wall, events, tokens2, wall2), \
            spec_launches(events, quant), want

    (tokens, wall, events, tokens2, wall2), launches = counted(
        f"{tag} window", run, card, 13)
    parts = split_round_events(events)
    busy = sum(e.time_range.elapsed_us() for e in events
               if "spin_kernel" not in e.name) / 1e3
    res = dict(rounds=rounds, committed_tokens=tokens,
               draft_ms_per_round=parts["draft"] / rounds,
               verify_ms_per_round=parts["verify"] / rounds,
               copies_ms_per_round=parts["copies"] / rounds,
               round_wall_ms=wall * 1e3 / rounds,
               idle_share=1.0 - busy / (wall * 1e3),
               device_ms_per_token=busy / tokens,
               wall_ms_per_token=wall * 1e3 / tokens,
               unprofiled_wall_ms_per_token=wall2 * 1e3 / tokens2,
               unprofiled_committed_tokens=tokens2, launches=launches)
    log(f"phase 13 {tag}: batch-8 spec rounds at context ~1000: per round "
        f"draft {res['draft_ms_per_round']:.3f} ms + verify "
        f"{res['verify_ms_per_round']:.3f} ms of device time (copies "
        f"{res['copies_ms_per_round']:.3f}), {res['round_wall_ms']:.3f} ms "
        f"wall, idle share {res['idle_share']:.3f}; {tokens} tokens "
        f"committed in {rounds} rounds: {res['device_ms_per_token']:.3f} ms "
        f"device, {res['wall_ms_per_token']:.3f} ms wall "
        f"({res['unprofiled_wall_ms_per_token']:.3f} unprofiled, "
        f"{tokens2} tokens) per committed token; launches {launches} "
        f"[{card}]")
    return res


def accept_at_mismatch(eng):
    """Planted fault 1: the commit also accepts the draft at the first
    mismatch (the target's corrected token is replaced by the draft).
    Returns its undo."""
    real = eng._commit_spec

    def commit(drafts, g, active, window):
        g = g.copy()
        for i in active:
            for j in range(1, window):
                if drafts[j - 1, i] != g[i, j - 1]:
                    g[i, j - 1] = drafts[j - 1, i]
                    break
        return real(drafts, g, active, window)

    eng._commit_spec = commit
    return lambda: delattr(eng, "_commit_spec")


def without_position_limit(_eng):
    """Planted fault 2: the verify's decode rows from
    `rows_without_position_limit`. Returns its undo."""
    real = kpa.window_rows
    kpa.window_rows = rows_without_position_limit

    def undo():
        kpa.window_rows = real
    return undo


def rows_without_position_limit(block_tables, context_lens, s,
                                limit_lens=None, active=None):
    """Planted fault 2: `window_rows` whose window positions all attend
    up to lens + window (the per-position causal limit gone; still clamped
    to the row's limit, so that a row reads only its own pages)."""
    dev = block_tables.device
    ctx = (context_lens.to(dev, torch.int32) + s)[:, None].expand(-1, s)
    if limit_lens is not None:
        ctx = torch.minimum(ctx, limit_lens.to(dev, torch.int32)[:, None])
    if active is not None:
        ctx = ctx * active.to(dev)[:, None]
    return (block_tables.repeat_interleave(s, dim=0),
            ctx.reshape(-1).to(torch.int32).contiguous())


def skip_draft_prefill(eng):
    """Planted fault 3: a prefill that writes the prompts into the
    target's pools but not into the draft model's. Returns its undo."""
    real = eng._write_prompts
    eng._write_prompts = lambda pools, *a: None \
        if pools is eng._draft_caches else real(pools, *a)
    return lambda: delattr(eng, "_write_prompts")


def no_extra_draft_step(eng):
    """Planted fault 4: a draft model's scan of window - 1 steps, as
    shallow exit's (the last draft's K/V never reaches its pools). Returns
    its undo."""
    real = eng._get_spec_draft_fn
    eng._get_spec_draft_fn = lambda n: real(n - 1)
    return lambda: delattr(eng, "_get_spec_draft_fn")


def fault_requests(rng, vocab):
    """The planted faults' requests: 4 short greedy prompts (8 tokens) with
    24 new tokens each, where a window position's attention over 3 extra
    tokens moves its output far more than over a long context."""
    return [(rng.randint(0, vocab, 8), 24, {}) for _ in range(4)]


def spec_fault_caught(run, what):
    """run() must fail a hold of phase 13 (a stream or the acceptance):
    the hold's message."""
    try:
        run()
    except AssertionError as e:
        msg = str(e)
        check("differs at token" in msg or "acceptance" in msg,
              f"planted fault ({what}) failed elsewhere: {msg}")
        return msg
    raise AssertionError(f"planted fault ({what}): the holds did not catch "
                         f"it")


def spec_cell(cell, seed, dev, card):
    """One phase-13 cell in a process of its own. 7b: LLaMA-2-7B's widths
    at `CELL7_LAYERS` layers, bf16 from `seed`, through phase 11's engine
    (decode_burst 8): off (the burst graphs alone), shallow (spec_decode 4,
    the default half-depth draft), full depth (the target's own decode),
    a 2-layer draft model at the same widths (weights from seed + 1), each
    over phase 4's 10 requests made greedy and a profiled window; then the
    shallow engine with the prefix cache and chunks of 512 over phase 12's
    first 4 shared-prompt requests against the off engine, the page holds
    after every finished request. 7b_target_draft: the same model, off and
    the target as its own draft model (over pools of its own). The
    full-depth and target-draft engines accept at least FULL_ACCEPTANCE;
    the planted faults of `PLANTS` run on their engines. 13b_int8: LLaMA-2-13B
    (`init_default`, int8 weights but lm_head, int8 KV), off and shallow
    over the first 4 requests. Every spec engine's greedy streams equal
    the off engine's or differ first at a near tie (the off engine's top-2
    gap within the verify-vs-decode distance times its largest
    |logit|)."""
    big = cell == "13b_int8"
    cfg = llama13b_cut(CELL13_LAYERS) if big else llama7b_cell()
    cfg.dtype = "bfloat16"
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    kv = None
    if big:
        init_default(model, seed, dev)
        quantize_for_inference(model, "weight_only_int8", -1,
                               exclude=("lm_head",))
        kv = "int8"
        gc.collect()
        torch.cuda.empty_cache()
    stage(cell, "model built")
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(seed)
    _long, batch = traffic(rng, cfg.vocab_size)
    requests = greedy(batch[:4] if big else batch)
    prompts = [p for p, _, _ in requests]
    faults = fault_requests(np.random.RandomState(seed + 13), cfg.vocab_size)
    tag = "13B int8" if big else "7B"
    dist, window = verify_distance(
        model, [p for p, _, _ in batch[:8]], SPEC_WINDOW, dev, kv)
    log(f"phase 13 {tag}: verify-vs-decode logit distance of the first "
        f"window of 8 rows (request 0's tokens {window}): {dist:.4g} "
        f"[{card}]")
    res = dict(card=card, layers=L, distance=dist, engines={}, faults={})
    engines = [("off", {}), ("shallow", dict(spec_decode=SPEC_WINDOW))]
    if cell == "7b_target_draft":
        engines[1] = ("target_draft", dict(spec_decode=SPEC_WINDOW,
                                           draft_model=model))
    if cell == "7b":
        dcfg = LlamaConfig.llama2_7b()
        dcfg.dtype = "bfloat16"
        dcfg.num_hidden_layers = DRAFT_LAYERS
        engines += [("full_depth", dict(spec_decode=SPEC_WINDOW,
                                        spec_draft_layers=L)),
                    ("draft_model", dict(
                        spec_decode=SPEC_WINDOW,
                        draft_model=LlamaForCausalLM(dcfg, device=dev,
                                                     seed=seed + 1)))]
    want = fault_want = None
    for name, kw in engines:
        t0 = time.perf_counter()
        eng, secs = spec_engine(model, seed, dev, kv, **kw)
        r = spec_traffic_run(eng, requests, f"{tag} {name}", card)
        r.update(warmup_s=secs, captures=eng.graph_captures)
        if name == "off":
            want = r["streams"]
            if cell != "7b_target_draft":  # the 7B cell's profiles it
                r["profile"] = profile_burst(eng, rng, card, f"{tag} off",
                                             quant=big, phase=13)
            if not big:
                fault_want = drive(eng, faults)["streams"]
        else:
            r["diffs"] = judge_streams(model, dev, prompts, r["streams"],
                                       want, dist, f"{tag} {name}", card,
                                       phase=13)
            r["profile"] = profile_spec(eng, rng, card, f"{tag} {name}")
        if name in ("full_depth", "target_draft"):
            check(r["acceptance"] >= FULL_ACCEPTANCE,
                  f"{tag} {name}: acceptance {r['acceptance']:.3f} "
                  f"below {FULL_ACCEPTANCE}")
        for fault, plant, least in ([] if big else PLANTS.get(name, [])):
            res["faults"][fault] = spec_fault(
                model, dev, eng, faults, fault_want, dist, tag, card, fault,
                plant, min_acceptance=least)
        r.pop("streams")
        res["engines"][name] = r
        log(f"phase 13 {tag} {name}: {len(requests) - len(r.get('diffs', []))}"
            f" of {len(requests)} greedy streams equal to the off engine's; "
            f"warmup {secs:.2f} s ({eng.graph_captures} graphs), engine "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        del eng
        kw.pop("draft_model", None)
        gc.collect()
        torch.cuda.empty_cache()
    if cell == "7b":
        res["engines"]["prefix"] = spec_prefix_run(model, seed, dev, dist,
                                                   tag, card)
    res["launches"] = {}
    for r in res["engines"].values():
        for part in (r["launches"], r.get("profile", {}).get("launches",
                                                             {})):
            for k, n in part.items():
                res["launches"][k] = res["launches"].get(k, 0) + n
    return res


# the planted faults of phase 13 by the engine they run on: (name, plant,
# the acceptance the run must keep or None: the streams' hold alone)
PLANTS = dict(
    shallow=[("accept_at_mismatch", accept_at_mismatch, None)],
    full_depth=[("no_position_limit", without_position_limit,
                 FULL_ACCEPTANCE)],
    target_draft=[("no_draft_prefill", skip_draft_prefill, FULL_ACCEPTANCE),
                  ("no_extra_draft_step", no_extra_draft_step,
                   FULL_ACCEPTANCE)])


def spec_fault(model, dev, eng, faults, want, dist, tag, card, name, plant,
               min_acceptance=None):
    """A planted fault on `eng`, over the faults' short requests against
    the off engine's streams for them: a sound run first (the holds must
    pass), then `plant(eng)` (returning its undo), every program captured
    anew, and a run that must fail the streams' hold or, with
    `min_acceptance`, the acceptance's. Returns the hold's message."""
    prompts = [p for p, _, _ in faults]

    def serve(what):
        p0, a0 = eng._spec_proposed_total, eng._spec_accepted_total
        got = drive(eng, faults)["streams"]
        acc = (eng._spec_accepted_total - a0) / max(
            eng._spec_proposed_total - p0, 1)
        log(f"phase 13 {tag} fault '{name}' ({what}): acceptance "
            f"{acc:.3f} [{card}]")
        judge_streams(model, dev, prompts, got, want, dist,
                      f"{tag} fault {name} ({what})", card, phase=13)
        if min_acceptance is not None:
            check(acc >= min_acceptance, f"{tag} fault {name} ({what}): "
                  f"acceptance {acc:.3f} below {min_acceptance}")

    serve("sound")
    undo = plant(eng)
    eng._spec_draft_fns.clear()
    eng._spec_verify_fns.clear()
    try:
        msg = spec_fault_caught(lambda: serve("planted"), name)
    finally:
        undo()
        eng._spec_draft_fns.clear()
        eng._spec_verify_fns.clear()
    log(f"phase 13 {tag} fault '{name}': caught: {msg} [{card}]")
    return msg


def spec_prefix_run(model, seed, dev, dist, tag, card):
    """The shallow spec engine with `prefix_cache=1, prefill_chunk=512`
    over phase 12's first 4 shared-prompt requests (the first alone, then
    3 together), the page holds after every finished request, against the
    off engine over the same parts; the near-tie bar is the larger of the
    verify-vs-decode distance and the first request's chunked-vs-dense
    first-token distance (phase 12's)."""
    rng = np.random.RandomState(seed + 12)
    _system, parts = prefix_traffic(rng, model.config.vocab_size)
    parts = [greedy(parts[0]), greedy(parts[1][:3])]
    prompts = [p for part in parts for p, _, _ in part]
    out, first = {}, {}
    for name, kw in (("off", {}), ("shallow_cache_chunk", dict(
            spec_decode=SPEC_WINDOW, prefix_cache=1, prefill_chunk=CHUNK))):
        eng, secs = spec_engine(model, seed, dev, None, **kw)
        holds = PageHolds(eng)
        seen = first_token_logits(eng)
        r = spec_traffic_run(eng, parts, f"{tag} prefix {name}", card,
                             holds=holds)
        # the first request's first token: its dense prefill, or the last
        # of its chunk rounds (it runs alone, with no hit)
        rounds0 = -(-len(prompts[0]) // CHUNK) if eng.prefill_chunk else 1
        first[name] = seen[rounds0 - 1][0]
        del eng._sample
        r.update(warmup_s=secs, holds_checked=holds.checks,
                 hits=eng._prefix_hits_total,
                 chunk_rounds=eng.chunk_rounds)
        out[name] = r
        del eng, holds, seen
        gc.collect()
        torch.cuda.empty_cache()
    spec = out["shallow_cache_chunk"]
    check(spec["hits"] > 0 and spec["chunk_rounds"] > 0,
          f"{tag} prefix: {spec['hits']} hit tokens, "
          f"{spec['chunk_rounds']} chunk rounds")
    spec["chunk_distance"] = logit_distance(first["shallow_cache_chunk"],
                                            first["off"])
    bar = max(dist, spec["chunk_distance"])
    log(f"phase 13 {tag} prefix: chunked-vs-dense first-token logit "
        f"distance {spec['chunk_distance']:.4g}, verify-vs-decode "
        f"{dist:.4g} [{card}]")
    spec["diffs"] = judge_streams(model, dev, prompts, spec.pop("streams"),
                                  out["off"].pop("streams"), bar,
                                  f"{tag} prefix", card, phase=13)
    log(f"phase 13 {tag} prefix: shallow spec with the prefix cache and "
        f"chunks of {CHUNK}: {len(prompts) - len(spec['diffs'])} of "
        f"{len(prompts)} streams equal to the off engine's; hit "
        f"{spec['hits']} tokens, {spec['chunk_rounds']} chunk rounds, holds "
        f"checked {spec['holds_checked']} times [{card}]")
    launches = {}
    for r in out.values():
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
    return out


def spec_serving(seed, card, then=None):
    """Phase 13: each cell in a process of its own (its launches inside the
    captured programs come from the profiler's device records), started
    while the one before runs."""
    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    io = phase_dir("13")
    for cell, nxt in next_cells("13", SPEC_CELLS, then):
        rc, secs = run_child("13", cell, seed, 600, nxt)
        check(rc == 0, f"phase 13 ({cell}) failed: exit {rc}")
        with open(os.path.join(io, f"{cell}.json")) as f:
            res[cell] = json.load(f)
        res[cell]["process_s"] = secs
        log(f"phase 13 {cell}: process {secs:.1f} s from its go, "
            f"launches {res[cell]['launches']} [{card}]")
    return res


# ---------------------------------------------------------------------------
# phase 14: the GPT family: GPT-3 1.3B served, trained and run as
# FusedMultiTransformer, and a tiny GPT on CUDA against the CPU
# ---------------------------------------------------------------------------

# fmt and tiny in one process: each works 3-7 s, less than a process
# takes to start (16-18 s on the H100, PERF.md §6); neither profiles
GPT_CELLS = ("serve", "train", "fmt_tiny")
GPT_SEQ = 2048         # GPT-3 1.3B's positions: the serving engine's max
GPT_LONG = 1500        # the lone prompt's tokens (64 new)
GPT_DRAFT_LAYERS = 12  # the shallow-exit draft: 12 of 24 layers


def gpt_flops_per_token(cfg, seq_len):
    """GPT's model FLOPs a trained token: 6 (L (4h^2 + 2 h inter) + v h)
    (QKV and out projections, the two-matrix MLP, the head) plus the
    causal attention term 12 s h L / 2. `model_flops_per_token` prices
    LLaMA's three-matrix MLP (3 h inter)."""
    h, L = cfg.hidden_size, cfg.num_hidden_layers
    dense = L * (4 * h * h + 2 * h * cfg.intermediate_size) \
        + cfg.vocab_size * h
    return 6 * dense + 12 * seq_len * h * L // 2


def gpt_model(seed, dev, layers=None):
    cfg = GPTConfig.gpt3_1p3b()
    cfg.dtype = "bfloat16"
    if layers is not None:
        cfg.num_hidden_layers = layers
    return GPTForCausalLM(cfg, device=dev, seed=seed)


def ignore_context_positions(model):
    """Planted fault: `forward_paged` embeds positions 0..s-1 whatever the
    rows' context lengths (the per-row offset dropped). Returns its undo."""
    gpt = model.gpt
    gpt._positions = lambda pos: (pos - pos[..., :1]).clamp(
        max=gpt.config.max_position_embeddings - 1)
    return lambda: delattr(gpt, "_positions")


def gpt_burst_traffic(eng, requests, want, dist, model, dev, tag, card):
    """`requests` through a warmed burst engine under the profiler: the
    launches inside the graphs exact from its records (L paged decodes a
    token step, no RMSNorm), nothing captured, every greedy stream equal
    to `want` (the eager engine's) or differing first at a near tie
    (`judge_streams` with bar `dist`)."""
    c0 = eng.graph_captures

    def run():
        p0, d0 = eng.prefills, eng.decode_steps
        out, _, events = profiled(lambda: drive(eng, requests))
        steps = eng.decode_steps - d0
        return (out, *graph_launches(events, eng.cfg, steps,
                                     eng.prefills - p0 + steps, False))

    out, launches = counted(f"{tag} traffic", run, card, 14)
    check(eng.graph_captures == c0 and eng.discarded_tokens == 0,
          f"{tag}: {eng.graph_captures - c0} captures during traffic, "
          f"{eng.discarded_tokens} tokens past a finish")
    idx = [i for i, (_, _, kw) in enumerate(requests) if not kw]
    out["diffs"] = judge_streams(
        model, dev, [requests[i][0] for i in idx],
        [out["streams"][i] for i in idx], [want[i] for i in idx], dist, tag,
        card, phase=14)
    out["launches"] = launches
    return out


def gpt_serve_cell(seed, dev, card):
    """Phase 14 (a): GPT-3 1.3B (24 layers, hidden 2048, 16 heads of 128,
    vocab 50304, tied head; bf16, weights from `seed`) through the paged
    engine at max_batch 8, max_seq_len 2048, page 16. The eager engine
    (decode_burst 1) serves a lone 1500-token prompt (64 new), then phase
    4's 10 requests (greedy and sampled); the burst engine (decode_burst
    8, graphs captured by `warmup`) the same traffic under the profiler
    (24 paged decodes a token step inside the graphs), its greedy streams
    held to the eager engine's (equal, or differing first at a near tie
    under the verify-vs-decode bar), then a profiled window of 3 bursts
    at batch 8 and context ~1000; a planted fault (positions that ignore
    `context_lens`) must break the stream hold of the 10 requests made
    greedy; then those requests through the off engine (the burst graphs
    alone; held to the eager engine's streams) and the shallow-exit spec
    engine (spec_decode 4, 12 of 24 layers), held to the off engine's."""
    model = gpt_model(seed, dev)
    cfg = model.config
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(seed)
    _long, batch = traffic(rng, cfg.vocab_size)  # phase 4's shapes
    lone = [(rng.randint(0, cfg.vocab_size, GPT_LONG), 64, {})]
    requests = greedy(batch)
    prompts = [p for p, _, _ in requests]
    tag = "GPT-3 1.3B"
    res = dict(card=card, layers=L, params=sum(p.numel() for p in
                                               model.parameters()))
    dist, _ = verify_distance(model, [p for p, _, _ in batch[:8]],
                              SPEC_WINDOW, dev, None)
    res["distance"] = dist
    log(f"phase 14 {tag}: verify-vs-decode logit distance of the first "
        f"window of 8 rows: {dist:.4g} [{card}]")

    # the eager engine: the streams the others are held to
    eager = ServingEngine(model, max_batch=8, max_seq_len=GPT_SEQ,
                          page_size=16, seed=seed, device=dev)
    kpa.launches = kfa.fwd_launches = krms.launches = 0
    d0 = eager.decode_steps
    want_lone = drive(eager, lone)
    want_mixed = drive(eager, batch)
    want_greedy = drive(eager, requests)
    eager_launches = dict(paged_attention=kpa.launches,
                          flash_fwd=kfa.fwd_launches,
                          rms_norm=krms.launches)
    steps = eager.decode_steps - d0
    check(eager_launches == dict(paged_attention=L * steps, flash_fwd=0,
                                 rms_norm=0),
          f"{tag} eager: launches {eager_launches} for {steps} decode steps")
    res["eager"] = dict(lone_ttft_ms=want_lone["ttft_ms"][0],
                        tokens_per_s=want_mixed["tokens_per_s"],
                        ms_per_decode_step_p50=want_mixed[
                            "ms_per_decode_step_p50"],
                        launches=eager_launches, decode_steps=steps)
    log(f"phase 14 {tag} eager: lone {GPT_LONG}-token TTFT "
        f"{want_lone['ttft_ms'][0]:.1f} ms; 10 requests "
        f"{want_mixed['tokens_per_s']:.1f} tok/s, decode step p50 "
        f"{want_mixed['ms_per_decode_step_p50']:.3f} ms; launches "
        f"{eager_launches} [{card}]")
    del eager
    gc.collect()
    torch.cuda.empty_cache()

    # the burst engine: graphs captured by warmup
    torch.cuda.reset_peak_memory_stats()
    eng, secs = burst_engine(model, seed, dev, None, max_seq_len=GPT_SEQ)
    lone_r = gpt_burst_traffic(eng, lone, want_lone["streams"], dist, model,
                               dev, f"{tag} burst lone", card)
    mixed_r = gpt_burst_traffic(eng, batch, want_mixed["streams"], dist,
                                model, dev, f"{tag} burst mixed", card)
    prof = profile_burst(eng, rng, card, f"{tag} burst", phase=14)
    res["burst"] = dict(
        warmup_s=secs, captures=eng.graph_captures,
        replays=eng.graph_replays, lone_ttft_ms=lone_r["ttft_ms"][0],
        tokens_per_s=mixed_r["tokens_per_s"],
        diffs=lone_r["diffs"] + mixed_r["diffs"],
        launches={k: lone_r["launches"][k] + mixed_r["launches"][k]
                  + prof["launches"][k] for k in prof["launches"]},
        profile=prof, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    n_greedy = 1 + sum(1 for _, _, kw in batch if not kw)
    log(f"phase 14 {tag} burst: lone {GPT_LONG}-token TTFT "
        f"{lone_r['ttft_ms'][0]:.1f} ms (warm engine), 10 requests "
        f"{mixed_r['tokens_per_s']:.1f} tok/s; "
        f"{n_greedy - len(res['burst']['diffs'])} of {n_greedy} greedy "
        f"streams equal to the eager engine's, the others at near ties; "
        f"peak {res['burst']['peak_gib']:.2f} GiB; warmup {secs:.2f} s [{card}]")

    # planted fault: positions that ignore context_lens (the programs
    # captured anew with it): the 10 requests made greedy must break the
    # hold to the eager engine's streams
    undo = ignore_context_positions(model)
    eng._burst_fns.clear()
    eng.warmup(sampling=True)
    try:
        msg = spec_fault_caught(lambda: gpt_burst_traffic(
            eng, requests, want_greedy["streams"], dist, model, dev,
            f"{tag} fault", card), "positions without context_lens")
    finally:
        undo()
    res["fault_positions"] = msg
    log(f"phase 14 {tag} fault 'positions without context_lens': caught: "
        f"{msg} [{card}]")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # the off engine (burst graphs) over the same requests, held to the
    # eager engine's streams, then the shallow-exit spec engine against it
    eng, _ = spec_engine(model, seed, dev, None, max_seq_len=GPT_SEQ)
    off = spec_traffic_run(eng, requests, f"{tag} off", card, phase=14)
    off["diffs"] = judge_streams(model, dev, prompts, off["streams"],
                                 want_greedy["streams"], dist,
                                 f"{tag} off", card, phase=14)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    spec, secs = spec_engine(model, seed, dev, None, max_seq_len=GPT_SEQ,
                             spec_decode=SPEC_WINDOW,
                             spec_draft_layers=GPT_DRAFT_LAYERS)
    r = spec_traffic_run(spec, requests, f"{tag} shallow", card, phase=14)
    r["diffs"] = judge_streams(model, dev, prompts, r.pop("streams"),
                               off.pop("streams"), dist, f"{tag} shallow",
                               card, phase=14)
    r["warmup_s"] = secs
    res["spec"] = dict(off=off, shallow=r)
    log(f"phase 14 {tag} shallow ({GPT_DRAFT_LAYERS} of {L} layers): "
        f"{len(requests) - len(r['diffs'])} of {len(requests)} greedy "
        f"streams equal to the off engine's; acceptance "
        f"{r['acceptance']:.3f}; {r['tokens_per_s']:.1f} tok/s against "
        f"{off['tokens_per_s']:.1f} off [{card}]")
    res["launches"] = dict(paged_attention=eager_launches["paged_attention"]
                           + res["burst"]["launches"]["paged_attention"]
                           + off["launches"]["paged_attention"]
                           + r["launches"]["paged_attention"])
    return res


def gpt_train_cell(seed, dev, card, batch=4, seq=GPT_SEQ, steps=5):
    """Phase 14 (b): GPT-3 1.3B, all 24 layers, bf16 O2, AdamW(1e-4),
    batch 4 x 2048 random ids through build_train_step: one warm step,
    then 5 timed steps with the launches exact a step (flash forward and
    backward 24 each, the Adam kernel once a parameter tensor, RMSNorm
    none); losses finite and falling; tokens/s, step ms p50, peak memory
    and the model-FLOPs share by GPT's own count; one profiled step."""
    t0 = time.perf_counter()
    model = amp.decorate(gpt_model(seed, dev), level="O2", dtype="bfloat16")
    cfg = model.config
    L = cfg.num_hidden_layers
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = build_train_step(model, opt)
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq))).to(dev)
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq))).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 14 train: GPT-3 1.3B, {L} layers, {n_params / 1e9:.3f} B "
        f"bf16 parameters in {n_tensors} tensors, ready in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    losses = [step(x, y)]
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
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
    per_step = dict(flash_fwd=L, flash_bwd=L, rms_norm=0, rms_norm_bwd=0,
                    adam=n_tensors)
    for name, n in per_step.items():
        check(launches[name] == n * steps,
              f"phase 14 train: {name} launched {launches[name]} times in "
              f"{steps} steps, expected {n * steps}")
    check(all(math.isfinite(v) for v in losses),
          f"phase 14 train: loss {losses}")
    check(losses[-1] < losses[0], f"phase 14 train: loss did not fall: "
          f"{losses}")
    p50 = float(np.median(step_ms))
    tok_s = batch * seq / (p50 / 1e3)
    flops_tok = gpt_flops_per_token(cfg, seq)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    res = dict(card=card, layers=L, params=n_params, tensors=n_tensors,
               batch=batch, seq=seq, losses=losses, warm_step_ms=warm_ms,
               step_ms=step_ms, step_ms_p50=p50, tokens_per_s=tok_s,
               model_flops_per_token=flops_tok,
               mfu=tok_s * flops_tok / BF16_FLOP_S, launches=launches,
               max_memory_allocated_gib=peak_gib)
    log(f"phase 14 train: losses {', '.join(f'{v:.4f}' for v in losses)} "
        f"(warm step first)")
    log(f"phase 14 train: batch {batch} x {seq}: warm step {warm_ms:.1f} ms; "
        f"{steps} steps p50 {p50:.1f} ms (min {min(step_ms):.1f}, max "
        f"{max(step_ms):.1f}), {tok_s:.1f} tokens/s, model-FLOPs share "
        f"{res['mfu']:.4f} of 989 TFLOP/s bf16 ({flops_tok / 1e9:.3f} "
        f"GFLOP a token); peak {peak_gib:.2f} GiB; launches {launches} "
        f"[{card}]")

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
    top = sorted(dev_a.items(), key=lambda kv: -kv[1])[:8]
    wall, busy = wall_a + wall_b, busy_a + busy_b
    res["profile"] = dict(
        wall_ms=wall, device_busy_ms=busy, idle_share=1.0 - busy / wall,
        device_ms_by_class=classes,
        top_kernels_ms=[(n[:90], us / 1e3) for n, us in top])
    log(f"phase 14 train profile: one step {wall:.1f} ms wall, {busy:.1f} ms "
        f"device busy, idle share {1.0 - busy / wall:.3f}; by class "
        + ", ".join(f"{c} {ms:.1f}" for c, ms in sorted(
            classes.items(), key=lambda kv: -kv[1])) + f" [{card}]")
    for name, ms in res["profile"]["top_kernels_ms"]:
        log(f"phase 14 train profile:   {ms:8.3f} ms  {name}")
    res["launches"] = launches
    return res


def cache_write_one_late(mt):
    """Planted fault: the decode's K/V written one slot past `time_step`
    (the slot at `time_step` keeps what it held, the attention's mask is
    unchanged). Returns its undo."""
    real = type(mt)._cached_attention

    def fault(q, k, v, cache, time_step):
        t, s = int(time_step), q.shape[1]
        held = cache[:, :, :, t:t + s].clone()
        cache[0, :, :, t + 1:t + 1 + s] = k.transpose(1, 2)
        cache[1, :, :, t + 1:t + 1 + s] = v.transpose(1, 2)
        return real(mt, q, held[0].transpose(1, 2), held[1].transpose(1, 2),
                    cache, t)

    mt._cached_attention = fault
    return lambda: delattr(mt, "_cached_attention")


def gpt_fmt_cell(seed, dev, card, batch=2, seq=1024, steps=16,
                 dtype=torch.float32):
    """Phase 14 (c): FusedMultiTransformer at GPT-3 1.3B widths (24 layers,
    embed 2048, 16 heads of 128, ffn 8192, weights from `seed`): a context
    forward of 2 x 1024 tokens (exactly 24 flash launches); then the first
    1008 tokens into the caches (`gen_cache`'s, in the weights' dtype) at
    time_step 0 and 16 decode steps at time_step 1008..1023, each step's
    output held row by row against the context forward's rows (the flash
    bar); a planted fault (the K/V written one slot late) must fail the
    bar. In f32 (the bar 1e-3): in bf16 the roundings of the cached path
    (bf16 scores and softmax) and of the flash kernel compound over 24
    layers past the bf16 bar of 1e-2 (0.0128 on an NVIDIA H100 80GB
    HBM3)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mt = FusedMultiTransformer(2048, 16, 8192, num_layers=24, dtype=dtype,
                               device=dev, generator=g).eval()
    x = torch.randn(batch, seq, 2048, generator=g, device=dev).to(dtype)
    bar = FLASH_TOL[dtype]
    with torch.no_grad():
        mt(x[:, :128])  # loads the kernels
        kfa.fwd_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = mt(x)
        torch.cuda.synchronize()
        ctx_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(flash_fwd=kfa.fwd_launches)
        check(launches["flash_fwd"] == 24, f"phase 14 fmt: the context "
              f"forward launched flash {launches['flash_fwd']} times")
        check(torch.isfinite(full).all(), "phase 14 fmt: context output")

        def decode(tag):
            start = seq - steps
            caches = [c.to(dtype) for c in mt.gen_cache(batch, seq)]
            _, caches = mt(x[:, :start], caches=caches, time_step=0)
            errs, ms = [], []
            for t in range(start, seq):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, caches = mt(x[:, t:t + 1], caches=caches, time_step=t)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                errs.append(row_rel_err(out[:, 0], full[:, t]))
            log(f"phase 14 fmt {tag}: {steps} decode steps at time_step "
                f"{start}..{seq - 1}: row rel err max {max(errs):.3g} "
                f"against the context forward (bar {bar}); step ms p50 "
                f"{float(np.median(ms)):.3f} [{card}]")
            return errs, ms

        errs, ms = decode("sound")
        check(max(errs) <= bar, f"phase 14 fmt: decode rows differ from the "
              f"context forward by {max(errs):.3g} (bar {bar})")
        undo = cache_write_one_late(mt)
        try:
            bad, _ = decode("fault 'cache write at time_step + 1'")
        finally:
            undo()
        check(max(bad) > bar, f"phase 14 fmt: the planted fault (a cache "
              f"write one slot late) read {max(bad):.3g}, within the bar")
    return dict(card=card, dtype=str(dtype), context_ms=ctx_ms,
                launches=launches,
                decode_row_rel_err=max(errs),
                decode_ms_p50=float(np.median(ms)),
                fault_row_rel_err=max(bad), bar=bar)


def gpt_tiny_cell(seed, dev, card, steps=3, lr=1e-3):
    """Phase 14 (d): a tiny f32 GPT at head_dim 128 (vocab 256, hidden 256,
    2 heads, 2 layers, 256 positions) on CUDA and on the CPU from the same
    weights: the burst engine's, the shallow spec engine's and
    `generate`'s greedy streams equal; 3 AdamW steps give losses within
    1e-4 relative and updates within 1e-2 of their norm (the key part of
    the QKV bias, whose gradient is zero in exact arithmetic, left out)."""
    cfg = GPTConfig.tiny(vocab=256, hidden=256, layers=2, heads=2, seq=256)
    cpu = GPTForCausalLM(cfg, device="cpu", seed=seed)
    with torch.no_grad():  # every bias and norm weight matters
        gen = torch.Generator().manual_seed(seed + 1)
        for n, p in cpu.named_parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    gpu = GPTForCausalLM(cfg, device=dev)
    load_gpt_state(gpu, gpt_state_to_numpy(cpu))
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 256, n) for n in (5, 9, 17, 3, 40)]
    res = {}
    for mode, kw in (("burst", dict(decode_burst=4)),
                     ("spec", dict(spec_decode=4, spec_draft_layers=1))):
        streams = []
        n0 = kpa.launches
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            eng = ServingEngine(model, max_batch=3, max_seq_len=128,
                                page_size=8, device=d, **kw)
            for p in prompts:
                eng.add_request(p, max_new_tokens=24)
            streams.append({f.request_id: f.output_ids.tolist()
                            for f in eng.run()})
        check(kpa.launches > n0, f"phase 14 tiny {mode}: no paged kernel")
        check(streams[0] == streams[1], f"phase 14 tiny {mode}: greedy "
              f"streams differ: cpu {streams[0]} cuda {streams[1]}")
        res[mode] = dict(requests=len(prompts), identical=True)
    outs = [m.generate(torch.from_numpy(np.stack([prompts[0][:5],
                                                  prompts[1][:5]])),
                       max_new_tokens=16)[0].cpu() for m in (cpu, gpu)]
    check(torch.equal(*outs), f"phase 14 tiny generate: {outs}")
    before = {k: v.clone() for k, v in cpu.state_dict().items()}
    x = torch.from_numpy(rng.randint(0, 256, (2, 256)))
    y = torch.from_numpy(rng.randint(0, 256, (2, 256)))
    n0 = kfa.fwd_launches, kfa.bwd_launches, kadam.launches
    losses = []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        step = build_train_step(model, AdamW(learning_rate=lr,
                                             parameters=model.parameters()))
        losses.append([step(x.to(d), y.to(d)).item() for _ in range(steps)])
    n_tensors = len(before)
    check((kfa.fwd_launches, kfa.bwd_launches, kadam.launches) ==
          (n0[0] + 2 * steps, n0[1] + 2 * steps, n0[2] + n_tensors * steps),
          "phase 14 tiny training did not run the kernels on CUDA")
    rel = max(abs(a - b) / abs(a) for a, b in zip(*losses))
    check(rel <= 1e-4, f"phase 14 tiny training losses differ: {losses}")
    # head-major columns: head h's [q | k | v] at [384 h, 384 (h + 1))
    key = (torch.arange(3 * 256) % 384) // 128 == 1
    worst = 0.0
    g_state = gpu.state_dict()
    for name, c in cpu.state_dict().items():
        dc, dg = c - before[name], g_state[name].cpu() - before[name]
        if name.endswith("qkv_proj.bias"):
            dc, dg = dc[~key], dg[~key]
        worst = max(worst, ((dg - dc).norm() / dc.norm()).item())
    check(worst <= 1e-2, f"phase 14 tiny training updates differ by {worst}")
    log(f"phase 14 tiny: f32 GPT (2 layers, hidden 256, 2 heads of 128): "
        f"burst and shallow spec greedy streams and generate CUDA == CPU; "
        f"{steps} AdamW steps: losses cpu {losses[0]} cuda {losses[1]} "
        f"(max rel diff {rel:.2e}), updates within {worst:.2e} of their "
        f"norm [{card}]")
    res.update(generate_identical=True, losses_cpu=losses[0],
               losses_cuda=losses[1], max_rel_loss_diff=rel,
               max_rel_update_diff=worst)
    return res


GPT_CELL_FNS = dict(serve=gpt_serve_cell, train=gpt_train_cell,
                    fmt_tiny=lambda seed, dev, card: dict(
                        fmt=gpt_fmt_cell(seed, dev, card),
                        tiny=gpt_tiny_cell(seed, dev, card)))


def gpt_phase(seed, card, then=None):
    """Phase 14: each cell in a process of its own, started while the one
    before runs; `then` starts after the last."""
    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    io = phase_dir("14")
    for cell, nxt in next_cells("14", GPT_CELLS, then, ahead=2):
        rc, secs = run_child("14", cell, seed, 400, nxt)
        check(rc == 0, f"phase 14 ({cell}) failed: exit {rc}")
        with open(os.path.join(io, f"{cell}.json")) as f:
            got = json.load(f)
        for name, r in (got if cell == "fmt_tiny" else {cell: got}).items():
            res[name] = r
            r["process_s"] = secs
            log(f"phase 14 {name}: process {secs:.1f} s from its go, "
                f"launches {r.get('launches')} [{card}]")
    return res


# ---------------------------------------------------------------------------
# phase 15: the data-parallel fine-tune
# ---------------------------------------------------------------------------

FT_LAYERS = 2          # of LLaMA-2-7B's 32 layers (the script's time)
FT_SEQ = 4096
FT_STEPS = 4
FT_SAVE_AFTER = 2      # the checkpoint: model and optimizer after step 2
FT_LR = 1e-4
# the resumed run against the uninterrupted one. Step 3's loss comes from
# the loaded weights and the same batch through a forward without atomics:
# equal within FT_LOSS3_TOL (bitwise where the forward repeats its
# kernels' choices). Step 4's loss follows one backward whose bf16 dQ sums
# by atomics (ROADMAP, deliberate differences): within FT_LOSS4_TOL. The
# probe parameters after step 4 (`FT_PROBES`) differ from the
# uninterrupted run's by at most FT_PARAM_BAR of the update since step 2
# (rounding flips of the bf16 parameters where a gradient moved by the
# atomics' order); a resume without the optimizer's state steps from
# fresh moments and must exceed it. Both bars from the readings at
# FT_LAYERS = 2 on an H100 (PERF.md, §6): step 4 rel 2.35e-05 (4.35e-06 to
# 6.6e-05 at 4 layers), the probes 0.0099-0.0403 (0.0118-0.0621 at 4), the
# fault 0.643-1.307.
FT_LOSS3_TOL = 1e-6
FT_LOSS4_TOL = 3e-4
FT_PARAM_BAR = 0.1
FT_PROBES = ("llama.layers.0.self_attn.q_proj.weight",
             f"llama.layers.{FT_LAYERS - 1}.mlp.down_proj.weight",
             "lm_head.weight")
# (b): gloo ranks on one card against one process on the global batch:
# f32 sums of two ranks' gradients in another order than the global
# batch's GEMMs, 1e-5 of each gradient's norm
FT_GRAD_TOL = 1e-5
FT_GLOO = dict(vocab=1024, hidden=512, layers=2, heads=4, seq=256)


FT_DATA_VOCAB = 1000   # the fine-tune's text draws from these ids alone


def ft_data(seed, steps=FT_STEPS, seq=FT_SEQ):
    """A TensorDataset of `steps` seeded rows (one a step), ids and their
    next-token labels, drawn from the first FT_DATA_VOCAB ids: the loss
    falls from about ln(32000) as the model learns that narrower
    distribution (random ids over the whole vocabulary would hold it at
    ln(32000); one row repeated drives it to 0.006 by step 3)."""
    rng = np.random.RandomState(seed + 15)
    ids = rng.randint(0, FT_DATA_VOCAB, (steps, seq + 1))
    return TensorDataset([ids[:, :-1].copy(), ids[:, 1:].copy()])


def ft_digest(state):
    """{key: (dtype, shape, two integer sums of the bits)} of a state's
    tensors, summed on the card: two states have equal digests when their
    tensors are equal bit for bit (a linear hash of the bits; any one
    changed element changes the position-weighted sum)."""
    out = {}
    for k, v in state.items():
        if not isinstance(v, torch.Tensor):
            out[k] = repr(v)
            continue
        t = v.detach().reshape(-1)
        bits = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[t.element_size()]
        b = t.view(bits).to(torch.int64)
        w = torch.arange(1, b.numel() + 1, device=b.device) % 65521 + 1
        out[k] = (str(v.dtype), list(v.shape), int(b.sum()),
                  int((b * w).sum()))
    return out


def ft_rank(mode, io, seed, card):
    """Phase 15 (a), in a rank started by `distributed.spawn(nprocs=1)`:
    NCCL at world 1, a dp=1 mesh, DataParallel, a DataLoader of 2 worker
    processes over a DistributedBatchSampler. mode "full": steps 1-4,
    saving the model's and the optimizer's state_dict after step 2;
    "resume": a new process loads them, checks them against the saved
    digests and runs steps 3-4, then (the planted fault) again from the
    loaded weights without the optimizer's state; then phase 15 (c)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.io import DistributedBatchSampler

    t_start = time.perf_counter()
    D.init_parallel_env()
    stage(f"phase15 {mode} rank {D.get_rank()}",
          "imports, CUDA and the process group")
    wait_go(rank_go(io, f"ft_{mode}"), f"phase15 {mode}")
    t_start = time.perf_counter()
    dev = D.env.device()
    check(D.get_backend() == "nccl" and D.get_world_size() == 1,
          f"phase 15 (a): backend {D.get_backend()}, world "
          f"{D.get_world_size()}")
    D.init_mesh(dp=1)
    res = dict(mode=mode, backend=D.get_backend(), device=str(dev))
    if mode == "full":  # NCCL at world 1: each collective returns its input
        x = torch.randn(1000, device=dev)
        C.reset_calls()
        ok = dict(all_reduce=torch.equal(D.all_reduce(x.clone()), x),
                  broadcast=torch.equal(D.broadcast(x.clone(), 0), x))
        got = D.all_gather([], x)
        ok["all_gather"] = len(got) == 1 and torch.equal(got[0], x)
        torch.cuda.synchronize()
        check(all(ok.values()) and dict(C.calls) == dict(
            all_reduce=1, broadcast=1, all_gather=1),
            f"phase 15 (a): NCCL at world 1: {ok}, calls {dict(C.calls)}")
        res["nccl_world1"] = ok
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = FT_LAYERS
    model = amp.decorate(LlamaForCausalLM(
        cfg, device=dev, seed=seed if mode == "full" else seed + 1),
        level="O2", dtype="bfloat16")
    dp = D.DataParallel(model)
    ds = ft_data(seed)
    loader = DataLoader(ds, batch_sampler=DistributedBatchSampler(ds, 1),
                        num_workers=2, multiprocess=True,
                        shm_capacity=8 << 20)
    ckpt = os.path.join(io, "finetune.pdckpt")
    res["setup_s"] = time.perf_counter() - t_start

    def run(opt, first, steps):
        """Steps `first`.. of the loader's batches: (losses, step ms)."""
        losses, ms = [], []
        for i, (x, y) in enumerate(loader):
            if i < first:
                continue
            if i >= first + steps:
                break
            t0 = time.perf_counter()
            x, y = x.to(dev, non_blocking=True), y.to(dev, non_blocking=True)
            loss = model.compute_loss(dp(x).float(), y)  # an f32 loss
            loss.backward()
            dp.sync_gradients()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
            ms.append((time.perf_counter() - t0) * 1e3)
            if mode == "full" and i + 1 == FT_SAVE_AFTER:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ptt.save({"model": model.state_dict(),
                          "opt": opt.state_dict()}, ckpt)
                res["save_s"] = time.perf_counter() - t1
                res["ckpt_bytes"] = os.path.getsize(ckpt)
                res["digest"] = dict(
                    model=ft_digest(model.state_dict()),
                    opt=ft_digest(opt.state_dict()))
        return losses, ms

    if mode == "full":
        opt = AdamW(learning_rate=FT_LR, parameters=dp.parameters())
        for _, mod, attr in TRAIN_COUNTERS:
            setattr(mod, attr, 0)
        losses, ms = run(opt, 0, FT_STEPS)
        res["launches"] = {n: getattr(mod, a) for n, mod, a in
                           TRAIN_COUNTERS}
        ptt.save({k: v for k, v in model.state_dict().items()
                  if k in FT_PROBES}, os.path.join(io, "probes4.pd"))
        res.update(losses=losses, step_ms=ms)
    else:
        t1 = time.perf_counter()
        state = ptt.load(ckpt, device=dev)
        torch.cuda.synchronize()
        res["load_s"] = time.perf_counter() - t1
        with open(os.path.join(io, "ft_full.json")) as f:
            saved = json.load(f)["digest"]
        got = dict(model=ft_digest(state["model"]),
                   opt=ft_digest(state["opt"]))
        bad = [k for part in ("model", "opt") for k in saved[part]
               if json.loads(json.dumps(got[part][k])) != saved[part][k]]
        check(not bad and len(got["opt"]) == len(saved["opt"]),
              f"phase 15 (a): the loaded state differs from the saved one "
              f"at {bad[:5]}")
        res["state_tensors"] = {p: len(saved[p]) for p in saved}
        want4 = ptt.load(os.path.join(io, "probes4.pd"), device=dev)

        def resumed(with_opt_state):
            model.load_state_dict(state["model"])
            opt = AdamW(learning_rate=FT_LR, parameters=dp.parameters())
            if with_opt_state:
                opt.set_state_dict(state["opt"])
            for _, mod, attr in TRAIN_COUNTERS:
                setattr(mod, attr, 0)
            losses, ms = run(opt, FT_SAVE_AFTER, FT_STEPS - FT_SAVE_AFTER)
            launches = {n: getattr(mod, a) for n, mod, a in TRAIN_COUNTERS}
            cur = model.state_dict()
            dist = {}
            for k in FT_PROBES:
                moved = (want4[k].float() - state["model"][k].float()).norm()
                check(moved > 0, f"phase 15 (a): {k} did not move in steps "
                      "3-4 of the uninterrupted run")
                dist[k] = float((cur[k].float() - want4[k].float()).norm()
                                / moved)
            return dict(losses=losses, step_ms=ms, launches=launches,
                        param_dist=dist)

        res["resumed"] = resumed(True)
        res["fault_no_opt_state"] = resumed(False)
        del state, want4
        res["checker"] = ft_checker(seed, dev, card)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["process_s"] = time.perf_counter() - t_start
    with open(os.path.join(io, f"ft_{mode}.json"), "w") as f:
        json.dump(res, f)
    stage(f"phase15 {mode} rank {D.get_rank()}", "done")
    D.destroy_process_group()


def ft_gloo_rank(io, seed):
    """Phase 15 (b), one of two ranks on the one card: gloo (named by
    PADDLE_DISTRI_BACKEND) over CUDA tensors, a dp=2 mesh, a tiny f32
    LLaMA in DataParallel on row `rank` of a 2-row global batch; the
    synced gradients against one process's on the whole batch, the
    bucketed sums against the per-parameter ones, one all_reduce a
    bucket, and a bucket slice one element off (the planted fault)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import parallel as P

    os.environ["PADDLE_DISTRI_BACKEND"] = "gloo"  # CUDA tensors on gloo
    t_start = time.perf_counter()
    D.init_parallel_env()
    stage(f"phase15 gloo rank {D.get_rank()}",
          "imports, CUDA and the process group")
    wait_go(rank_go(io, "ft_gloo"), f"phase15 gloo rank {D.get_rank()}")
    t_start = time.perf_counter()
    dev, rank = D.env.device(), D.get_rank()
    check(D.get_backend() == "gloo" and dev.type == "cuda",
          f"phase 15 (b): backend {D.get_backend()} on {dev}")
    D.init_mesh(dp=2)
    g = FT_GLOO
    cfg = LlamaConfig.tiny(vocab=g["vocab"], hidden=g["hidden"],
                           layers=g["layers"], heads=g["heads"],
                           seq=g["seq"])
    # rank 1 starts from other weights: the construction broadcasts rank 0's
    model = LlamaForCausalLM(cfg, device=dev, seed=seed + rank)
    dp = D.DataParallel(model)
    ref = LlamaForCausalLM(cfg, device=dev, seed=seed)
    rng = np.random.RandomState(seed + 16)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (2, g["seq"] + 1))).to(dev)
    x, y = ids[:, :-1], ids[:, 1:]
    ref.compute_loss(ref(x), y).backward()
    want = [p.grad for p in ref.parameters()]
    for _, mod, attr in TRAIN_COUNTERS:
        setattr(mod, attr, 0)
    model.compute_loss(dp(x[rank:rank + 1]), y[rank:rank + 1]).backward()
    launches = {n: getattr(mod, a) for n, mod, a in TRAIN_COUNTERS}
    local = [p.grad.clone() for p in model.parameters()]

    def sync(overlap, reduce_bucket=None):
        for p, l in zip(model.parameters(), local):
            p.grad = l.clone()
        set_flags({"FLAGS_train_overlap": overlap})
        saved = P._reduce_bucket
        if reduce_bucket is not None:
            P._reduce_bucket = reduce_bucket
        try:
            C.reset_calls()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dp.sync_gradients()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            P._reduce_bucket = saved
        grads = [p.grad.clone() for p in model.parameters()]
        worst = max(float((a - b).norm() / b.norm())
                    for a, b in zip(grads, want))
        return grads, worst, C.calls["all_reduce"], ms

    def off_by_one(bucket):
        """The fault: each gradient copied back from one element further
        along the reduced buffer."""
        flat = torch.cat([p.grad.reshape(-1) for p in bucket]
                         + [torch.zeros(1, device=dev)])
        D.all_reduce(flat, op=C.ReduceOp.AVG, group="dp")
        off = 0
        for p in bucket:
            n = p.grad.numel()
            p.grad.copy_(flat[off + 1:off + 1 + n].view_as(p.grad))
            off += n

    n_buckets = len(P._bucket_grads(list(model.parameters())))
    sync(True)  # gloo's first CUDA all_reduces set up its staging: untimed
    per_param, err_p, calls_p, ms_p = sync(False)
    bucketed, err_b, calls_b, ms_b = sync(True)
    _, err_fault, _, _ = sync(True, off_by_one)
    set_flags({"FLAGS_train_overlap": True})
    res = dict(rank=rank, backend=D.get_backend(), device=str(dev),
               n_params=len(local), n_buckets=n_buckets,
               calls_bucketed=calls_b, calls_per_param=calls_p,
               grad_rel_err=err_b, grad_rel_err_per_param=err_p,
               fault_grad_rel_err=err_fault,
               bitwise=all(torch.equal(a, b)
                           for a, b in zip(bucketed, per_param)),
               sync_ms=ms_b, sync_ms_per_param=ms_p, launches=launches,
               process_s=time.perf_counter() - t_start)
    with open(os.path.join(io, f"gloo_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    stage(f"phase15 gloo rank {D.get_rank()}", "done")
    D.destroy_process_group()


def ft_checker(seed, dev, card):
    """Phase 15 (c): the tensor checker on CUDA tensors names the op of a
    NaN planted in a layer's output (layer 1's MLP output times a mask
    holding one NaN); check_numerics passes the clean logits."""
    from paddle_tpu_torch.amp import debugging

    g = FT_GLOO
    cfg = LlamaConfig.tiny(vocab=g["vocab"], hidden=g["hidden"],
                           layers=g["layers"], heads=g["heads"],
                           seq=g["seq"])
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    x = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (1, g["seq"]))).to(dev)
    with torch.no_grad():
        clean = model(x)
    check(debugging.check_numerics(clean, "llama", "logits") is clean,
          "phase 15 (c): check_numerics refused clean logits")
    mask = torch.ones(1, g["seq"], g["hidden"], device=dev)
    mask[0, 7, 3] = float("nan")
    hook = model.llama.layers[1].mlp.register_forward_hook(
        lambda mod, inp, out: out * mask)
    debugging.enable_tensor_checker()
    try:
        with torch.no_grad():
            model(x)
        msg = None
    except RuntimeError as e:
        msg = str(e)
    finally:
        debugging.disable_tensor_checker()
        hook.remove()
    want = (f"NaN/Inf detected in output 0 of op 'aten.mul.Tensor' (shape "
            f"(1, {g['seq']}, {g['hidden']}), dtype torch.float32)")
    check(msg is not None and msg.startswith(want),
          f"phase 15 (c): the checker read {msg!r}")
    try:
        debugging.check_numerics(torch.log(clean.new_zeros(3)), "log", "z")
        caught = False
    except FloatingPointError:
        caught = True
    check(caught, "phase 15 (c): check_numerics passed an Inf")
    return dict(message=msg, card=card)


FT_SPAWNS = ("ft_full", "ft_resume", "ft_gloo")


def ft_start(name, seed, card):
    """Start phase 15's spawn `name` ahead: the uninterrupted run and the
    resume (one NCCL rank each), or the two gloo ranks."""
    io = phase_dir("15")
    if name == "ft_gloo":
        return start_spawn(name, io, ft_gloo_rank, (io, seed), 2, 300)
    return start_spawn(name, io, ft_rank, (name[3:], io, seed, card), 1,
                       300)


def finetune_phase(seed, card, early=None, then=None):
    """Phase 15: (a) the fine-tune, its uninterrupted run and its resume in
    two processes started by `spawn(nprocs=1)`, (c) the tensor checker at
    the end of the second; (b) two gloo ranks on the card. Each spawn's
    ranks start while the one before runs; `early` starts with the first,
    `then` with the last."""
    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    t_all = time.perf_counter()
    io = phase_dir("15")
    for i, name in enumerate(FT_SPAWNS):
        ft_start(name, seed, card)
        nxt = (lambda n=FT_SPAWNS[i + 1]: ft_start(n, seed, card)) \
            if i + 1 < len(FT_SPAWNS) else then
        if i == 0 and early is not None:
            early()
        secs = join_spawn(name, then=nxt)
        if name == "ft_gloo":
            res["gloo_spawn_s"] = secs
            continue
        mode = name[3:]
        with open(os.path.join(io, f"ft_{mode}.json")) as f:
            res[mode] = json.load(f)
        res[mode]["spawn_s"] = secs
    res["gloo"] = []
    for r in range(2):
        with open(os.path.join(io, f"gloo_rank{r}.json")) as f:
            res["gloo"].append(json.load(f))
    drop_phase_dir("15")
    full, resume = res["full"], res["resume"]
    L = FT_LAYERS
    losses = full["losses"]
    got, fault = resume["resumed"], resume["fault_no_opt_state"]
    tail = losses[FT_SAVE_AFTER:]
    d3 = abs(got["losses"][0] - tail[0]) / abs(tail[0])
    d4 = abs(got["losses"][1] - tail[1]) / abs(tail[1])
    dist = max(got["param_dist"].values())
    dist_fault = max(fault["param_dist"].values())
    res["resume_check"] = dict(loss3_rel=d3, loss4_rel=d4, param_dist=dist,
                               fault_param_dist=dist_fault,
                               fault_loss4_rel=abs(fault["losses"][1]
                                                   - tail[1]) / abs(tail[1]),
                               loss3_bitwise=got["losses"][0] == tail[0])
    p50 = float(np.median(full["step_ms"][1:]))
    res["step_ms_p50"], res["tokens_per_s"] = p50, FT_SEQ / (p50 / 1e3)
    log(f"phase 15 (a): LLaMA-2-7B widths, {L} layers, bf16 O2, AdamW, batch "
        f"1 x {FT_SEQ}, NCCL world 1, DataLoader of 2 worker processes: "
        f"losses {losses}; steps 2-4 p50 {p50:.1f} ms (steps "
        f"{[round(m, 1) for m in full['step_ms']]}), "
        f"{res['tokens_per_s']:.1f} tokens/s; save {full['save_s']:.2f} s "
        f"({full['ckpt_bytes'] / 2 ** 30:.2f} GiB), load "
        f"{resume['load_s']:.2f} s; setup {full['setup_s']:.1f} / "
        f"{resume['setup_s']:.1f} s; processes {full['process_s']:.1f} / "
        f"{resume['process_s']:.1f} s; peak {full['peak_gib']:.2f} / "
        f"{resume['peak_gib']:.2f} GiB [{card}]")
    log(f"phase 15 (a): resumed losses {got['losses']} against {tail}: "
        f"step 3 rel {d3:.3g} (bitwise {got['losses'][0] == tail[0]}, bar "
        f"{FT_LOSS3_TOL}), step 4 rel {d4:.3g} (bar {FT_LOSS4_TOL}); probe "
        f"parameters after step 4 {got['param_dist']} of the update since "
        f"step 2 (bar {FT_PARAM_BAR}); the fault (no optimizer state): "
        f"{fault['param_dist']}, losses {fault['losses']}; the loaded state "
        f"against the saved one's digests at {resume['state_tensors']} "
        f"tensors; launches full {full['launches']}, resumed "
        f"{got['launches']}")
    per_step = {"flash_fwd": L, "flash_bwd": L, "rms_norm": 2 * L + 1,
                "rms_norm_bwd": 2 * L + 1, "adam": n_param_tensors(L)}
    for tag, launches, steps in (
            ("full", full["launches"], FT_STEPS),
            ("resumed", got["launches"], FT_STEPS - FT_SAVE_AFTER)):
        for name, n in per_step.items():
            check(launches[name] == n * steps,
                  f"phase 15 (a) {tag}: {name} launched {launches[name]} "
                  f"times in {steps} steps, expected {n * steps}")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"phase 15 (a): losses {losses}")
    check(d3 <= FT_LOSS3_TOL and d4 <= FT_LOSS4_TOL and dist <= FT_PARAM_BAR,
          f"phase 15 (a): resumed losses {got['losses']} against {tail} "
          f"(rel {d3:.3g}, {d4:.3g}), probe parameters {got['param_dist']}")
    check(dist_fault > FT_PARAM_BAR,
          f"phase 15 (a): a resume without the optimizer's state passed: "
          f"{fault['param_dist']}")
    ranks = res["gloo"]
    nb = ranks[0]["n_buckets"]
    log(f"phase 15 (b): 2 ranks on the card over gloo (CUDA tensors), f32 "
        f"LLaMA {FT_GLOO}: gradients within "
        f"{[r['grad_rel_err'] for r in ranks]} (per parameter "
        f"{[r['grad_rel_err_per_param'] for r in ranks]}) of the global "
        f"batch's (bar {FT_GRAD_TOL}); {nb} buckets, all_reduces "
        f"{[r['calls_bucketed'] for r in ranks]} bucketed, "
        f"{[r['calls_per_param'] for r in ranks]} per parameter of "
        f"{ranks[0]['n_params']}; bitwise {[r['bitwise'] for r in ranks]}; "
        f"the off-by-one slice reads "
        f"{[r['fault_grad_rel_err'] for r in ranks]}; sync "
        f"{[round(r['sync_ms'], 3) for r in ranks]} ms bucketed, "
        f"{[round(r['sync_ms_per_param'], 3) for r in ranks]} ms per "
        f"parameter; processes {[round(r['process_s'], 1) for r in ranks]} "
        f"s [{card}]")
    for r in ranks:
        check(r["backend"] == "gloo" and r["device"].startswith("cuda"),
              f"phase 15 (b): rank {r['rank']} on {r['device']} over "
              f"{r['backend']}")
        check(r["grad_rel_err"] <= FT_GRAD_TOL and
              r["grad_rel_err_per_param"] <= FT_GRAD_TOL,
              f"phase 15 (b): rank {r['rank']}: gradients "
              f"{r['grad_rel_err']:.3g} / {r['grad_rel_err_per_param']:.3g} "
              f"from the global batch's (bar {FT_GRAD_TOL})")
        check(r["calls_bucketed"] == r["n_buckets"] == nb
              and r["calls_per_param"] == r["n_params"],
              f"phase 15 (b): rank {r['rank']}: {r['calls_bucketed']} "
              f"all_reduces for {r['n_buckets']} buckets")
        check(r["bitwise"], f"phase 15 (b): rank {r['rank']}: bucketed "
              "gradients differ from the per-parameter ones")
        check(r["fault_grad_rel_err"] > FT_GRAD_TOL,
              f"phase 15 (b): the off-by-one bucket slice passed: "
              f"{r['fault_grad_rel_err']}")
    res["checker"] = resume["checker"]
    res["processes_s"] = time.perf_counter() - t_all
    log(f"phase 15 (c): the tensor checker on CUDA: "
        f"{res['checker']['message'].split(';')[0]}; check_numerics passed "
        f"the clean logits and refused an Inf [{card}]")
    log(f"phase 15: {res['processes_s']:.1f} s (spawns: full "
        f"{full['spawn_s']:.1f}, resume {resume['spawn_s']:.1f}, gloo "
        f"{res['gloo_spawn_s']:.1f}) [{card}]")
    return res


# ---------------------------------------------------------------------------
# phase 16: tensor parallelism through fleet
# ---------------------------------------------------------------------------

# (a) GPT-3 1.3B (BASELINE.json config 3) at TP 4 and (b) LLaMA-2-7B's
# widths at TP 2, each against one process training the same full model
# at tp 1. Every rank runs on the one card over gloo (NCCL refuses two
# ranks a card), so the times are no tensor-parallel speed.
TP_CELLS = {
    # (a) the loss: the chunked vocab-parallel cross entropy (8 chunks)
    "gpt": dict(tp=4, layers=24, seq=2048, steps=3, ce_chunks=8),
    # (b) the loss: the dense head's f32 logits into ParallelCrossEntropy
    "llama": dict(tp=2, layers=2, seq=4096, steps=2, ce_chunks=0),
}
TP_LR = 1e-4
TP_CLIP_TOL = 1e-3
TP_DATA_VOCAB = 1000   # the batch's ids, as phase 15's (a falling loss)


def tp_probes(cell, layers):
    """The parameters whose f32 master weights phase 16 compares: split by
    columns, by rows, and replicated (the last two below layer 0's
    attention, where the planted `_c_identity` fault acts)."""
    if cell == "gpt":
        return ("gpt.layers.0.attn.qkv_proj.weight",
                f"gpt.layers.{layers - 1}.mlp.fc_out.weight",
                "gpt.embed_positions.weight", "gpt.layers.0.ln_1.weight")
    return ("llama.layers.0.self_attn.q_proj.weight",
            f"llama.layers.{layers - 1}.mlp.down_proj.weight",
            "llama.layers.0.input_layernorm.weight", "llama.norm.weight")


def tp_full_shapes(cell, cfg):
    from paddle_tpu_torch import weights as W

    return W.gpt_param_shapes(cfg) if cell == "gpt" \
        else W.llama_param_shapes(cfg)


@torch.no_grad()
def tp_load(model, cell, seed):
    """Seeded weights, identical in every process: each full tensor drawn
    on the card from a generator of its own (the seed and the tensor's
    position among the full model's names), then this rank's shard copied
    in (`weights.tp_split_axis`). 2-D weights N(0, 0.02), biases
    N(0, 0.02), norm weights 1 + N(0, 0.1)."""
    from paddle_tpu_torch import weights as W

    shapes = tp_full_shapes(cell, model.config)
    order = {n: i for i, n in enumerate(sorted(shapes))}
    tp, rank = model.tp_degree, model.tp_rank
    for name, p in model.named_parameters():
        full = shapes[name]
        gen = torch.Generator(device=p.device).manual_seed(
            seed * 100003 + order[name])
        w = torch.randn(full, generator=gen, device=p.device)
        if len(full) == 1 and not name.endswith(".bias"):
            w = 1.0 + 0.1 * w
        else:
            w = 0.02 * w
        ax = W.tp_split_axis(name)
        if ax is not None and tp > 1:
            n = full[ax] // tp
            w = w.narrow(ax, rank * n, n)
        p.copy_(w)
        del w


def tp_model(cell, seed, dev, sp=False):
    """The cell's model (LLaMA with sequence parallelism at `sp`), bf16
    O2, its seeded weights loaded."""
    c = TP_CELLS[cell]
    if cell == "gpt":
        cfg = GPTConfig.gpt3_1p3b()
        cfg.dtype = "bfloat16"
        cfg.num_hidden_layers = c["layers"]
        cfg.fused_ce_chunks = c["ce_chunks"]
        model = GPTForCausalLM(cfg, device=dev, seed=seed)
    else:
        cfg = LlamaConfig.llama2_7b()
        cfg.dtype = "bfloat16"
        cfg.num_hidden_layers = c["layers"]
        cfg.fused_ce_chunks = c["ce_chunks"]
        cfg.sequence_parallel = sp
        model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    tp_load(model, cell, seed)
    return model


def tp_batch(cell, seed, dev):
    rng = np.random.RandomState(seed + 16)
    ids = rng.randint(0, TP_DATA_VOCAB, (1, TP_CELLS[cell]["seq"] + 1))
    ids = torch.from_numpy(ids).to(dev)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def tp_masters(opt, model, names):
    """{name: the f32 master weight (a CPU copy)} of `names`."""
    inner = getattr(opt, "_inner_opt", opt)
    pos = {id(p): i for i, p in enumerate(inner._parameter_list)}
    params = dict(model.named_parameters())
    return {n: inner._state_for(pos[id(params[n])])["master_weight"]
            .detach().cpu().clone() for n in names}


class _IdentityNoReduce(torch.autograd.Function):
    """The planted fault: `_c_identity` without its backward all_reduce."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g


def plant_identity_without_reduce(lin):
    """Layer 0's fused QKV projection takes its input through
    `_IdentityNoReduce`; returns the undo."""
    def forward(x):
        return F.linear(_IdentityNoReduce.apply(x), lin.weight, lin.bias)

    lin.forward = forward
    return lambda: delattr(lin, "forward")


def clip_every_square_summed(clip):
    """The planted clip fault: the program's `HybridParallelClipGrad`
    taking every parameter for a shard, so its norm sums every gradient's
    squares over "tp" and counts the replicated ones tp times."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        HybridParallelClipGrad

    class EverySquareSummed(HybridParallelClipGrad):
        @staticmethod
        def _sharded(p):
            return True

    return EverySquareSummed(clip)


def plant_ce_offset(model):
    """The vocab-parallel cross entropy (the chunked one reads the loss
    layer's rank too) offsets its labels by the next rank's first vocab
    row; returns the undo."""
    ce = model.loss_fn
    ce.rank = (ce.rank + 1) % ce.world_size
    return lambda: setattr(ce, "rank", model.tp_rank)


def tp_loss(model, out, y):
    """The cell's loss of the model's output: the chunked cross entropy
    of the hidden states, or the mean one of f32 logits."""
    if model.config.fused_ce_chunks:
        return model.compute_loss_hidden(out, y)
    return model.compute_loss(out.float(), y)


def gloo_cuda_ops(dev):
    """Which collectives gloo runs on CUDA tensors in this torch, each
    tried once ({op: True or gloo's error})."""
    from paddle_tpu_torch import distributed as D

    x = torch.ones(256, device=dev)
    tries = {
        "all_reduce_sum": lambda: D.all_reduce(x.clone()),
        "all_reduce_max": lambda: D.all_reduce(x.clone(), op="max"),
        "broadcast": lambda: D.broadcast(x.clone(), src=0),
        "all_gather": lambda: D.all_gather([], x),
        "reduce_scatter": lambda: D.reduce_scatter(
            torch.empty(128, device=dev), list(x.clone().chunk(2))),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = True
        except RuntimeError as e:  # gloo's own error for an op it lacks
            out[name] = str(e).splitlines()[0][:120]
    return out


class CommCount:
    """Counts collectives (`ops`) through the module attributes the
    mp_layers call, until `close`: their calls and the bytes a rank puts
    in (all_reduce: its tensor; all_gather: its shard; reduce_scatter: its
    whole input)."""

    def __init__(self, ops):
        from paddle_tpu_torch.distributed import collective as C

        self.C = C
        self.n = {op: {"calls": 0, "bytes": 0} for op in ops}
        self.plain = {op: getattr(C, op) for op in ops}

        def counting(op):
            def call(*a, **kw):
                put = a[0] if op == "all_reduce" else a[1]
                put = put if isinstance(put, (list, tuple)) else [put]
                self.n[op]["calls"] += 1
                self.n[op]["bytes"] += sum(x.numel() * x.element_size()
                                           for x in put)
                return self.plain[op](*a, **kw)
            return call

        for op in ops:
            setattr(C, op, counting(op))

    def read(self):
        return {op: dict(v) for op, v in self.n.items()}

    def close(self):
        for op, fn in self.plain.items():
            setattr(self.C, op, fn)


def tp_cell(cell, seed, dev, faults=False, sp=False):
    """One process's part of phase 16 for `cell`: the whole model at tp 1,
    or this rank's shards through fleet.distributed_model /
    distributed_optimizer (the mesh exists). At the initial weights: the
    loss, the probes' gradients and the clip's global norm (and, at tp >
    1, that of the clip fault that counts the replicated gradients tp
    times); then `steps` steps of build_train_step with the kernels'
    launches, the all_reduces and their bytes counted, and the probe
    masters after the last; with `faults`, two planted faults, each a
    forward and backward from the initial weights (loss and gradients)."""
    from paddle_tpu_torch.distributed import fleet

    c = TP_CELLS[cell]
    res = {}
    t0 = time.perf_counter()
    model = tp_model(cell, seed, dev, sp)
    tp = model.tp_degree
    names = tp_probes(cell, c["layers"])
    dm = fleet.distributed_model(model) if tp > 1 else model
    if tp > 1:  # before the clip's backward (the step would register them)
        fleet.utils.register_sequence_parallel_allreduce_hooks(model)

    def make_opt():
        inner = AdamW(learning_rate=TP_LR, parameters=dm.parameters(),
                      multi_precision=True,
                      grad_clip=ClipGradByGlobalNorm(1.0))
        return fleet.distributed_optimizer(inner) if tp > 1 else inner

    x, y = tp_batch(cell, seed, dev)
    params = dict(model.named_parameters())
    res["init"] = {n: params[n].detach().float().cpu() for n in names}
    torch.cuda.synchronize()
    res["setup_s"] = time.perf_counter() - t0
    fused = bool(model.config.fused_ce_chunks)

    def backward():
        """One forward and backward from the current weights, as the step
        computes them; returns (the loss, the probes' gradients)."""
        loss = tp_loss(model, model.forward_hidden(x) if fused else dm(x),
                       y)
        loss.backward()
        return float(loss), {n: params[n].grad.float().cpu()
                             for n in names}

    res["loss0"], res["grads0"] = backward()
    pg = [(p, p.grad) for p in model.parameters()]
    opt = make_opt()
    # the norm the clip scales the gradients by (its `_params_norm`)
    res["clip_norm"] = float(opt._grad_clip._params_norm(pg))
    if tp > 1:
        res["clip_fault_norm"] = float(clip_every_square_summed(
            opt._grad_clip)._params_norm(pg))
    del pg
    opt.clear_grad()
    # the chunked loss is build_train_step's own; (b) casts the logits
    criterion = None if fused else (  # noqa: E731
        lambda out, lab: tp_loss(model, out, lab))
    step = build_train_step(dm, opt, criterion=criterion)
    torch.cuda.synchronize()
    for _, mod, attr in TRAIN_COUNTERS:
        setattr(mod, attr, 0)
    comm = CommCount(("all_reduce", "all_gather", "reduce_scatter"))
    losses, ms = [], []
    try:
        for s in range(c["steps"]):
            t1 = time.perf_counter()
            losses.append(float(step(x, y)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
    finally:
        comm.close()
    res["launches"] = {n: getattr(mod, a) for n, mod, a in TRAIN_COUNTERS}
    res.update(losses=losses, step_ms=ms, n_tensors=len(list(
        model.parameters())), collectives=comm.read(),
        probes=tp_masters(opt, model, names))
    if faults:
        undo_layer0 = model.gpt.layers[0].attn.qkv_proj \
            if cell == "gpt" else model.llama.layers[0].self_attn.q_proj
        res["faults"] = {}
        tp_load(model, cell, seed)
        for fault, plant in (
                ("identity_without_reduce",
                 lambda: plant_identity_without_reduce(undo_layer0)),
                ("ce_rank_offset", lambda: plant_ce_offset(model))):
            opt.clear_grad()
            undo = plant()
            try:
                loss, grads = backward()
            finally:
                undo()
            res["faults"][fault] = dict(loss=loss, grads=grads)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, dm, opt, step, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_rank_proc(io, seed, cell, phases=("16",)):
    """One rank of phase 16's `cell`: gloo over CUDA tensors on the one
    card (PADDLE_DISTRI_BACKEND), fleet.init at the cell's mp_degree; with
    "20" in `phases`, phase 20 after (`zpp_rank_part`, in the same four
    ranks), its results saved apart."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import fleet

    os.environ["PADDLE_DISTRI_BACKEND"] = "gloo"  # CUDA tensors on gloo
    D.init_parallel_env()
    stage(f"phase16/20 rank {D.get_rank()}",
          "imports, CUDA and the process group")
    wait_go(rank_go(io, f"tp_{cell}"), f"phase16/20 rank {D.get_rank()}")
    t0 = time.perf_counter()
    dev = D.env.device()
    if "16" not in phases:
        zpp_save(io, zpp_rank_part(io, seed, dev, t0), t0)
        stage(f"phase16/20 rank {D.get_rank()}", "done")
        D.destroy_process_group()
        return
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict(dp_degree=1, mp_degree=TP_CELLS[cell]["tp"])
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    res = dict(rank=D.get_rank(), tp_rank=hcg.get_model_parallel_rank(),
               backend=D.get_backend(), device=str(dev),
               mesh=tuple(D.get_mesh().mesh_dim_names))
    sp = False
    if cell == "llama":
        # sequence parallelism needs all_gather and reduce_scatter on the
        # card's tensors, which gloo may lack
        res["gloo_cuda_ops"] = ops = gloo_cuda_ops(dev)
        sp = ops["all_gather"] is True and ops["reduce_scatter"] is True
    res["sequence_parallel"] = sp
    res.update(tp_cell(cell, seed, dev, faults=cell == "gpt", sp=sp))
    res["process_s"] = time.perf_counter() - t0
    torch.save(res, os.path.join(io, f"tp_{cell}_rank{res['rank']}.pt"))
    stage(f"phase16/20 rank {D.get_rank()}", f"phase 16 {cell}")
    if "20" in phases:
        del res
        zpp_save(io, zpp_rank_part(io, seed, dev, t0), t0)
    stage(f"phase16/20 rank {D.get_rank()}", "done")
    D.destroy_process_group()


def zpp_save(io, res, t0):
    res["process_s"] = time.perf_counter() - t0
    torch.save(res, os.path.join(io, f"zpp_rank{res['rank']}.pt"))


def tp_dist(got, want, init):
    """||got - want|| over the update ||want - init|| (f32 masters)."""
    moved = float((want - init).norm())
    check(moved > 0, "phase 16: a probe parameter did not move")
    return float((got - want).norm()) / moved


def tp_grad_dist(got, want):
    """||got - want|| over ||want|| (gradients)."""
    size = float(want.norm())
    check(size > 0, "phase 16: a probe parameter took no gradient")
    return float((got - want).norm()) / size


def tp_gathered(parts):
    """{name: the full probe} from every rank's {name: shard} (rank
    order), and "_replicated_equal": whether each replicated probe is
    equal on every rank, bit for bit."""
    from paddle_tpu_torch import weights as W

    out = {"_replicated_equal": True}
    for n in parts[0]:
        ps = [p[n] for p in parts]
        ax = W.tp_split_axis(n)
        if ax is None:
            out["_replicated_equal"] &= all(torch.equal(p, ps[0])
                                            for p in ps[1:])
            out[n] = ps[0]
        else:
            out[n] = torch.cat(ps, dim=ax)
    return out


# the bars, set from phase 16's probe runs (PERF.md, §6): bf16 partial
# products summed over the ranks by the all_reduces against one f32
# accumulation rounded once. The losses; the probes' gradients at the
# initial weights against the tp = 1 run's, over their norm (where the
# planted faults are held: no optimizer between); the f32 masters after
# the last step against the tp = 1 run's, over their update (Adam's first
# steps turn rounding-level gradient differences into sign flips of small
# elements, so this bar stands above the gradients')
TP_LOSS_TOL = 2e-3
TP_GRAD_BAR = 0.05
TP_PARAM_BAR = 0.12


def tp_start(cell, seed, phases=("16", "20")):
    """Start phase 16's `cell` ranks ahead (the GPT cell's run phase 20
    after, with "20" in `phases`)."""
    io = phase_dir("16")
    return start_spawn(f"tp_{cell}", io, tp_rank_proc,
                       (io, seed, cell, phases if cell == "gpt"
                        else ("16",)), TP_CELLS[cell]["tp"],
                       900 if cell == "gpt" else 400)


def tp_phase(seed, card, phases=("16", "20"), then=None):
    """Phase 16: the tp = 1 runs in this process, then (b) 2 ranks and (a)
    4 ranks on the card over gloo, each a group of its own, each started
    while the one before runs (`then` starts after the last); every
    reading is logged before any check. Phase 20 runs in (a)'s four ranks
    after their phase-16 results are saved (`phases`: ("20",) runs it
    alone); its readings are the result's "20"."""
    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    t_all = time.perf_counter()
    ref = {}
    cells = ("llama", "gpt") if "16" in phases else ()
    for cell in cells:
        t0 = time.perf_counter()
        ref[cell] = tp_cell(cell, seed, torch.device("cuda", 0))
        res[f"{cell}_ref_s"] = time.perf_counter() - t0
    ranks, zpp = {}, None
    io = phase_dir("16")
    order = cells or ("gpt",)
    for i, cell in enumerate(order):
        tp_start(cell, seed, phases)
        nxt = (lambda c=order[i + 1]: tp_start(c, seed, phases)) \
            if i + 1 < len(order) else then
        res[f"{cell}_spawn_s"] = join_spawn(f"tp_{cell}", nxt)
        if cell in cells:
            ranks[cell] = [torch.load(os.path.join(
                io, f"tp_{cell}_rank{r}.pt")) for r in
                range(TP_CELLS[cell]["tp"])]
    if "20" in phases:
        zpp = [torch.load(os.path.join(io, f"zpp_rank{r}.pt"))
               for r in range(ZPP_N)]
    drop_phase_dir("16")
    res["processes_s"] = time.perf_counter() - t_all
    if "16" not in phases:
        res["20"] = zpp_phase(zpp, card, res["processes_s"])
        return res
    labels = {"gpt": "(a) GPT-3 1.3B", "llama": "(b) LLaMA-2-7B widths"}
    for cell in ("gpt", "llama"):
        res[cell] = tp_readings(cell, labels[cell], ranks[cell], ref[cell],
                                card)
    ops = ranks["llama"][0]["gloo_cuda_ops"]
    sp = ranks["llama"][0]["sequence_parallel"]
    res["gloo_cuda_ops"], res["sequence_parallel"] = ops, sp
    log(f"phase 16 (b): gloo on CUDA tensors in torch {torch.__version__}: "
        f"{ops}; " + ("(b) ran with sequence parallelism on (LLaMA's "
                      "config.sequence_parallel)" if sp else
                      "sequence parallelism needs all_gather and "
                      "reduce_scatter, so it is held on the CPU only "
                      "(tests/test_torch_sequence_parallel.py, "
                      "test_torch_tensor_parallel.py)") + f" [{card}]")
    log(f"phase 16: {res['processes_s']:.1f} s (tp 1 in this process: (a) "
        f"{res['gpt_ref_s']:.1f}, (b) {res['llama_ref_s']:.1f}; spawns: "
        f"(b) {res['llama_spawn_s']:.1f}, (a) {res['gpt_spawn_s']:.1f}) "
        f"[{card}]")
    for cell in ("gpt", "llama"):
        tp_verify(cell, labels[cell], res[cell])
    res["launches"] = {}
    for cell in ("gpt", "llama"):
        for name, v in res[cell]["launches"].items():
            res["launches"][name] = res["launches"].get(name, 0) + v
    if zpp is not None:
        # phase 20's time: its ranks' own (the spawn's after phase 16's
        # GPT cell)
        res["20"] = zpp_phase(zpp, card, max(
            r["process_s"] for r in zpp) - max(
            r["process_s"] for r in ranks["gpt"]))
    return res


def tp_readings(cell, label, ranks, ref, card):
    """Phase 16's readings of one cell, the ranks against the tp = 1 run,
    logged (the checks are `tp_verify`'s)."""
    c = TP_CELLS[cell]
    L, tp = c["layers"], c["tp"]
    init = ref["init"]
    losses = ranks[0]["losses"]
    out = dict(label=cell, losses=losses, ref_losses=ref["losses"])
    out["ranks"] = [dict(rank=r["rank"], backend=r["backend"],
                         device=r["device"], mesh=r["mesh"],
                         losses=r["losses"], launches=r["launches"],
                         n_tensors=r["n_tensors"]) for r in ranks]
    out["loss_rel"] = rel = [abs(a - b) / abs(b)
                             for a, b in zip(losses, ref["losses"])]
    got = tp_gathered([r["probes"] for r in ranks])
    out["replicated_equal"] = got.pop("_replicated_equal")
    out["probe_dist"] = dist = {n: tp_dist(got[n], ref["probes"][n], init[n])
                                for n in got}
    g0 = tp_gathered([r["grads0"] for r in ranks])
    out["grads_replicated_equal"] = g0.pop("_replicated_equal")
    out["grad_dist"] = gdist = {n: tp_grad_dist(g0[n], ref["grads0"][n])
                                for n in g0}
    out["clip_rel"] = clip_rel = [
        abs(r["clip_norm"] - ref["clip_norm"]) / ref["clip_norm"]
        for r in ranks]
    ms = [float(np.median(r["step_ms"])) for r in ranks]
    comm = {op: v for op, v in ranks[0]["collectives"].items()
            if v["calls"]}
    sp = " with sequence parallelism" if ranks[0].get("sequence_parallel") \
        else ""
    log(f"phase 16 {label}: TP {tp}{sp} over gloo, {L} layers, bf16 O2, "
        f"AdamW({TP_LR}, f32 masters) under ClipGradByGlobalNorm(1.0), "
        f"batch 1 x {c['seq']}, {c['steps']} steps: losses {losses} (every "
        f"rank's equal: {all(r['losses'] == losses for r in ranks)}) "
        f"against tp 1's {ref['losses']}: rel {[f'{v:.3g}' for v in rel]} "
        f"(bar {TP_LOSS_TOL}); probe gradients at the initial weights over "
        f"their norm " + ", ".join(f"{n} {d:.3g}" for n, d in gdist.items())
        + f" (bar {TP_GRAD_BAR}); probe masters after step {c['steps']} over "
        f"their update " + ", ".join(f"{n} {d:.3g}" for n, d in dist.items())
        + f" (bar {TP_PARAM_BAR}; replicated ones equal on every rank: "
        f"{out['replicated_equal']}); the clip's global norm "
        f"{ranks[0]['clip_norm']:.6g} against {ref['clip_norm']:.6g}: rel "
        f"{max(clip_rel):.3g} (bar {TP_CLIP_TOL}) [{card}]")
    log(f"phase 16 {label}: {tp} ranks on ONE card over gloo (host-staged "
        f"collectives; no tensor-parallel speed): step ms p50 by rank "
        f"{[round(v, 1) for v in ms]} (tp 1 on the card: "
        f"{float(np.median(ref['step_ms'])):.1f}); a step a rank: "
        + ", ".join(f"{op} {v['calls'] / c['steps']:.0f} calls, "
                    f"{v['bytes'] / c['steps'] / 2 ** 20:.1f} MiB"
                    for op, v in comm.items()) + "; "
        f"launches a rank {ranks[0]['launches']}; setup "
        f"{[round(r['setup_s'], 1) for r in ranks]} s, processes "
        f"{[round(r['process_s'], 1) for r in ranks]} s, peak "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB [{card}]")
    faults = {"clip_counts_replicated_tp_times": min(
        abs(r["clip_fault_norm"] - ref["clip_norm"]) / ref["clip_norm"]
        for r in ranks)}
    if "faults" in ranks[0]:
        for fault in ranks[0]["faults"]:
            fg = tp_gathered([r["faults"][fault]["grads"] for r in ranks])
            fg.pop("_replicated_equal")
            faults[fault] = dict(
                loss_rel=abs(ranks[0]["faults"][fault]["loss"]
                             - ref["loss0"]) / abs(ref["loss0"]),
                grad_dist=max(tp_grad_dist(fg[n], ref["grads0"][n])
                              for n in fg))
        log(f"phase 16 {label}: planted faults, each a forward and "
            f"backward from the initial weights (each must exceed a bar): "
            f"{faults} [{card}]")
    out.update(faults=faults, step_ms_p50=ms, ref_step_ms=ref["step_ms"],
               collectives=comm, launches={
                   n: sum(r["launches"][n] for r in ranks)
                   for n in ranks[0]["launches"]})
    return out


def tp_verify(cell, label, out):
    """Phase 16's checks of one cell's readings (`tp_readings`)."""
    c = TP_CELLS[cell]
    L, tp = c["layers"], c["tp"]
    losses = out["losses"]
    for r in out["ranks"]:
        check(r["backend"] == "gloo" and r["device"].startswith("cuda")
              and r["mesh"] == ("tp",),
              f"phase 16 {label}: rank {r['rank']} on {r['device']} over "
              f"{r['backend']}, mesh {r['mesh']}")
        check(r["losses"] == losses,
              f"phase 16 {label}: rank {r['rank']}'s losses {r['losses']} "
              f"differ from rank 0's {losses}")
        want = {"flash_fwd": L, "flash_bwd": L, "adam": r["n_tensors"],
                "rms_norm": 2 * L + 1 if cell == "llama" else 0,
                "rms_norm_bwd": 2 * L + 1 if cell == "llama" else 0}
        for name, n in want.items():
            check(r["launches"][name] == n * c["steps"],
                  f"phase 16 {label}: rank {r['rank']}: {name} launched "
                  f"{r['launches'][name]} times in {c['steps']} steps, "
                  f"expected {n * c['steps']}")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"phase 16 {label}: losses {losses}")
    check(max(out["loss_rel"]) <= TP_LOSS_TOL,
          f"phase 16 {label}: losses {losses} against {out['ref_losses']}")
    check(out["replicated_equal"],
          f"phase 16 {label}: a replicated probe differs across ranks")
    check(out["grads_replicated_equal"],
          f"phase 16 {label}: a replicated probe's gradient differs across "
          f"ranks")
    check(max(out["grad_dist"].values()) <= TP_GRAD_BAR,
          f"phase 16 {label}: probe gradients {out['grad_dist']}")
    check(max(out["probe_dist"].values()) <= TP_PARAM_BAR,
          f"phase 16 {label}: probe masters {out['probe_dist']}")
    check(max(out["clip_rel"]) <= TP_CLIP_TOL,
          f"phase 16 {label}: clip norms off by {out['clip_rel']}")
    f = out["faults"]
    if "ce_rank_offset" not in f:
        # (LLaMA's replicated gradients, its norms' weights alone, are too
        # small a share of the norm for the clip fault to show there)
        return
    check(f["clip_counts_replicated_tp_times"] > TP_CLIP_TOL,
          f"phase 16 {label}: a clip counting the replicated gradients "
          f"{tp} times passed: {f['clip_counts_replicated_tp_times']}")
    for fault in ("identity_without_reduce", "ce_rank_offset"):
        check(f[fault]["loss_rel"] > TP_LOSS_TOL
              or f[fault]["grad_dist"] > TP_GRAD_BAR,
              f"phase 16 {label}: the planted fault {fault} passed: "
              f"{f[fault]}")


# ---------------------------------------------------------------------------
# phase 17: tensor-parallel serving
# ---------------------------------------------------------------------------

# (a) LLaMA-2-7B's widths at CELL7_LAYERS and (b) LLaMA-2-13B's at
# SERVE13_LAYERS, int8 weights and KV, each served by two engines, one a
# rank, on the one card over gloo, against this process serving the same
# full model at tp 1. The times are no tensor-parallel speed.
TPS_TP = 2
TPS_ENGINE = dict(max_batch=8, max_seq_len=4096, page_size=16)
TPS_NEW = 32
TPS_BURST = 8
TPS_13B_REQUESTS = 4
# planted fault 2's small run: the first requests of (a)'s traffic, greedy
TPS_FAULT_REQUESTS, TPS_FAULT_NEW = 2, 8
# the linears whose quantized shards (b) holds against the tp-1
# quantization, bit for bit: column shards and row shards
TPS_PROBES = ("llama.layers.0.self_attn.q_proj",
              "llama.layers.0.self_attn.o_proj",
              "llama.layers.0.mlp.up_proj", "llama.layers.0.mlp.down_proj")
# the bar on the tp-2 prefill's last-position logits (gathered) against tp
# 1's, max |diff| over max |logit|: bf16 partial products rounded on each
# rank and summed in bf16, against one f32 accumulation rounded once. On
# an H100 (PERF.md, §6) (a) reads about 0.05, the size of the bf16
# tp-1 model's own distance from its f32 copy, which the phase reads
# beside it; a row linear without its all_reduce reads 1.3. It also
# bounds a near tie: a greedy stream may leave tp 1's only where tp 1's
# top-2 gap is within it times the largest |logit|
TPS_LOGIT_BAR = 0.1
# (b)'s bar, the same two uses, from its readings at SERVE13_LAYERS (5) on
# H100s (PERF.md, §6): logits 0.02123 (0.03173 at 10 layers), near ties at
# top-2 gaps of 0.03125-0.125 where the largest |logit| is 5.8-6.4
TPS13_LOGIT_BAR = 0.05


def tps_traffic(seed, vocab):
    """(a)'s 8 requests: 5-1000 tokens, TPS_NEW new each, greedy and
    sampled alternating."""
    rng = np.random.RandomState(seed + 17)
    reqs = []
    for i in range(8):
        kw = {} if i % 2 == 0 else dict(decode_strategy="sampling",
                                        temperature=0.8, top_k=50,
                                        top_p=0.95)
        reqs.append((rng.randint(0, vocab, int(rng.randint(5, 1001))),
                     TPS_NEW, kw))
    return reqs


def tps_greedy(reqs, n=None, new=None):
    """The first `n` requests of `reqs`, greedy (with `new` tokens)."""
    return [(p, m if new is None else new, {}) for p, m, _ in reqs[:n]]


def tps_model(cell, seed, dev):
    """The cell's float model at the mesh's degree (tp 1 without one),
    bf16, its weights from `tp_load` (drawn per tensor on the card)."""
    cfg = llama7b_cell() if cell == "7b" else llama13b_cut()
    cfg.dtype = "bfloat16"
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    tp_load(model, "llama", seed)
    return model


def tps_probe(seed, vocab):
    return np.random.RandomState(seed + 170).randint(0, vocab, 200)


def plant_row_without_reduce(lin):
    """Planted fault 1: a row-parallel linear's forward without its
    all_reduce (each rank keeps its partial product); returns the undo."""
    lin.forward = lambda x: F.linear(x, lin.weight, lin.bias)
    return lambda: delattr(lin, "forward")


def tps_shard_shapes(cfg, tp):
    """(k, n) of the linears of one forward at a rank's shards: q, k, v,
    gate, up and the head by columns, o and down by rows."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * (h // cfg.num_attention_heads)
    return sorted({(h, h // tp), (h, kv // tp), (h // tp, h), (h, i // tp),
                   (i // tp, h), (h, cfg.vocab_size // tp)})


def comm_delta(after, before, k=1):
    """`CommCount` readings between two reads, over `k` steps."""
    return {op: {n: (after[op][n] - before[op][n]) / k for n in after[op]}
            for op in after}


def tps_per_decode_step(eng, comm):
    """Wrap `eng.step` so that each step that only decoded records its
    collectives (calls and bytes) a token step; returns the list."""
    per, real = [], eng.step

    def step():
        before, p0, d0 = comm.read(), eng.prefills, eng.decode_steps
        out = real()
        k = eng.decode_steps - d0
        if eng.prefills == p0 and k > 0:
            per.append(comm_delta(comm.read(), before, k))
        return out

    eng.step = step
    return per


def tps_launch_counters():
    krms.launches = kpa.launches = kpa.q8_launches = 0
    kqm.reset_launches()
    kmm.reset_launches()


def tps_read_launches():
    return dict(rms_norm=krms.launches, paged_attention=kpa.launches,
                paged_attention_int8=kpa.q8_launches,
                quant_matmul_prefill=kqm.kernel_launches["prefill"],
                quant_matmul_decode=kqm.kernel_launches["decode"],
                quant_matmul_split=kqm.kernel_launches["split"],
                matmul=kmm.launches,
                matmul_by_variant=dict(kmm.variant_launches))


def tps_counted(eng, reqs, comm):
    """`drive` the engine over `reqs` with the kernels' counts set to 0
    just before and read just after; the collectives a decode step."""
    per = tps_per_decode_step(eng, comm)
    f0, d0 = eng.prefills, eng.decode_steps
    tps_launch_counters()
    c0 = comm.read()
    try:
        out = drive(eng, reqs)
    finally:
        del eng.step
    out["launches"] = tps_read_launches()
    out.update(prefills=eng.prefills - f0, token_steps=eng.decode_steps - d0,
               collectives=comm_delta(comm.read(), c0),
               per_decode_step=per[-1] if per else None)
    return out


def tps_rank_7b(seed, dev, tune_dir, comm):
    """Cell (a) on this rank: the tuner fills this rank's own table (the
    decode bucket at the rank's heads through `warmup`, the GEMM's buckets
    of the traffic's shard linears), the GEMM kernel is pinned in every
    bucket (`pin_kernel_winners`: the ranks time candidates against each
    other on one card), then, readonly, the traffic on the eager engine
    and on decode_burst 8, counted from zero; planted faults 1 and 2."""
    model = tps_model("7b", seed, dev)
    cfg = model.config
    reqs = tps_traffic(seed, cfg.vocab_size)
    res = dict(q_heads=model.llama.layers[0].self_attn.num_heads)
    set_flags({"FLAGS_autotune": "on", "FLAGS_autotune_cache_dir": tune_dir,
               "FLAGS_paged_grouped_kernel": False})
    autotune.reset_tuner()
    t0 = time.perf_counter()
    eng = ServingEngine(model, seed=seed, device=dev, **TPS_ENGINE)
    eng.warmup()
    # every request is admitted at once: one prefill of 8 rows of the
    # longest prompt, page-rounded, then decode at 8 rows
    page = TPS_ENGINE["page_size"]
    m_prefill = 8 * -(-max(len(p) for p, _, _ in reqs) // page) * page
    for k, n in tps_shard_shapes(cfg, TPS_TP):
        for m in (m_prefill, TPS_ENGINE["max_batch"]):
            check(kmm.supports(m, k, n, dtype=torch.bfloat16),
                  f"phase 17 (a): the GEMM does not take [{m}, {k}] x "
                  f"[{k}, {n}]")
            autotune.choose_matmul(m, k, n, torch.bfloat16)
    res["table"] = pin_kernel_winners()
    set_flags({"FLAGS_autotune": "readonly"})
    res["tune_s"] = time.perf_counter() - t0
    res["pools"] = tuple(eng.k_pages[0].shape)
    res["graphs"] = (eng._graphs, eng._spec_graphs)
    res["sync"] = tps_counted(eng, reqs, comm)
    del eng
    torch.cuda.empty_cache()
    eng = ServingEngine(model, seed=seed, device=dev,
                        decode_burst=TPS_BURST, **TPS_ENGINE)
    res["burst"] = tps_counted(eng, reqs, comm)
    res["burst"]["graph_captures"] = eng.graph_captures
    # planted fault 1: layer 0's o_proj without its all_reduce, read by
    # the prefill's last logits (both ranks skip it alike)
    probe = tps_probe(seed, cfg.vocab_size)
    res["logits"] = last_logits(model, probe, dev).cpu()
    undo = plant_row_without_reduce(model.llama.layers[0].self_attn.o_proj)
    try:
        res["fault_no_reduce_logits"] = last_logits(model, probe, dev).cpu()
    finally:
        undo()
    # planted fault 2: the engine samples from the rank's vocab shard
    model.gather_logits = lambda logits: logits
    try:
        res["fault_shard_sampled"] = drive(eng, tps_greedy(
            reqs, TPS_FAULT_REQUESTS, TPS_FAULT_NEW))["streams"]
    finally:
        del model.gather_logits
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    set_flags({"FLAGS_autotune": "off"})
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tps_rank_13b(seed, dev, comm):
    """Cell (b) on this rank: the float shards, planted fault 3 (layer 0's
    o_proj shard quantized with its local absmax), `quantize_for_inference`
    (int8 per channel, lm_head kept), the probes' quantized shards, then
    4 greedy requests over int8 KV counted from zero."""
    model = tps_model("13b", seed, dev)
    o = model.llama.layers[0].self_attn.o_proj
    res = dict(fault_local_absmax=[t.cpu() for t in weight_quantize(
        o.weight, "weight_only_int8")])
    quantize_for_inference(model, exclude=("lm_head",))
    mods = dict(model.named_modules())
    res["probes"] = {n: (mods[n].quant_weight.cpu(),
                         mods[n].weight_scale.cpu(), mods[n]._shard[0])
                     for n in TPS_PROBES}
    reqs = tps_greedy(tps_traffic(seed, model.config.vocab_size),
                      TPS_13B_REQUESTS)
    eng = ServingEngine(model, seed=seed, device=dev, kv_cache_quant="int8",
                        **TPS_ENGINE)
    res["pools"] = tuple(eng.k_pages[0].shape)
    res["scales"] = tuple(eng.k_scales[0].shape)
    res["run"] = tps_counted(eng, reqs, comm)
    res["logits"] = last_logits(
        model, tps_probe(seed, model.config.vocab_size), dev).cpu()
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tps_rank_proc(io, seed):
    """One rank of phase 17: gloo over CUDA tensors on the one card
    (PADDLE_DISTRI_BACKEND), fleet.init at mp_degree 2, cells (a) and
    (b)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import fleet

    # the ranks' host work is the engine's and gloo's staging: a few
    # threads each keep them off one another's cores
    torch.set_num_threads(2)
    os.environ["PADDLE_DISTRI_BACKEND"] = "gloo"  # CUDA tensors on gloo
    D.init_parallel_env()
    stage(f"phase17 rank {D.get_rank()}",
          "imports, CUDA and the process group")
    wait_go(rank_go(io, "tps"), f"phase17 rank {D.get_rank()}")
    t0 = time.perf_counter()
    dev = D.env.device()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict(dp_degree=1, mp_degree=TPS_TP)
    fleet.init(is_collective=True, strategy=strategy)
    rank = D.get_rank()
    res = dict(rank=rank, backend=D.get_backend(), device=str(dev),
               mesh=tuple(D.get_mesh().mesh_dim_names))
    comm = CommCount(("all_reduce", "all_gather"))
    try:
        t1 = time.perf_counter()
        res["7b"] = tps_rank_7b(seed, dev, os.path.join(io, f"tune{rank}"),
                                comm)
        res["7b_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        res["13b_int8"] = tps_rank_13b(seed, dev, comm)
        res["13b_int8_s"] = time.perf_counter() - t1
    finally:
        comm.close()
    res["process_s"] = time.perf_counter() - t0
    torch.save(res, os.path.join(io, f"tps_rank{rank}.pt"))
    stage(f"phase17 rank {D.get_rank()}", "done")
    D.destroy_process_group()


def tps_reference(seed, dev):
    """This process at tp 1: (a) the eager engine over the traffic (and
    fault 2's small run), the probe's logits; (b) the 13B model quantized
    whole (its probes' int8 weights and scales: the tp-1 quantization)
    serving 4 greedy requests over int8 KV. The models stay for the
    near-tie reads."""
    set_flags({"FLAGS_autotune": "off"})
    out = {}
    t0 = time.perf_counter()
    model = tps_model("7b", seed, dev)
    reqs = tps_traffic(seed, model.config.vocab_size)
    eng = ServingEngine(model, seed=seed, device=dev, **TPS_ENGINE)
    probe = tps_probe(seed, model.config.vocab_size)
    out["7b"] = dict(sync=drive(eng, reqs), fault_small=drive(
        eng, tps_greedy(reqs, TPS_FAULT_REQUESTS, TPS_FAULT_NEW))["streams"],
        logits=last_logits(model, probe, dev).cpu(), model=model, reqs=reqs)
    del eng
    torch.cuda.empty_cache()
    # the bf16 rounding's own size: the same weights in f32
    cfg32 = llama7b_cell()
    f32 = LlamaForCausalLM(cfg32, device=dev, seed=seed)
    f32.load_state_dict(model.state_dict())
    out["7b"]["logits_f32"] = last_logits(f32, probe, dev).cpu()
    del f32
    model = tps_model("13b", seed, dev)
    quantize_for_inference(model, exclude=("lm_head",))
    mods = dict(model.named_modules())
    reqs13 = tps_greedy(reqs, TPS_13B_REQUESTS)
    eng = ServingEngine(model, seed=seed, device=dev, kv_cache_quant="int8",
                        **TPS_ENGINE)
    out["13b_int8"] = dict(
        run=drive(eng, reqs13), model=model, reqs=reqs13,
        probes={n: (mods[n].quant_weight.cpu(), mods[n].weight_scale.cpu())
                for n in TPS_PROBES},
        logits=last_logits(model, tps_probe(seed, model.config.vocab_size),
                           dev).cpu())
    del eng
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def tps_kernel_checks(seed, dev):
    """The kernels at the ranks' shard shapes against their plain versions
    (phase 3's cases): decode at 16 heads of 128 (7B) and int8 decode at
    20 (13B), the dequant matmul at 13B's row shard (6912 -> 5120) and
    column shard (5120 -> 6912) at 8 rows, the GEMM at 7B's head shard
    (4096 -> 16000) at 8 rows. Launches here are not the main path's."""
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    bf16 = torch.bfloat16
    lens = [0, 1, 15, 16, 17, 1000, 2049, 4096]
    out = dict(
        paged=paged_case("tp2_7b_shard", bf16, 16, 16, gen, dev, lens,
                         timed=False),
        paged_q8=paged_q8_case("tp2_13b_shard", bf16, 20, 20, gen, dev,
                               lens, timed=False),
        qmm_row=qmm_case("tp2_13b_row 6912->5120 m8", 8, 6912, 5120, "int8",
                         -1, bf16, gen, dev, timed=False),
        qmm_column=qmm_case("tp2_13b_column 5120->6912 m8", 8, 5120, 6912,
                            "int8", -1, bf16, gen, dev, timed=False),
        mm=mm_case("tp2_7b_head 4096->16000 m8", 8, 4096, 16000, bf16, gen,
                   dev, timed=False))
    return out


def tps_streams_hold(model, dev, reqs, ranks, want, tag, card,
                     bar=TPS_LOGIT_BAR):
    """The stream holds: every rank's streams equal bit for bit, and each
    greedy one equal to tp 1's or first differing at a near tie
    (`judge_streams` at `bar`). Raises on a failure."""
    for r in ranks[1:]:
        check(r == ranks[0], f"phase 17 {tag}: the ranks' streams differ")
    greedy = [i for i, (_, _, kw) in enumerate(reqs) if not kw]
    return judge_streams(model, dev, [reqs[i][0] for i in greedy],
                         [ranks[0][i] for i in greedy],
                         [want[i] for i in greedy], bar, tag,
                         card, phase=17)


def tps_start(seed):
    """Start phase 17's two ranks ahead."""
    io = phase_dir("17")
    return start_spawn("tps", io, tps_rank_proc, (io, seed), TPS_TP, 300)


def tps_phase(seed, card, then=None):
    """Phase 17: the kernels at the shard shapes, the tp-1 runs in this
    process, then both cells on two gloo ranks spawned once (started
    while the phase before runs; `then` starts after them); every reading
    logged before its check."""
    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    t_all = time.perf_counter()
    res = dict(kernels=tps_kernel_checks(seed, dev))
    for name, r in res["kernels"].items():
        log(f"phase 17: kernel {name} {r['case']} at the shard shape: "
            + (f"row rel err {r['row_rel_err']:.3g} (bar {r['tol']:.3g})"
               if "row_rel_err" in r else
               f"max abs err {r['max_abs_err']:.3g} (tol {r['tol']:.3g})")
            + " vs plain; controls " + ", ".join(
                f"{k} {v:.3g}" for k, v in r.get("controls", {}).items())
            + f" [{card}]")
    res["kernels_s"] = time.perf_counter() - t_all
    t0 = time.perf_counter()
    ref = tps_reference(seed, dev)
    res["ref_s"] = time.perf_counter() - t0
    io = phase_dir("17")
    tps_start(seed)
    res["spawn_s"] = join_spawn("tps", then)
    ranks = [torch.load(os.path.join(io, f"tps_rank{r}.pt"))
             for r in range(TPS_TP)]
    drop_phase_dir("17")
    res["7b"] = tps_cell_7b(ranks, ref["7b"], dev, card)
    res["13b_int8"] = tps_cell_13b(ranks, ref["13b_int8"], dev, card)
    res["phase_s"] = time.perf_counter() - t_all
    log(f"phase 17: {res['phase_s']:.1f} s (kernel checks "
        f"{res['kernels_s']:.1f}, tp 1 in this process {res['ref_s']:.1f}, "
        f"the ranks' spawn {res['spawn_s']:.1f}: processes "
        f"{[round(r['process_s'], 1) for r in ranks]} s, (a) "
        f"{[round(r['7b_s'], 1) for r in ranks]}, (b) "
        f"{[round(r['13b_int8_s'], 1) for r in ranks]}) [{card}]")
    launches = {}
    for r in ranks:
        for run in (r["7b"]["sync"], r["7b"]["burst"], r["13b_int8"]["run"]):
            for name, n in run["launches"].items():
                if name == "matmul_by_variant":
                    for v, k in n.items():
                        launches.setdefault(name, {})
                        launches[name][v] = launches[name].get(v, 0) + k
                else:
                    launches[name] = launches.get(name, 0) + n
    res["launches"] = launches
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tps_rank_checks(ranks, cell, kvh):
    """Each rank on gloo over the card, in a mesh of "tp", its pools at
    kv_heads / 2."""
    for r in ranks:
        check(r["backend"] == "gloo" and r["device"].startswith("cuda")
              and r["mesh"] == ("tp",),
              f"phase 17: rank {r['rank']} on {r['device']} over "
              f"{r['backend']}, mesh {r['mesh']}")
        check(r[cell]["pools"][0] == kvh // TPS_TP,
              f"phase 17 {cell}: rank {r['rank']}'s pools hold "
              f"{r[cell]['pools'][0]} KV heads, expected {kvh // TPS_TP}")


def tps_cell_7b(ranks, ref, dev, card):
    model, reqs = ref["model"], ref["reqs"]
    cfg = model.config
    L, label = cfg.num_hidden_layers, "(a) LLaMA-2-7B widths"
    a = [r["7b"] for r in ranks]
    out = {}
    dist = logit_distance(a[0]["logits"], ref["logits"])
    fault1 = logit_distance(a[0]["fault_no_reduce_logits"], ref["logits"])
    # readings, not gates: each bf16 run against the f32 copy
    out["f32_dist"] = dict(
        tp2=logit_distance(a[0]["logits"], ref["logits_f32"]),
        tp1=logit_distance(ref["logits"], ref["logits_f32"]))
    out.update(logit_dist=dist, fault_no_reduce_dist=fault1,
               logits_equal=all(torch.equal(x["logits"], a[0]["logits"])
                                for x in a))
    for mode in ("sync", "burst"):
        runs = [x[mode] for x in a]
        per = runs[0]["per_decode_step"]
        out[mode] = dict(
            ms_per_decode_step_p50=[x["ms_per_decode_step_p50"]
                                    for x in runs],
            ttft_ms=[x["ttft_ms"] for x in runs],
            prefills=runs[0]["prefills"], token_steps=runs[0]["token_steps"],
            launches=[x["launches"] for x in runs],
            collectives=runs[0]["collectives"], per_decode_step=per)
        how = f"decode_burst {TPS_BURST}" if mode == "burst" \
            else "one step a dispatch"
        out[mode]["ms_per_token_step"] = [x["ms_per_token_step"]
                                          for x in runs]
        log(f"phase 17 {label} at {L} of 32 layers, TP {TPS_TP} over gloo, "
            f"bf16, {mode} ({how}; eager at tp > 1): "
            f"{runs[0]['prefills']} prefills, {runs[0]['token_steps']} token "
            f"steps; decode ms a token step by rank "
            f"{out[mode]['ms_per_token_step']} (tp 1 eager: "
            f"{ref['sync']['ms_per_token_step']}); TTFT p50 by rank "
            f"{[float(np.median(x['ttft_ms'])) for x in runs]} ms; a decode "
            f"step a rank: " + ", ".join(
                f"{op} {v['calls']:.0f} calls, {v['bytes'] / 2 ** 10:.1f} KiB"
                for op, v in (per or {}).items())
            + "; the run a rank: " + ", ".join(
                f"{op} {v['calls']:.0f} calls, {v['bytes'] / 2 ** 20:.1f} MiB"
                for op, v in runs[0]["collectives"].items())
            + f"; launches a rank {runs[0]['launches']} (two ranks share "
            f"ONE card: no tensor-parallel speed) [{card}]")
    log(f"phase 17 {label}: the prefill's last logits of a 200-token probe, "
        f"tp 2 against tp 1: {dist:.4g} of the largest (bar "
        f"{TPS_LOGIT_BAR}), equal on both ranks: {out['logits_equal']}; "
        f"against the same weights in f32: tp 2 {out['f32_dist']['tp2']:.4g}"
        f", tp 1 {out['f32_dist']['tp1']:.4g}; "
        f"planted fault 1 (layer 0's o_proj without its all_reduce): "
        f"{fault1:.4g} (must exceed the bar); the GEMM's buckets pinned on "
        f"each rank: {len(a[0]['table'])} entries, tuned in "
        f"{[round(x['tune_s'], 1) for x in a]} s [{card}]")
    check(out["logits_equal"], f"phase 17 {label}: the ranks' logits differ")
    check(dist <= TPS_LOGIT_BAR, f"phase 17 {label}: logits {dist:.4g} off")
    check(fault1 > TPS_LOGIT_BAR,
          f"phase 17 {label}: planted fault 1 passed the bar: {fault1:.4g}")
    kvh = cfg.num_key_value_heads
    tps_rank_checks(ranks, "7b", kvh)
    want = ref["sync"]["streams"]
    for mode in ("sync", "burst"):
        out[mode]["diffs"] = tps_streams_hold(
            model, dev, reqs, [x[mode]["streams"] for x in a], want,
            f"{label} {mode}", card)
        for r, x in zip(ranks, a):
            run = x[mode]
            la = run["launches"]
            fwd = run["prefills"] + run["token_steps"]
            for name, n in (("paged_attention", L * run["token_steps"]),
                            ("rms_norm", (2 * L + 1) * fwd),
                            ("matmul", (7 * L + 1) * fwd),
                            ("paged_attention_int8", 0),
                            ("quant_matmul_decode", 0)):
                check(la[name] == n and (n > 0 or name.endswith(
                    ("int8", "decode"))),
                      f"phase 17 {label} {mode}: rank {r['rank']}: {name} "
                      f"launched {la[name]} times, expected {n}")
    for r, x in zip(ranks, a):
        check(x["graphs"] == (False, False)
              and x["burst"]["graph_captures"] == 0,
              f"phase 17 {label}: rank {r['rank']} captured a graph at tp 2")
        check(x["q_heads"] == cfg.num_attention_heads // TPS_TP,
              f"phase 17 {label}: rank {r['rank']} runs {x['q_heads']} heads")
    # planted fault 2: sampling from the vocab shard, held by the streams
    small = tps_greedy(reqs, TPS_FAULT_REQUESTS, TPS_FAULT_NEW)
    try:
        tps_streams_hold(model, dev, small,
                         [x["fault_shard_sampled"] for x in a],
                         ref["fault_small"], f"{label} fault 2", card)
        caught = None
    except AssertionError as e:
        caught = str(e)
    out["fault_shard_sampled"] = caught
    log(f"phase 17 {label}: planted fault 2 (the engine samples the rank's "
        f"vocab shard): streams by rank "
        f"{[x['fault_shard_sampled'] for x in a]} against tp 1's "
        f"{ref['fault_small']}: caught: {caught} [{card}]")
    check(caught is not None,
          f"phase 17 {label}: planted fault 2 passed the stream holds")
    out["peak_gib"] = [x["peak_gib"] for x in a]
    return out


def tps_cell_13b(ranks, ref, dev, card):
    model, reqs = ref["model"], ref["reqs"]
    cfg = model.config
    L, label = cfg.num_hidden_layers, "(b) LLaMA-2-13B widths int8"
    b = [r["13b_int8"] for r in ranks]
    tps_rank_checks(ranks, "13b_int8", cfg.num_key_value_heads)
    out = dict(logit_dist=logit_distance(b[0]["logits"], ref["logits"]))
    # the quantized shards against the tp-1 quantization's slices
    mismatched = []
    for rank, x in enumerate(b):
        for name, (qw, sc, kind) in x["probes"].items():
            fq, fs = ref["probes"][name]
            ax = 1 if kind == "column" else 0
            n = fq.shape[ax] // TPS_TP
            want_q = fq.narrow(ax, rank * n, n)
            want_s = fs.narrow(0, rank * n, n) if kind == "column" else fs
            if not (torch.equal(qw, want_q) and torch.equal(sc, want_s)):
                mismatched.append((rank, name))
    fq, fs = ref["probes"]["llama.layers.0.self_attn.o_proj"]
    n = fq.shape[0] // TPS_TP
    fault3 = [not (torch.equal(x["fault_local_absmax"][0],
                               fq.narrow(0, r * n, n))
                   and torch.equal(x["fault_local_absmax"][1], fs))
              for r, x in enumerate(b)]
    run = [x["run"] for x in b]
    out.update(mismatched=mismatched, fault_local_absmax_caught=fault3,
               ms_per_decode_step_p50=[x["ms_per_decode_step_p50"]
                                       for x in run],
               launches=[x["launches"] for x in run],
               collectives=run[0]["collectives"],
               per_decode_step=run[0]["per_decode_step"])
    log(f"phase 17 {label} at {L} of 40 layers, TP {TPS_TP} over gloo, int8 "
        f"weights per channel (lm_head bf16) and int8 KV, "
        f"{TPS_13B_REQUESTS} greedy requests: decode ms a step p50 by rank "
        f"{[x['ms_per_decode_step_p50'] for x in run]} (tp 1: "
        f"{ref['run']['ms_per_decode_step_p50']}); a decode step a rank: "
        + ", ".join(f"{op} {v['calls']:.0f} calls, "
                    f"{v['bytes'] / 2 ** 10:.1f} KiB"
                    for op, v in (run[0]["per_decode_step"] or {}).items())
        + f"; launches a rank {run[0]['launches']}; probe logits tp 2 vs tp "
        f"1 {out['logit_dist']:.4g} (bar {TPS13_LOGIT_BAR}); quantized "
        f"shards that are not slices of "
        f"the tp-1 quantization: {mismatched}; planted fault 3 (a row shard "
        f"quantized with its local absmax) caught by rank: {fault3} "
        f"[{card}]")
    check(out["logit_dist"] <= TPS13_LOGIT_BAR,
          f"phase 17 {label}: logits {out['logit_dist']:.4g} off")
    check(not mismatched, f"phase 17 {label}: shards {mismatched} are not "
          f"slices of the tp-1 quantization")
    check(all(fault3), f"phase 17 {label}: planted fault 3 passed: {fault3}")
    check(all(x["scales"][0] == cfg.num_key_value_heads // TPS_TP
              for x in b), f"phase 17 {label}: the scale pools' heads")
    out["diffs"] = tps_streams_hold(model, dev, reqs,
                                    [x["streams"] for x in run],
                                    ref["run"]["streams"], label, card,
                                    bar=TPS13_LOGIT_BAR)
    for r, x in zip(ranks, run):
        la, fwd = x["launches"], x["prefills"] + x["token_steps"]
        for name, n in (("paged_attention_int8", L * x["token_steps"]),
                        ("paged_attention", 0),
                        ("rms_norm", (2 * L + 1) * fwd),
                        ("quant_matmul_decode", 7 * L * x["token_steps"]),
                        ("quant_matmul_prefill", 7 * L * x["prefills"])):
            check(la[name] == n, f"phase 17 {label}: rank {r['rank']}: "
                  f"{name} launched {la[name]} times, expected {n}")
    return out


# ---------------------------------------------------------------------------
# phase 18: ZeRO stages 1-3 and the auto-parallel API
# ---------------------------------------------------------------------------

# LLaMA-2-7B's widths at ZERO_LAYERS, bf16 O2, AdamW with f32 masters,
# batch 1 x ZERO_SEQ a rank, on two gloo ranks of the one card over a
# "sharding" axis of 2: stages 0 (the per-parameter average), 1
# (`fleet.distributed_optimizer`), 2 and 3 (`group_sharded_parallel`) in
# turn from the same seeded weights. The times are no ZeRO speed.
ZERO_N = 2
ZERO_LAYERS = 2
ZERO_SEQ = 4096
ZERO_STEPS = 2
ZERO_LR = 1e-4
ZERO_CE_CHUNKS = 8
ZERO_LEVEL = {2: "os_g", 3: "p_g_os"}
# the f32 masters (and first moments) compared across the stages: a
# column- and a row-split linear of layer 0, layer 1's output projection,
# and two norms (the final one in stage 3's root block)
ZERO_PROBES = ("llama.layers.0.self_attn.q_proj.weight",
               "llama.layers.1.self_attn.o_proj.weight",
               "llama.layers.0.input_layernorm.weight", "llama.norm.weight")
ZERO_MOMENT_BAR = TP_GRAD_BAR  # first moments: the gradients' bar
ZERO_DT_SHAPE = (4096, 11008)


def zero_model(seed, dev):
    """LLaMA-2-7B's widths at ZERO_LAYERS, bf16 O2, the chunked LM-head
    loss, the seeded weights of phase 16 (`tp_load`)."""
    cfg = LlamaConfig.llama2_7b()
    cfg.dtype = "bfloat16"
    cfg.num_hidden_layers = ZERO_LAYERS
    cfg.fused_ce_chunks = ZERO_CE_CHUNKS
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    tp_load(model, "llama", seed)
    return model


def zero_batch(seed, rank, dev):
    """This rank's own rows (the batch goes over dp x sharding)."""
    rng = np.random.RandomState(seed + 18 + 1000 * rank)
    ids = torch.from_numpy(rng.randint(0, TP_DATA_VOCAB,
                                       (1, ZERO_SEQ + 1))).to(dev)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def zero_probe_state(opt, eng, model):
    """{name: (lo, hi, f32 master piece, first-moment piece)} of the
    probes on this rank (the whole at stage 0; lo == hi where the rank
    holds none), CPU copies."""
    inner = getattr(opt, "_inner_opt", opt)
    pos = {id(p): i for i, p in enumerate(inner._parameter_list)}
    params = dict(model.named_parameters())
    out = {}
    for n in ZERO_PROBES:
        p = params[n]
        lo, hi = 0, p.numel()
        if eng is not None:
            b, j = eng._where[id(p)]
            lo = hi = 0
            for jj, a, z, _ in b.pieces:
                if jj == j:
                    lo, hi = a, z
        st = inner._accumulators.get(pos[id(p)])
        if st is None or lo == hi:
            out[n] = (0, 0, None, None)
            continue
        out[n] = (lo, hi, st["master_weight"].detach().reshape(-1).cpu()
                  .clone(), st["moment1"].detach().reshape(-1).cpu().clone())
    return out


def zero_dist(pieces, base, init=None):
    """Squared distance of this rank's pieces from the whole stage-0
    values `base` (and squared size: of the update from `init`, else of
    `base`), over the pieces: (sq diff, sq size, bit-equal)."""
    diff = size = 0.0
    equal = True
    for lo, hi, got in pieces:
        if got is None:
            continue
        want = base[lo:hi]
        ref = want - init[lo:hi] if init is not None else want
        diff += float((got - want).double().square().sum())
        size += float(ref.double().square().sum())
        equal &= torch.equal(got, want)
    return diff, size, equal


class ZeroFaults:
    """The planted faults, each on one engine instance (the rank's
    collectives stay the same, so no rank hangs)."""

    @staticmethod
    def reduce_without_divide(eng):
        """The reduce_scatter sums over the axis and does not divide by N."""
        from paddle_tpu_torch.distributed import collective as C

        def reduce(b, flat):
            out = torch.empty(b.shard_size, dtype=flat.dtype,
                              device=flat.device)
            C.reduce_scatter(out, list(flat.chunk(eng.n)),
                             op=C.ReduceOp.SUM, group=eng.axis)
            return out

        eng._reduce = reduce

    @staticmethod
    def gather_at_rank0_offset(eng):
        """Rank 1 writes the gathered rank-0 slice where its own goes."""
        plain = eng._all_gather

        def gather(full, mine):
            plain(full, mine)
            if eng.rank == 1:
                chunks = full.chunk(eng.n)
                chunks[1].copy_(chunks[0])

        eng._all_gather = gather

    @staticmethod
    def no_gather_before_backward(eng):
        """Stage 3 without the gather before a block's backward: the block's
        storage is grown back but nothing is gathered into it (zeros;
        reading the released storage itself would be an illegal address,
        which ends the process's CUDA context)."""
        def regrow(u):
            for b in u.buckets:
                if not b.gathered:
                    b.full.untyped_storage().resize_(
                        b.size * b.full.element_size())
                    b.full.zero_()
                    b.gathered = True

        def after(u, out):
            if torch._C._current_graph_task_id() != -1:
                return
            eng.free_unit(u)
            if u.kind != "layer" or not torch.is_grad_enabled():
                return
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.requires_grad:
                    t.register_hook(lambda g, u=u: regrow(u))

        eng._after_block = after


def zero_stage(stage, seed, dev, rank, steps=ZERO_STEPS, fault=None):
    """One stage's run on this rank: the model and optimizer built fresh,
    `steps` steps of build_train_step with the kernels' launches and the
    engine's collectives counted; the bytes of gradients this rank holds
    after the backward, of optimizer state and parameters after the last
    step, the peak; the probes' masters and moments. `fault` plants one of
    `ZeroFaults` first."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding \
        .group_sharded import held_bytes

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = zero_model(seed, dev)
    init = {n: p.detach().float().reshape(-1).cpu().clone()
            for n, p in model.named_parameters() if n in ZERO_PROBES} \
        if stage == 0 and fault is None else None
    inner = AdamW(learning_rate=ZERO_LR, parameters=model.parameters(),
                  multi_precision=True)
    if stage == 0:
        opt = inner
        step = build_train_step(model, opt, sharding_stage=0)
    elif stage == 1:
        opt = fleet.distributed_optimizer(inner)
        step = build_train_step(model, opt)
    else:
        model, opt, _ = group_sharded_parallel(model, inner,
                                               level=ZERO_LEVEL[stage])
        step = build_train_step(model, opt)
    eng = step._zero
    check((eng is None) == (stage == 0) and (eng is None or (
        eng.stage == stage and eng.axis == "sharding" and eng.n == ZERO_N)),
        f"phase 18: stage {stage}'s step has engine {eng}")
    if fault is not None:
        getattr(ZeroFaults, fault)(eng)
    x, y = zero_batch(seed, rank, dev)
    held = {}

    def measure_grads(fn):
        def call(*a, **k):
            if "grads" not in held:
                held["grads"] = held_bytes(inner, eng)["grads"]
            return fn(*a, **k)
        return call

    if eng is None:
        inner.apply_gradients = measure_grads(inner.apply_gradients)
    else:
        eng.grad_slices = measure_grads(eng.grad_slices)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for _, mod, attr in TRAIN_COUNTERS:
        setattr(mod, attr, 0)
    D.collective.reset_calls()
    losses, ms, probes = [], [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(step(x, y)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        probes.append(zero_probe_state(opt, eng, model))
    launches = {n: getattr(mod, a) for n, mod, a in TRAIN_COUNTERS}
    calls = dict(D.collective.calls)
    after = held_bytes(inner, eng)
    # each parameter's sum and sum of squares (f64), equal on every rank
    # where the ranks hold equal parameters (not at stage 3: slices)
    digest = None if stage == 3 else {
        n: (float(p.detach().double().sum()),
            float(p.detach().double().square().sum()))
        for n, p in model.named_parameters()}
    res = dict(stage=stage, losses=losses, step_ms=ms, launches=launches,
               calls=calls, traffic=dict(eng.traffic) if eng else {},
               pieces=sum(len(b.pieces) for b in eng.buckets) if eng
               else None, buckets=len(eng.buckets) if eng else 0,
               n_tensors=len(list(model.parameters())),
               grads_bytes=held["grads"], state_bytes=after["state"],
               params_bytes=after["params"], probes=probes, init=init,
               digest=digest,
               n_params=sum(p.numel() for p in model.parameters()),
               setup_s=setup_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, opt, inner, step, eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def zero_dtensor(rank, n, dev):
    """`shard_tensor` / `reshard` of a bf16 ZERO_DT_SHAPE tensor on the
    card over a ProcessMesh of the `n` ranks: each local shard against the
    slice of the whole; each collective tried once (gloo's own error where
    it does not carry it on CUDA tensors)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.auto_parallel import (
        ProcessMesh, Replicate, Shard, shard_tensor)

    gen = torch.Generator(device=dev).manual_seed(18)
    whole = torch.randn(ZERO_DT_SHAPE, generator=gen, device=dev).to(
        torch.bfloat16)
    mesh = ProcessMesh(list(range(n)), dim_names=["x"])
    t = shard_tensor(whole, mesh, [Shard(0)])
    out = dict(shard0=torch.equal(t.to_local(), whole.chunk(n)[rank]),
               device=str(t.to_local().device))
    for name, placements, want in (
            ("replicate", [Replicate()], whole),
            ("shard1", [Shard(1)], whole.chunk(n, 1)[rank])):
        try:
            got = D.reshard(t, mesh, placements).to_local()
            torch.cuda.synchronize()
            out[name] = torch.equal(got, want)
        except RuntimeError as e:  # the backend's own error
            out[name] = "raises: " + str(e).splitlines()[0][:160]
    return out


def zero_rank_proc(io, seed, phases=("18", "19")):
    """One rank of phases 18 and 19 (or of one of them): gloo over CUDA
    tensors on the one card; phase 18: fleet.init at sharding_degree 2,
    the four stages, then the three planted faults; phase 19
    (`pp_rank_part`): fleet.init at pp_degree 2, its runs; phase 18's
    DTensor check last."""
    import faulthandler

    from paddle_tpu_torch import distributed as D

    faulthandler.enable()
    os.environ["PADDLE_DISTRI_BACKEND"] = "gloo"  # CUDA tensors on gloo
    D.init_parallel_env()
    stage(f"phase18-19 rank {D.get_rank()}",
          "imports, CUDA and the process group")
    wait_go(rank_go(io, "zero"), f"phase18-19 rank {D.get_rank()}")
    t0 = time.perf_counter()
    dev = D.env.device()
    if "18" in phases:
        rank = zero_rank_part(io, seed, dev, t0)
    if "19" in phases:
        pp = pp_rank_part(seed, dev, t0)
        pp["process_s"] = time.perf_counter() - t0
        torch.save(pp, os.path.join(io, f"pp_rank{pp['rank']}.pt"))
    if "18" in phases:
        # last, after the results are saved: DTensor's shard / reshard over
        # gloo on the card's tensors (a backend that lacks an op on them
        # may end the process: gloo's reshard does in torch 2.11)
        torch.save(zero_dtensor(rank, ZERO_N, dev),
                   os.path.join(io, f"zero_dtensor_rank{D.get_rank()}.pt"))
    stage(f"phase18-19 rank {D.get_rank()}", "done")
    D.destroy_process_group()


def zero_rank_part(io, seed, dev, t0):
    """Phase 18 on this rank; its results saved; its sharding rank."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict(dp_degree=1, sharding_degree=ZERO_N)
    fleet.init(is_collective=True, strategy=strategy)
    rank = fleet.get_hybrid_communicate_group().get_sharding_parallel_rank()
    res = dict(rank=D.get_rank(), sharding_rank=rank,
               backend=D.get_backend(), device=str(dev),
               mesh=tuple(D.get_mesh().mesh_dim_names))
    for stage in (0, 1, 2, 3):
        res[f"stage{stage}"] = zero_stage(stage, seed, dev, rank)
        log(f"phase 18: rank {rank}: stage {stage} at "
            f"{time.perf_counter() - t0:.1f} s")
    res["faults"] = dict(
        reduce_without_divide=zero_stage(
            1, seed, dev, rank, steps=1, fault="reduce_without_divide"),
        gather_at_rank0_offset=zero_stage(
            2, seed, dev, rank, fault="gather_at_rank0_offset"),
        no_gather_before_backward=zero_stage(
            3, seed, dev, rank, steps=1, fault="no_gather_before_backward"))
    res["process_s"] = time.perf_counter() - t0
    torch.save(res, os.path.join(io, f"zero_rank{res['rank']}.pt"))
    return rank


def zero_dtensor_nccl(dev):
    """The DTensor check at world 1 over NCCL, in this process (a group
    of one rank, torn down after)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.spawn import free_port

    keys = ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID", "PADDLE_LOCAL_SIZE",
            "PADDLE_LOCAL_RANK", "PADDLE_MASTER", "PADDLE_DISTRI_BACKEND")
    prev = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(PADDLE_TRAINERS_NUM="1", PADDLE_TRAINER_ID="0",
                      PADDLE_MASTER=f"127.0.0.1:{free_port()}")
    try:
        D.init_parallel_env(device=dev)
        return dict(backend=D.get_backend(), world=D.get_world_size(),
                    dtensor=zero_dtensor(0, 1, dev))
    finally:
        D.destroy_process_group()
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def zero_probe_dist(ranks, run, step, what):
    """{probe: (rel, bit-equal)}: the f32 masters ("master", over their
    update from the initial weights) or first moments ("moment", over
    their norm) of the pieces `run(rank result)` holds after `step`,
    against stage 0's, summed over both ranks."""
    k = 2 if what == "master" else 3
    out = {}
    for n in ZERO_PROBES:
        diff = size = 0.0
        equal = True
        for r in ranks:
            lo, hi, *vals = run(r)["probes"][step][n]
            base = r["stage0"]["probes"][step][n][k]
            init = r["stage0"]["init"][n] if what == "master" else None
            d, s, e = zero_dist([(lo, hi, vals[k - 2])], base, init)
            diff, size, equal = diff + d, size + s, equal and e
        out[n] = (math.sqrt(diff / size) if size else float("inf"), equal)
    return out


def zero_start(seed, phases=("18", "19")):
    """Start phases 18-19's two ranks ahead."""
    io = phase_dir("18")
    return start_spawn("zero", io, zero_rank_proc, (io, seed, phases),
                       ZERO_N, 600)


def zero_phase(seed, card, phases=("18", "19")):
    """Phases 18 and 19 (or one of them): two gloo ranks on the card run
    every ZeRO stage and its faults, then the pipeline's runs and faults,
    in one spawn (phase 17's ranks spent most of their time starting),
    started while the phase before runs; every reading logged before its
    check. {"18": phase 18's results, "19": phase 19's}."""
    gc.collect()
    torch.cuda.empty_cache()
    t_all = time.perf_counter()
    out = {}
    io = phase_dir("18")
    zero_start(seed, phases)
    try:
        join_spawn("zero")
        ended = None
    except RuntimeError as e:  # spawn's report; the results say more
        ended = str(e).splitlines()[0][:200]
    if "19" in phases:
        paths = [os.path.join(io, f"pp_rank{r}.pt") for r in range(PP_N)]
        if not all(os.path.exists(p) for p in paths):
            raise RuntimeError(f"phase 19: a rank ended before its "
                               f"results: {ended}")
        pp_ranks = sorted((torch.load(p) for p in paths),
                          key=lambda r: r["stage"])
    if "18" in phases:
        paths = [os.path.join(io, f"zero_rank{r}.pt")
                 for r in range(ZERO_N)]
        if not all(os.path.exists(p) for p in paths):
            raise RuntimeError(f"phase 18: a rank ended before its "
                               f"results: {ended}")
        ranks = sorted((torch.load(p) for p in paths),
                       key=lambda r: r["sharding_rank"])
        dts = [os.path.join(io, f"zero_dtensor_rank{r}.pt")
               for r in range(ZERO_N)]
        dt = [torch.load(p) for p in dts] if ended is None else \
            [dict(ranks_ended=ended)]
    elif ended is not None:
        raise RuntimeError(f"phase 19: the ranks failed: {ended}")
    drop_phase_dir("18")
    spawn_s = time.perf_counter() - t_all
    if "19" in phases:
        out["19"] = pp_phase(pp_ranks, card, spawn_s)
    if "18" in phases:
        out["18"] = zero_results(ranks, dt, card, spawn_s)
    return out


def zero_results(ranks, dt, card, spawn_s):
    """Phase 18's readings and checks."""
    t_res = time.perf_counter()
    carried = all(d.get(k) is True for d in dt
                  for k in ("shard0", "replicate", "shard1"))
    t0 = time.perf_counter()
    nccl = None if carried else zero_dtensor_nccl(torch.device("cuda", 0))
    dtensor_s = time.perf_counter() - t0
    res = dict(spawn_s=spawn_s, dtensor_s=dtensor_s, dtensor=dt,
               dtensor_nccl=nccl, gloo_carries_dtensor=carried)
    log(f"phase 18: DTensor on the card over gloo, {ZERO_DT_SHAPE} bf16 on "
        f"2 ranks: {dt}" + ("" if carried else
                           f"; gloo does not carry DTensor's collectives on "
                           f"CUDA tensors, so the check ran at world 1 over "
                           f"NCCL: {nccl}") + f" ({dtensor_s:.1f} s) [{card}]")
    stages = {s: [r[f"stage{s}"] for r in ranks] for s in (0, 1, 2, 3)}
    base = stages[0][0]
    n_params = base["n_params"]
    for s, rs in stages.items():
        masters = zero_probe_dist(ranks, lambda r: r[f"stage{s}"], -1,
                                  "master")
        moments = zero_probe_dist(ranks, lambda r: r[f"stage{s}"], -1,
                                  "moment")
        rel = [abs(a - b) / abs(b) for a, b in zip(rs[0]["losses"],
                                                   base["losses"])]
        res[f"stage{s}"] = dict(
            losses=[r["losses"] for r in rs], loss_rel=rel,
            masters=masters, moments=moments,
            bytes=[dict(state=r["state_bytes"], grads=r["grads_bytes"],
                        params=r["params_bytes"]) for r in rs],
            peak_gib=[r["peak_gib"] for r in rs],
            step_ms=[r["step_ms"] for r in rs],
            launches=[r["launches"] for r in rs],
            pieces=[r["pieces"] for r in rs],
            traffic=[r["traffic"] for r in rs], calls=[r["calls"] for r in rs])
        traffic = rs[0]["traffic"]
        log(f"phase 18 stage {s}: LLaMA-2-7B widths, {ZERO_LAYERS} layers, "
            f"bf16 O2, AdamW({ZERO_LR}, f32 masters), batch 1 x {ZERO_SEQ} "
            f"a rank, {ZERO_STEPS} steps: losses by rank "
            f"{[r['losses'] for r in rs]} against stage 0's "
            f"{base['losses']} (rel {[f'{v:.3g}' for v in rel]}, bar "
            f"{TP_LOSS_TOL}); probe masters over their update, (rel, "
            f"bit-equal): {masters} (bar {TP_PARAM_BAR}); first moments "
            f"{moments} (bar {ZERO_MOMENT_BAR}) [{card}]")
        log(f"phase 18 stage {s}: bytes a rank (state, grads after the "
            f"backward, params between steps): "
            + "; ".join(f"{r['state_bytes'] / 1e9:.3f}, "
                        f"{r['grads_bytes'] / 1e9:.3f}, "
                        f"{r['params_bytes'] / 1e9:.3f} GB" for r in rs)
            + f"; peak {[round(r['peak_gib'], 2) for r in rs]} GiB; step ms "
            f"by rank {[[round(v, 1) for v in r['step_ms']] for r in rs]}; "
            f"a step a rank: "
            + (", ".join(f"{k} {v / ZERO_STEPS:.0f}" if "bytes" not in k
                         else f"{k} {v / ZERO_STEPS / 2 ** 20:.1f} MiB"
                         for k, v in sorted(traffic.items())) or
               f"all_reduce calls {rs[0]['calls'].get('all_reduce', 0) / ZERO_STEPS:.0f}")
            + f"; launches a rank {rs[0]['launches']}; pieces "
            f"{[r['pieces'] for r in rs]} (two ranks on ONE card over "
            f"gloo: counts, not a speed) [{card}]")
    faults = {}
    f = {k: [r["faults"][k] for r in ranks] for k in ranks[0]["faults"]}
    def fault(name):
        return lambda r: r["faults"][name]

    faults["reduce_without_divide"] = dict(
        moments=zero_probe_dist(ranks, fault("reduce_without_divide"), 0,
                                "moment"),
        masters=zero_probe_dist(ranks, fault("reduce_without_divide"), 0,
                                "master"))
    g = f["gather_at_rank0_offset"]
    # step 2's loss against stage 0's; the parameters' digests across the
    # ranks after step 2
    faults["gather_at_rank0_offset"] = dict(
        step2_loss_rel=abs(g[0]["losses"][1] - base["losses"][1])
        / abs(base["losses"][1]),
        digests_differ=sorted(n for n in g[0]["digest"]
                              if g[0]["digest"][n] != g[1]["digest"][n]))
    faults["no_gather_before_backward"] = dict(
        moments=zero_probe_dist(ranks, fault("no_gather_before_backward"), 0,
                                "moment"),
        loss=f["no_gather_before_backward"][0]["losses"])
    res["faults"] = faults
    log(f"phase 18: planted faults (each must exceed its bar): {faults} "
        f"[{card}]")
    res["process_s"] = [r["process_s"] for r in ranks]
    res["phase_s"] = spawn_s + time.perf_counter() - t_res
    log(f"phases 18-19: {res['phase_s']:.1f} s (the ranks' spawn "
        f"{spawn_s:.1f}; phase 18 in the processes "
        f"{[round(v, 1) for v in res['process_s']]} s; DTensor "
        f"{dtensor_s:.1f}) [{card}]")
    zero_verify(ranks, stages, res, n_params)
    launches = {}
    for rs in stages.values():
        for r in rs:
            for name, n in r["launches"].items():
                launches[name] = launches.get(name, 0) + n
    res["launches"] = launches
    return res


def zero_verify(ranks, stages, res, n_params):
    """Phase 18's checks (`zero_phase` logged every reading first)."""
    for r in ranks:
        check(r["backend"] == "gloo" and r["device"].startswith("cuda")
              and r["mesh"] == ("sharding",),
              f"phase 18: rank {r['rank']} on {r['device']} over "
              f"{r['backend']}, mesh {r['mesh']}")
    dts = res["dtensor"] if res["gloo_carries_dtensor"] else \
        [res["dtensor_nccl"]["dtensor"]]
    for d in dts:
        check(d["shard0"] is True and d["replicate"] is True
              and d["shard1"] is True and d["device"].startswith("cuda"),
              f"phase 18: DTensor shards differ from slices of the whole: "
              f"{d}")
    whole = stages[0][0]
    for s, rs in stages.items():
        out = res[f"stage{s}"]
        for r in rs:
            check(r["losses"] == rs[0]["losses"]
                  and all(math.isfinite(v) for v in r["losses"]),
                  f"phase 18 stage {s}: the ranks' losses differ: "
                  f"{out['losses']}")
            want = dict(flash_fwd=ZERO_LAYERS, flash_bwd=ZERO_LAYERS,
                        rms_norm=2 * ZERO_LAYERS + 1,
                        rms_norm_bwd=2 * ZERO_LAYERS + 1,
                        adam=r["n_tensors"] if s == 0 else r["pieces"])
            for name, n in want.items():
                check(r["launches"][name] == n * ZERO_STEPS,
                      f"phase 18 stage {s}: {name} launched "
                      f"{r['launches'][name]} times in {ZERO_STEPS} steps, "
                      f"expected {n * ZERO_STEPS}")
            if s:
                t = r["traffic"]
                check(t["reduce_scatter"] == r["buckets"] * ZERO_STEPS,
                      f"phase 18 stage {s}: {t}")
            if s < 3:
                check(r["digest"] == rs[0]["digest"],
                      f"phase 18 stage {s}: the ranks' parameters differ")
        check(max(out["loss_rel"]) <= TP_LOSS_TOL,
              f"phase 18 stage {s}: losses {out['losses']}")
        check(max(v for v, _ in out["masters"].values()) <= TP_PARAM_BAR,
              f"phase 18 stage {s}: probe masters {out['masters']}")
        check(max(v for v, _ in out["moments"].values()) <= ZERO_MOMENT_BAR,
              f"phase 18 stage {s}: probe moments {out['moments']}")
        # the bytes a rank holds: 1/N of the state from stage 1, of the
        # gradients from stage 2, of the parameters at stage 3
        for k, first in (("state", 1), ("grads", 2), ("params", 3)):
            w = dict(state=whole["state_bytes"], grads=whole["grads_bytes"],
                     params=whole["params_bytes"])[k]
            got = [b[k] for b in out["bytes"]]
            if s >= first:
                check(all(0.45 * w < v < 0.55 * w for v in got),
                      f"phase 18 stage {s}: {k} bytes {got} are not half of "
                      f"stage 0's {w}")
            else:
                check(all(v == w for v in got),
                      f"phase 18 stage {s}: {k} bytes {got}, stage 0's {w}")
        if s:
            check(sum(b["state"] for b in out["bytes"])
                  == whole["state_bytes"],
                  f"phase 18 stage {s}: the ranks' state does not add up")
            # the peak comes at the backward's start, before the gradients,
            # where stages 1 and 2 hold the same: it may only tie there
            prev = res[f"stage{s - 1}"]["peak_gib"]
            check(all(a < b or (s == 2 and a == b)
                      for a, b in zip(out["peak_gib"], prev)),
                  f"phase 18 stage {s}: peak {out['peak_gib']} GiB does not "
                  f"fall below stage {s - 1}'s {prev}")
    check(whole["state_bytes"] == 12 * n_params,
          f"phase 18: stage 0 holds {whole['state_bytes']} bytes of state "
          f"for {n_params} parameters")
    f = res["faults"]
    check(max(v for v, _ in f["reduce_without_divide"]["moments"].values())
          > ZERO_MOMENT_BAR,
          f"phase 18: a reduce_scatter without its division passed: "
          f"{f['reduce_without_divide']}")
    check(f["gather_at_rank0_offset"]["step2_loss_rel"] > TP_LOSS_TOL
          and f["gather_at_rank0_offset"]["digests_differ"],
          f"phase 18: rank 1 gathering at rank 0's offset passed: "
          f"{f['gather_at_rank0_offset']}")
    check(max(v for v, _ in f["no_gather_before_backward"]["moments"]
              .values()) > ZERO_MOMENT_BAR,
          f"phase 18: stage 3 without the gather before the backward passed: "
          f"{f['no_gather_before_backward']}")


# ---------------------------------------------------------------------------
# phase 19: pipeline parallelism
# ---------------------------------------------------------------------------

# LLaMA-2-7B's widths at PP_LAYERS of its 32 layers, bf16 O2, AdamW with
# f32 masters, the dense loss, batch PP_ROWS x PP_SEQ (every pp rank the
# same rows) cut into PP_M microbatches, on phase 18's two gloo ranks of the
# one card at pp_degree 2: the "gpipe", "1f1b" and "vpp" (v = 2) schedules
# in turn from the same seeded weights, against pp = 1 on rank 0 (the mesh
# set aside). The loss is the dense cross entropy of f32 logits. Two ranks
# share one card: no pipeline speed.
PP_N = 2
PP_LAYERS = 4
PP_ROWS, PP_SEQ, PP_M = 4, 4096, 4
PP_STEPS = 2
PP_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("vpp", 2))
# the f32 masters compared with pp 1's: a column- and a row-split linear,
# a norm, each layer once under both layouts (1f1b: rank 0 holds layers 0
# and 1; vpp: 0 and 2), the embedding (first stage) and the final norm
# (last stage)
PP_PROBES = ("llama.layers.0.self_attn.q_proj.weight",
             "llama.layers.1.mlp.down_proj.weight",
             "llama.layers.2.self_attn.o_proj.weight",
             "llama.layers.3.input_layernorm.weight",
             "llama.embed_tokens.weight", "llama.norm.weight")
# then GPT-3 1.3B (all 24 layers, the tied embedding on both stages), two
# 1F1B steps of 4 x 2048 in 4 microbatches against pp 1, the masters held
# after the last (Adam's first update is the sign of each gradient, which
# rounding flips for the near-zero ones: layer 0's fc_in read 0.090 of its
# update after one step on an H100); no QKV probe: at the initial weights
# attention is near uniform and the key columns' gradients near zero (0.113
# after one step, near the bar; PERF.md, the pipeline slice's runs)
PP_GPT_SEQ = 2048
PP_GPT_PROBES = ("gpt.layers.0.mlp.fc_in.weight",
                 "gpt.layers.23.mlp.fc_out.weight",
                 "gpt.embed_tokens.weight")
# each probe's first elements (the embedding's first 256 rows: the batch
# draws its ids below TP_DATA_VOCAB)
PP_PROBE_ELEMS = 1 << 20


def pp_model(seed, dev, v=1, family="llama"):
    """LLaMA-2-7B's widths at PP_LAYERS (or GPT-3 1.3B whole), bf16 O2,
    the dense loss, this rank's stage under the global mesh (the whole
    model without one), the seeded weights of phase 16 (`tp_load`: one
    generator a tensor, so the stages hold the slices of the pp = 1
    model)."""
    if family == "gpt":
        cfg = GPTConfig.gpt3_1p3b()
    else:
        cfg = LlamaConfig.llama2_7b()
        cfg.num_hidden_layers = PP_LAYERS
    cfg.dtype = "bfloat16"
    cfg.fused_ce_chunks = 0
    cfg.virtual_pp_degree = v
    cls = GPTForCausalLM if family == "gpt" else LlamaForCausalLM
    model = cls(cfg, device=dev, seed=seed)
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    tp_load(model, family, seed)
    return model


def pp_loss(model):
    """The dense loss of f32 logits (phase 16's): a bf16 loss rounds to
    1 part in 256, too coarse for `TP_LOSS_TOL`."""
    return lambda logits, y: model.compute_loss(logits.float(), y)


def pp_batch(seed, dev, seq=None):
    """The rows of the one dp coordinate (every pp rank reads the same)."""
    rng = np.random.RandomState(seed + 19)
    ids = torch.from_numpy(rng.randint(0, TP_DATA_VOCAB, (
        PP_ROWS, (seq or PP_SEQ) + 1))).to(dev)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def pp_probes(opt, model, names=PP_PROBES):
    """{probe: its f32 master (CPU copy)} of the probes this rank holds."""
    inner = getattr(opt, "_inner_opt", opt)
    pos = {id(p): i for i, p in enumerate(inner._parameter_list)}
    params = dict(model.named_parameters())
    return {n: inner._accumulators[pos[id(params[n])]]["master_weight"]
            .detach().reshape(-1)[:PP_PROBE_ELEMS].float().cpu().clone()
            for n in names if n in params}


class PPFaults:
    """The planted faults; each acts alike on every rank where the
    transfers depend on it, so no rank waits on a message never sent."""

    @staticmethod
    def skip_last_backward(step):
        """A 1F1B that never runs the last microbatch's backward (on both
        stages: no cotangent is sent for it, none awaited)."""
        from paddle_tpu_torch.distributed import pipeline as P

        plain = P.schedule_program

        def program(schedule, S, stage, M, virtual=1):
            return [op for op in plain(schedule, S, stage, M, virtual)
                    if op != ("b", 0, M - 1)]

        P.schedule_program = program
        return lambda: setattr(P, "schedule_program", plain)

    @staticmethod
    def cotangent_dropped(step):
        """The last stage sends zeros back in place of its input's
        cotangent."""
        link = step._link
        if link.stage != link.num_stages - 1:
            return lambda: None
        plain = link.send_backward
        link.send_backward = lambda g: plain(torch.zeros_like(g))
        return lambda: delattr(link, "send_backward")

    @staticmethod
    def loss_not_divided(step):
        """The step's loss is the sum of the microbatch losses, not their
        mean."""
        from paddle_tpu_torch.distributed import pipeline as P

        plain = P._mean_loss
        P._mean_loss = lambda losses, link, inv_m, dev: plain(
            losses, link, 1.0, dev)
        return lambda: setattr(P, "_mean_loss", plain)


def pp_run(seed, dev, schedule, v, steps=PP_STEPS, fault=None,
           family="llama"):
    """One schedule's run on this rank: the stage's model and optimizer
    built fresh, `steps` steps of build_train_step with the kernels'
    launches counted; each step's ms and transfers; the peak of
    `max_memory_allocated` over the steps; the probes' masters after each
    step. `fault` plants one of `PPFaults` first."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = pp_model(seed, dev, v, family)
    probe_names = PP_GPT_PROBES if family == "gpt" else PP_PROBES
    opt = AdamW(learning_rate=ZERO_LR, parameters=model.parameters(),
                multi_precision=True)
    step = build_train_step(model, opt, criterion=pp_loss(model),
                            num_microbatches=PP_M,
                            pipeline_schedule=schedule, virtual_pp_degree=v)
    undo = getattr(PPFaults, fault)(step) if fault else (lambda: None)
    x, y = pp_batch(seed, dev, PP_GPT_SEQ if family == "gpt" else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    for _, mod, attr in TRAIN_COUNTERS:
        setattr(mod, attr, 0)
    losses, ms, comm, probes = [], [], [], []
    try:
        for _ in range(steps):
            step._link.reset_stats()
            t1 = time.perf_counter()
            losses.append(float(step(x, y)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            comm.append(step._link.stats())
            probes.append(pp_probes(opt, model, probe_names))
    finally:
        undo()
    launches = {n: getattr(mod, a) for n, mod, a in TRAIN_COUNTERS}
    # the tied embedding's two copies must stay equal: a digest of each
    tied = {n: (float(p.detach().double().sum()),
                float(p.detach().double().square().sum()))
            for n, p in model.named_parameters()
            if getattr(p, "pp_shared_stages", None) is not None}
    res = dict(schedule=schedule, v=v, fault=fault, losses=losses,
               tied=tied,
               step_ms=ms, comm=comm, probes=probes, launches=launches,
               stage=model.pp.stage, last=model.pp.last,
               layers=[int(i) for i in model.pp.layer_ids],
               n_tensors=len(list(model.parameters())), setup_s=setup_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return res


def pp_baseline(seed, dev, steps=PP_STEPS, family="llama"):
    """pp = 1 in this process, the global mesh set aside: the whole model,
    one plain step over the whole batch; the probes' initial values and
    their masters after each step."""
    from paddle_tpu_torch.distributed import mesh as M

    keep = M.get_mesh(optional=True)
    M.set_mesh(None)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        model = pp_model(seed, dev, family=family)
        names = PP_GPT_PROBES if family == "gpt" else PP_PROBES
        init = {n: p.detach().reshape(-1)[:PP_PROBE_ELEMS].float().cpu()
                .clone() for n, p in model.named_parameters() if n in names}
        opt = AdamW(learning_rate=ZERO_LR, parameters=model.parameters(),
                    multi_precision=True)
        step = build_train_step(model, opt, criterion=pp_loss(model))
        x, y = pp_batch(seed, dev, PP_GPT_SEQ if family == "gpt" else None)
        for _, mod, attr in TRAIN_COUNTERS:
            setattr(mod, attr, 0)
        losses, probes, ms = [], [], []
        for _ in range(steps):
            t1 = time.perf_counter()
            losses.append(float(step(x, y)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            probes.append(pp_probes(opt, model, names))
        launches = {n: getattr(mod, a) for n, mod, a in TRAIN_COUNTERS}
        res = dict(losses=losses, probes=probes, init=init, step_ms=ms,
                   launches=launches)
        del model, opt, step
    finally:
        M.set_mesh(keep)
        gc.collect()
        torch.cuda.empty_cache()
    return res


def pp_rank_part(seed, dev, t0):
    """Phase 19 on this rank (inside phase 18's spawned ranks): fleet.init
    at pp_degree 2, pp = 1 on rank 0 while rank 1 waits, the three
    schedules, then the three planted faults."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict(dp_degree=1, pp_degree=PP_N)
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    stage = hcg.get_stage_id()
    res = dict(rank=D.get_rank(), stage=stage, backend=D.get_backend(),
               device=str(dev), mesh=tuple(D.get_mesh().mesh_dim_names),
               first=hcg.is_first_stage, last=hcg.is_last_stage,
               next=hcg._get_p2p_next_rank())
    t1 = time.perf_counter()
    if stage == 0:
        res["pp1"] = pp_baseline(seed, dev)
    D.barrier()
    res["pp1_s"] = time.perf_counter() - t1
    log(f"phase 19: rank {stage}: pp 1 at {time.perf_counter() - t0:.1f} s")
    for schedule, v in PP_SCHEDULES:
        res[schedule] = pp_run(seed, dev, schedule, v)
        log(f"phase 19: rank {stage}: {schedule} at "
            f"{time.perf_counter() - t0:.1f} s")
    res["faults"] = {f: pp_run(seed, dev, "1f1b", 1, steps=1, fault=f)
                     for f in ("skip_last_backward", "cotangent_dropped",
                               "loss_not_divided")}
    t1 = time.perf_counter()
    if stage == 0:
        res["gpt_pp1"] = pp_baseline(seed, dev, family="gpt")
    D.barrier()
    res["gpt"] = pp_run(seed, dev, "1f1b", 1, family="gpt")
    res["gpt_s"] = time.perf_counter() - t1
    log(f"phase 19: rank {stage}: GPT-3 1.3B at "
        f"{time.perf_counter() - t0:.1f} s")
    return res


def pp_masters(ranks, run, step, base, names=PP_PROBES):
    """{probe: rel}: the probes' masters after `step` (each from the rank
    that holds it) against pp 1's, over their update from the initial
    weights."""
    out = {}
    for n in names:
        got = next(run(r)["probes"][step][n] for r in ranks
                   if n in run(r)["probes"][step])
        want = base["probes"][step][n]
        size = float((want - base["init"][n]).double().norm())
        out[n] = float((got - want).double().norm()) / size if size \
            else float("inf")
    return out


def pp_phase(ranks, card, spawn_s):
    """Phase 19's readings from the ranks' results (every one logged before
    its check), then the checks."""
    t0 = time.perf_counter()
    base = ranks[0]["pp1"]
    res = dict(pp1=dict(losses=base["losses"], step_ms=base["step_ms"]))
    log(f"phase 19: pp 1 (rank 0, the mesh set aside): LLaMA-2-7B widths, "
        f"{PP_LAYERS} layers, bf16 O2, AdamW({ZERO_LR}, f32 masters), the "
        f"dense loss, batch {PP_ROWS} x {PP_SEQ}: losses {base['losses']}, "
        f"step ms {[round(v, 1) for v in base['step_ms']]} [{card}]")
    for schedule, v in PP_SCHEDULES:
        rs = [r[schedule] for r in ranks]
        rel = [abs(a - b) / abs(b) for a, b in zip(rs[0]["losses"],
                                                   base["losses"])]
        masters = pp_masters(ranks, lambda r: r[schedule], -1, base)
        res[schedule] = dict(
            losses=[r["losses"] for r in rs], loss_rel=rel, masters=masters,
            peak_gib=[r["peak_gib"] for r in rs],
            step_ms=[r["step_ms"] for r in rs],
            comm=[r["comm"] for r in rs],
            launches=[r["launches"] for r in rs],
            layers=[r["layers"] for r in rs])
        log(f"phase 19 {schedule} (v {v}): LLaMA-2-7B widths, {PP_LAYERS} "
            f"layers over pp {PP_N} (layers by rank "
            f"{[r['layers'] for r in rs]}), M {PP_M} of 1 x {PP_SEQ}, "
            f"{PP_STEPS} steps: losses by rank {[r['losses'] for r in rs]} "
            f"against pp 1's {base['losses']} (rel "
            f"{[f'{v_:.3g}' for v_ in rel]}, bar {TP_LOSS_TOL}); probe "
            f"masters over their update: "
            f"{ {k: round(v_, 5) for k, v_ in masters.items()} } (bar "
            f"{TP_PARAM_BAR}) [{card}]")
        log(f"phase 19 {schedule}: peak {[round(r['peak_gib'], 3) for r in rs]}"
            f" GiB by rank; step ms by rank "
            f"{[[round(v_, 1) for v_ in r['step_ms']] for r in rs]}; a step "
            f"by rank (sends, recvs, staged MiB): "
            + "; ".join(f"{c['sends']}, {c['recvs']}, "
                        f"{c['staged_bytes'] / 2 ** 20:.1f}"
                        for c in (r["comm"][-1] for r in rs))
            + f"; launches by rank {[r['launches'] for r in rs]} (two ranks "
            f"on ONE card over gloo: counts, not a speed) [{card}]")
    faults = {}
    for f in ("skip_last_backward", "cotangent_dropped"):
        faults[f] = pp_masters(ranks, lambda r, f=f: r["faults"][f], 0, base)
    ln = ranks[0]["faults"]["loss_not_divided"]["losses"][0]
    faults["loss_not_divided"] = dict(
        loss=ln, loss_rel=abs(ln - base["losses"][0]) / abs(base["losses"][0]))
    res["faults"] = faults
    log(f"phase 19: planted faults (each must exceed its bar): {faults} "
        f"[{card}]")
    gb = ranks[0]["gpt_pp1"]
    gs = [r["gpt"] for r in ranks]
    res["gpt"] = dict(
        losses=[r["losses"] for r in gs], pp1_losses=gb["losses"],
        loss_rel=max(abs(a - b) / abs(b) for a, b in zip(gs[0]["losses"],
                                                          gb["losses"])),
        masters=pp_masters(ranks, lambda r: r["gpt"], -1, gb,
                           PP_GPT_PROBES),
        tied=[r["tied"] for r in gs], layers=[len(r["layers"]) for r in gs],
        step_ms=[r["step_ms"] for r in gs], launches=[r["launches"]
                                                     for r in gs],
        comm=[r["comm"][-1] for r in gs], pp1_step_ms=gb["step_ms"])
    g = res["gpt"]
    log(f"phase 19 GPT-3 1.3B: 24 layers over pp 2 (layers by rank "
        f"{g['layers']}), the tied embedding on both stages, {PP_STEPS} "
        f"1F1B steps of {PP_ROWS} x {PP_GPT_SEQ} in M {PP_M}: losses by rank "
        f"{g['losses']} against pp 1's {g['pp1_losses']} (rel "
        f"{g['loss_rel']:.3g}, bar {TP_LOSS_TOL}); probe masters over their "
        f"update {g['masters']} (bar {TP_PARAM_BAR}); the tied copies' "
        f"digests {g['tied']}; step ms by rank {g['step_ms']} (pp 1: "
        f"{g['pp1_step_ms']}); a step by rank {g['comm']}; launches by rank "
        f"{g['launches']} [{card}]")
    res["process_s"] = spawn_s
    log(f"phase 19: readings {time.perf_counter() - t0:.1f} s; pp 1 took "
        f"{ranks[0]['pp1_s']:.1f} s of the ranks' time [{card}]")
    pp_verify(ranks, res)
    launches = {}
    for r in ranks:
        for run in [r[s] for s, _ in PP_SCHEDULES] + [
                r.get("pp1"), r["gpt"], r.get("gpt_pp1")]:
            for name, n in (run or {}).get("launches", {}).items():
                launches[name] = launches.get(name, 0) + n
    res["launches"] = launches
    log(f"phase 19: launches of its counted runs, both ranks: {launches} "
        f"[{card}]")
    return res


def pp_verify(ranks, res):
    """Phase 19's checks."""
    for r in ranks:
        check(r["backend"] == "gloo" and r["device"].startswith("cuda")
              and r["mesh"] == ("pp",)
              and (r["first"], r["last"]) == (r["stage"] == 0,
                                              r["stage"] == PP_N - 1)
              and r["next"] == 1 - r["rank"],
              f"phase 19: rank {r['rank']}: {r['device']} over "
              f"{r['backend']}, mesh {r['mesh']}, stage {r['stage']}")
    for schedule, _ in PP_SCHEDULES:
        out = res[schedule]
        rs = [r[schedule] for r in ranks]
        for r in rs:
            check(r["losses"] == rs[0]["losses"]
                  and all(math.isfinite(v) for v in r["losses"]),
                  f"phase 19 {schedule}: the ranks' losses differ: "
                  f"{out['losses']}")
            L = len(r["layers"])
            norms = 2 * L + (1 if r["last"] else 0)
            want = dict(flash_fwd=L * PP_M, flash_bwd=L * PP_M,
                        rms_norm=norms * PP_M, rms_norm_bwd=norms * PP_M,
                        adam=r["n_tensors"])
            for name, n in want.items():
                check(r["launches"][name] == n * PP_STEPS,
                      f"phase 19 {schedule} stage {r['stage']}: {name} "
                      f"launched {r['launches'][name]} times in {PP_STEPS} "
                      f"steps, expected {n * PP_STEPS}")
            # each logical stage but the first receives its input and
            # each but the last sends its output, and the cotangents go
            # back the same way: (2v - 1) M messages each way a rank, every
            # one a [1, seq, hidden] bf16 activation staged on the host
            v = 2 if schedule == "vpp" else 1
            c = r["comm"][-1]
            act = PP_SEQ * LlamaConfig.llama2_7b().hidden_size * 2
            check(c["sends"] == c["recvs"] == (2 * v - 1) * PP_M
                  and c["staged_bytes"] == (c["sends"] + c["recvs"]) * act,
                  f"phase 19 {schedule} stage {r['stage']}: transfers {c}")
        check(max(out["loss_rel"]) <= TP_LOSS_TOL,
              f"phase 19 {schedule}: losses {out['losses']}")
        check(max(out["masters"].values()) <= TP_PARAM_BAR,
              f"phase 19 {schedule}: probe masters {out['masters']}")
    gpipe, f1b = res["gpipe"]["peak_gib"][0], res["1f1b"]["peak_gib"][0]
    check(f1b < gpipe, f"phase 19: stage 0's peak under 1F1B {f1b} GiB is "
          f"not below GPipe's {gpipe}")
    g = res["gpt"]
    check(g["losses"][0] == g["losses"][1]
          and g["loss_rel"] <= TP_LOSS_TOL
          and max(g["masters"].values()) <= TP_PARAM_BAR
          and g["tied"][0] == g["tied"][1] and len(g["tied"][0]) == 1,
          f"phase 19 GPT-3 1.3B: {g}")
    for r in (r["gpt"] for r in ranks):
        L = len(r["layers"])
        for name, n in dict(flash_fwd=L * PP_M, flash_bwd=L * PP_M,
                            adam=r["n_tensors"]).items():
            check(r["launches"][name] == n * PP_STEPS,
                  f"phase 19 GPT-3 1.3B stage {r['stage']}: {name} launched "
                  f"{r['launches'][name]} times, expected {n * PP_STEPS}")
    f = res["faults"]
    check(max(f["skip_last_backward"].values()) > TP_PARAM_BAR,
          f"phase 19: a 1F1B without the last backward passed: "
          f"{f['skip_last_backward']}")
    stage0 = {n: v for n, v in f["cotangent_dropped"].items()
              if n in ranks[0]["1f1b"]["probes"][0]}
    check(stage0 and min(stage0.values()) > TP_PARAM_BAR,
          f"phase 19: a dropped cotangent passed stage 0's masters: {stage0}")
    check(f["loss_not_divided"]["loss_rel"] > TP_LOSS_TOL,
          f"phase 19: a loss not divided by M passed: "
          f"{f['loss_not_divided']}")


# ---------------------------------------------------------------------------
# 20. BASELINE config 4: ZeRO stage 2 under the pipeline, saved and resumed

ZPP_PP, ZPP_SHARDING = 2, 2
ZPP_N = ZPP_PP * ZPP_SHARDING
ZPP_LAYERS = 2          # of LLaMA-2-13B's 40: one a stage
ZPP_ROWS, ZPP_SEQ, ZPP_M = 4, 4096, 2
ZPP_STAGE = 2           # config 4's ZeRO stage
ZPP_STEPS = 2
# the f32 masters compared with pp 1's: a column- and a row-split linear
# (one a stage), the embedding (first stage) and the final norm (last)
ZPP_PROBES = ("llama.layers.0.self_attn.q_proj.weight",
              "llama.layers.1.mlp.down_proj.weight",
              "llama.embed_tokens.weight", "llama.norm.weight")
# the leaf whose piece the planted checkpoint fault writes one element off
ZPP_OFFSET_LEAF = "llama.layers.0.self_attn.q_proj.weight"
# the resumed run's probe masters after step 2 against the uninterrupted
# run's own (the same engines and path; only the bf16 flash backward's dQ
# atomics differ), over the update of step 2. On an H100 (PERF.md, §6)
# sound runs read 0-0.00576 (the embedding the most), a restore without
# the Adam moments 0.37-1.74
ZPP_RESUME_BAR = 0.03


def zpp_model(seed, dev):
    """LLaMA-2-13B's widths at ZPP_LAYERS layers, bf16 O2, the dense loss,
    this rank's stage under the global mesh (the whole model without one),
    phase 16's seeded weights (`tp_load`: the stages hold the slices of the
    pp = 1 model)."""
    cfg = LlamaConfig.llama2_13b()
    cfg.num_hidden_layers = ZPP_LAYERS
    cfg.dtype = "bfloat16"
    cfg.fused_ce_chunks = 0
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    tp_load(model, "llama", seed)
    return model


def zpp_batch(seed, dev, rank=None):
    """The whole batch (rank None) or sharding rank `rank`'s rows of it
    (every pp rank of one sharding coordinate the same rows)."""
    rng = np.random.RandomState(seed + 20)
    ids = torch.from_numpy(rng.randint(0, TP_DATA_VOCAB, (
        ZPP_ROWS, ZPP_SEQ + 1))).to(dev)
    if rank is not None:
        k = ZPP_ROWS // ZPP_SHARDING
        ids = ids[rank * k:(rank + 1) * k]
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def zpp_probes(opt, model, eng):
    """{probe: (lo, hi, its f32 master over the first PP_PROBE_ELEMS
    elements' overlap with this rank's piece)} of the probes this rank's
    stage holds (the masters cover the rank's ZeRO pieces)."""
    inner = getattr(opt, "_inner_opt", opt)
    pos = {id(p): i for i, p in enumerate(inner._parameter_list)}
    params = dict(model.named_parameters())
    out = {}
    for n in ZPP_PROBES:
        if n not in params:
            continue
        lo, hi = eng.piece_range(params[n]) if eng is not None else (
            0, params[n].numel())
        hi2 = min(hi, PP_PROBE_ELEMS)
        st = inner._accumulators.get(pos[id(params[n])])
        vals = st["master_weight"].detach().reshape(-1)[:max(hi2 - lo, 0)] \
            if st is not None and hi2 > lo else torch.empty(0)
        out[n] = (lo, max(hi2, lo), vals.float().cpu().clone())
    return out


def zpp_opt_state(opt):
    """Every entry of the optimizer's state (under ZeRO the rank's pieces;
    tensors copied on the card), by (parameter index, name)."""
    inner = getattr(opt, "_inner_opt", opt)
    return {(i, k): v.detach().clone() if torch.is_tensor(v) else v
            for i, st in inner._accumulators.items() for k, v in st.items()}


def zpp_opt_equal(opt, want):
    """Whether the optimizer's state is `want` (`zpp_opt_state`), bit for
    bit."""
    inner = getattr(opt, "_inner_opt", opt)
    have = {(i, k): v for i, st in inner._accumulators.items()
            for k, v in st.items()}
    return set(have) == set(want) and all(
        torch.equal(have[k], v) if torch.is_tensor(v) else have[k] == v
        for k, v in want.items())


class ZppFaults:
    """The planted faults of phase 20; each acts alike on every rank."""

    @staticmethod
    def reduce_every_microbatch(eng):
        """Stage 2 reduce_scatters each bucket in every microbatch's
        backward (the engine not told of the microbatches)."""
        eng.begin_microbatches = lambda m: None

    @staticmethod
    def drop_moments(opt):
        """A restore that leaves the Adam moments at zero (the masters and
        the bias corrections restored)."""
        inner = getattr(opt, "_inner_opt", opt)
        for st in inner._accumulators.values():
            st["moment1"].zero_()
            st["moment2"].zero_()


def zpp_build(seed, dev, rank):
    """A fresh stage model, AdamW with f32 masters and the step
    (build_train_step at ZPP_STAGE, 1F1B, M = ZPP_M)."""
    model = zpp_model(seed, dev)
    opt = AdamW(learning_rate=ZERO_LR, parameters=model.parameters(),
                multi_precision=True)
    step = build_train_step(model, opt, criterion=pp_loss(model),
                            num_microbatches=ZPP_M,
                            pipeline_schedule="1f1b",
                            sharding_stage=ZPP_STAGE)
    return model, opt, step


def zpp_counted(step, x, y, opt, model):
    """One step with the kernels' launches, the engine's traffic and the
    link's transfers counted: (loss, ms, launches, traffic delta, link
    stats, probes)."""
    eng = step._zero
    for _, mod, attr in TRAIN_COUNTERS:
        setattr(mod, attr, 0)
    before = dict(eng.traffic)
    step._link.reset_stats()
    t1 = time.perf_counter()
    loss = float(step(x, y))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    launches = {n: getattr(mod, a) for n, mod, a in TRAIN_COUNTERS}
    traffic = {k: v - before.get(k, 0) for k, v in eng.traffic.items()}
    return loss, ms, launches, traffic, step._link.stats(), \
        zpp_probes(opt, model, eng)


def zpp_eval(step, x, y, dev, data_mean):
    """The forward alone over this rank's microbatches (no update): the
    mean loss over the stages and the sharding ranks, as the step gives
    it."""
    from paddle_tpu_torch.distributed import pipeline as P

    with torch.no_grad():
        loss = P.run_forward(step._stage, step._link,
                             list(P.microbatch(x, ZPP_M)),
                             list(P.microbatch(y, ZPP_M)), device=dev)
    return float(data_mean(loss.reshape(1).clone())[0])


def zpp_free(*objs):
    del objs
    gc.collect()
    torch.cuda.empty_cache()


def zpp_baseline(seed, dev):
    """pp 1 x sharding 1 on this rank, the global mesh set aside: the
    whole model over the whole batch, ZPP_STEPS plain steps; the probes'
    initial values and masters after each step."""
    from paddle_tpu_torch.distributed import mesh as M

    keep = M.get_mesh(optional=True)
    M.set_mesh(None)
    zpp_free()
    try:
        model = zpp_model(seed, dev)
        init = {n: p.detach().reshape(-1)[:PP_PROBE_ELEMS].float().cpu()
                .clone() for n, p in model.named_parameters()
                if n in ZPP_PROBES}
        opt = AdamW(learning_rate=ZERO_LR, parameters=model.parameters(),
                    multi_precision=True)
        step = build_train_step(model, opt, criterion=pp_loss(model))
        x, y = zpp_batch(seed, dev)
        losses, probes, ms = [], [], []
        for _ in range(ZPP_STEPS):
            t1 = time.perf_counter()
            losses.append(float(step(x, y)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            probes.append({n: v[2] for n, v in
                           zpp_probes(opt, model, None).items()})
        res = dict(losses=losses, probes=probes, init=init, step_ms=ms)
        zpp_free(model, opt, step)
    finally:
        M.set_mesh(keep)
    return res


def zpp_rank_part(io, seed, dev, t0):
    """Phase 20 on this rank (inside phase 16's four spawned ranks):
    fleet.init at pp 2 x sharding 2, pp 1 on rank 0 while the others
    wait, the ZeRO-2 run (a step, the checkpoint of step 1 saved in the
    background while step 2 runs, a second save whose COMMITTED marker is
    withheld), the resume in fresh engines, then the planted faults."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding \
        .group_sharded import held_bytes

    zpp_free()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict(dp_degree=1, pp_degree=ZPP_PP,
                                   sharding_degree=ZPP_SHARDING)
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    stage, srank = hcg.get_stage_id(), hcg.get_sharding_parallel_rank()
    res = dict(rank=D.get_rank(), stage=stage, sharding_rank=srank,
               mesh=tuple(D.get_mesh().mesh_dim_names))
    t1 = time.perf_counter()
    if D.get_rank() == 0:
        res["pp1"] = zpp_baseline(seed, dev)
    D.barrier()
    res["pp1_s"] = time.perf_counter() - t1
    log(f"phase 20: rank {D.get_rank()}: pp 1 at "
        f"{time.perf_counter() - t0:.1f} s")
    from paddle_tpu_torch.jit.api import _data_mean

    x, y = zpp_batch(seed, dev, srank)
    root = os.path.join(io, "phase20_ckpt")
    # the run: step 1, its checkpoint saved while step 2 runs
    zpp_free()
    torch.cuda.reset_peak_memory_stats()
    model, opt, step = zpp_build(seed, dev, srank)
    eng = step._zero
    stage0 = dict(state=sum(p.numel() for p in model.parameters()) * 12,
                  grads=sum(p.numel() * p.element_size()
                            for p in model.parameters()))
    held = {}
    plain_update = eng.update

    def measured_update(*a, **k):
        if "grads" not in held:
            held["grads"] = held_bytes(opt, eng)["grads"]
        return plain_update(*a, **k)

    eng.update = measured_update
    run = [zpp_counted(step, x, y, opt, model)]
    held["state"] = held_bytes(opt, eng)["state"]
    saved_opt = zpp_opt_state(opt)
    mgr = ck.CheckpointManager(os.path.join(root, "run"), max_to_keep=3)
    t1 = time.perf_counter()
    mgr.save(1, ck._model_state(model, opt),
             trainer_state=ck.trainer_state_snapshot(1))
    save_dispatch_s = time.perf_counter() - t1
    # the planted wrong offset: the model after step 1 saved again with
    # this rank's piece of one leaf written one element off, through
    # save_state_dict as fleet.save writes
    state = ck._model_state(model)
    if ZPP_OFFSET_LEAF in state["model"]:
        pc = state["model"][ZPP_OFFSET_LEAF]
        pc.value = torch.roll(pc.value.reshape(-1), 1).reshape(
            pc.value.shape)
    ck.save_state_dict(state, os.path.join(root, "offset"))
    del state
    run.append(zpp_counted(step, x, y, opt, model))
    t1 = time.perf_counter()
    mgr.wait()
    save_wait_s = time.perf_counter() - t1
    save_bytes = mgr.counts["save_bytes"]
    # a second save whose marker is withheld (the model alone)
    plain_commit = ck.CheckpointManager._commit
    ck.CheckpointManager._commit = lambda self, s: None
    try:
        mgr.save(2, ck._model_state(model))
        mgr.wait()
    finally:
        ck.CheckpointManager._commit = plain_commit
    res["steps"] = [dict(loss=r[0], ms=r[1], launches=r[2], traffic=r[3],
                         link=r[4], probes=r[5]) for r in run]
    res.update(held=held, stage0=stage0, buckets=len(eng.buckets),
               pieces=sum(len(b.pieces) for b in eng.buckets),
               n_tensors=len(list(model.parameters())),
               layers=[int(i) for i in model.pp.layer_ids],
               last=model.pp.last, peak_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30, save_dispatch_s=save_dispatch_s,
               save_wait_s=save_wait_s, save_bytes=save_bytes,
               committed=mgr.committed_steps(), all_steps=mgr.all_steps())
    zpp_free(model, opt, step)
    log(f"phase 20: rank {D.get_rank()}: run and saves at "
        f"{time.perf_counter() - t0:.1f} s")
    # the resume: fresh engines from the manager's newest restorable step
    model, opt, step = zpp_build(seed, dev, srank)
    ck._init_optimizer_state(model, opt)
    t1 = time.perf_counter()
    got = mgr.restore(template=ck._model_state(model, opt))
    ck._apply_model_state(model, opt, got)
    torch.cuda.synchronize()
    res["load_s"] = time.perf_counter() - t1
    res["load_bytes"] = mgr.counts["restore_bytes"]
    res["fallbacks"] = mgr.counts["restore_fallbacks"]
    res["trainer_step"] = mgr.restore_trainer_state()["step"]
    res["opt_restored"] = zpp_opt_equal(opt, saved_opt)
    res["clean_eval"] = zpp_eval(step, x, y, dev, _data_mean)
    r = zpp_counted(step, x, y, opt, model)
    res["resumed"] = dict(loss=r[0], ms=r[1], probes=r[5])
    zpp_free(model, opt, step)
    # the planted faults: the restore without the Adam moments, step 2's
    # masters; the offset checkpoint's forward loss at step 2; a
    # reduce_scatter in every microbatch
    model, opt, step = zpp_build(seed, dev, srank)
    ck._init_optimizer_state(model, opt)
    ck._apply_model_state(model, opt, got)
    del got
    ZppFaults.drop_moments(opt)
    res["fault_moments_restored"] = zpp_opt_equal(opt, saved_opt)
    del saved_opt
    r = zpp_counted(step, x, y, opt, model)
    res["fault_moments"] = dict(loss=r[0], probes=r[5])
    fleet.fleet.load_model(os.path.join(root, "offset"), model)
    res["offset_eval"] = zpp_eval(step, x, y, dev, _data_mean)
    ZppFaults.reduce_every_microbatch(step._zero)
    r = zpp_counted(step, x, y, opt, model)
    res["fault_reduce"] = dict(loss=r[0], traffic=r[3],
                               buckets=len(step._zero.buckets))
    zpp_free(model, opt, step)
    D.barrier()
    if D.get_rank() == 0:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 20: rank {D.get_rank()}: resume and faults at "
        f"{time.perf_counter() - t0:.1f} s")
    return res


def zpp_masters(ranks, probes_of, base, step):
    """{probe: rel}: the probes' masters (joined from the pieces of the
    sharding ranks of the stage that holds each) after `step` against
    pp 1's, over their update from the initial weights."""
    out = {}
    for n in ZPP_PROBES:
        want = base["probes"][step][n]
        got = torch.full_like(want, float("nan"))
        for r in ranks:
            held = probes_of(r).get(n)
            if held is not None:
                lo, hi, vals = held
                got[lo:hi] = vals
        size = float((want - base["init"][n]).double().norm())
        out[n] = float((got - want).double().norm()) / size if size \
            else float("inf")
    return out


def zpp_resume_rel(ranks, probes_of):
    """{probe: rel}: the probes' masters of a resumed step 2 (joined from
    the sharding ranks' pieces) against the uninterrupted run's after step
    2, over that run's update of step 2."""
    out = {}
    for n in ZPP_PROBES:
        got, want, before = (torch.full((PP_PROBE_ELEMS,), float("nan"))
                             for _ in range(3))
        for r in ranks:
            held = probes_of(r).get(n)
            if held is not None:
                lo, hi, vals = held
                got[lo:hi] = vals
                want[lo:hi] = r["steps"][1]["probes"][n][2]
                before[lo:hi] = r["steps"][0]["probes"][n][2]
        keep = ~torch.isnan(want)
        got, want, before = got[keep], want[keep], before[keep]
        size = float((want - before).double().norm())
        out[n] = float((got - want).double().norm()) / size if size \
            else float("inf")
    return out


def zpp_phase(ranks, card, spawn_s):
    """Phase 20's readings (each logged before its check), then the
    checks; returns the readings with the kernels' launches of the
    counted steps (the ZeRO run's two and the resumed one), every rank."""
    ranks = sorted(ranks, key=lambda r: (r["stage"], r["sharding_rank"]))
    base = next(r["pp1"] for r in ranks if "pp1" in r)
    res = dict(pp1=dict(losses=base["losses"], step_ms=base["step_ms"]))
    losses = [[s["loss"] for s in r["steps"]] for r in ranks]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[0], base["losses"])]
    masters = zpp_masters(ranks, lambda r: r["steps"][-1]["probes"], base,
                          -1)
    resumed = [r["resumed"]["loss"] for r in ranks]
    resumed_masters = zpp_masters(ranks, lambda r: r["resumed"]["probes"],
                                  base, -1)
    resumed_rel = zpp_resume_rel(ranks, lambda r: r["resumed"]["probes"])
    moments_rel = zpp_resume_rel(ranks,
                                 lambda r: r["fault_moments"]["probes"])
    rs = [[s["traffic"].get("reduce_scatter", 0) for s in r["steps"]]
          for r in ranks]
    res.update(losses=losses, loss_rel=rel, masters=masters,
               resumed=resumed, resumed_masters=resumed_masters,
               resumed_rel=resumed_rel,
               opt_restored=[r["opt_restored"] for r in ranks],
               reduce_scatters=rs, buckets=[r["buckets"] for r in ranks],
               held=[r["held"] for r in ranks],
               stage0=[r["stage0"] for r in ranks],
               step_ms=[[s["ms"] for s in r["steps"]] for r in ranks],
               link=[r["steps"][-1]["link"] for r in ranks],
               traffic=[r["steps"][-1]["traffic"] for r in ranks],
               peak_gib=[r["peak_gib"] for r in ranks],
               save_s=[r["save_dispatch_s"] + r["save_wait_s"]
                       for r in ranks],
               save_bytes=sum(r["save_bytes"] for r in ranks),
               load_s=[r["load_s"] for r in ranks],
               load_bytes=sum(r["load_bytes"] for r in ranks))
    log(f"phase 20: pp 1 (rank 0, the mesh set aside): LLaMA-2-13B widths, "
        f"{ZPP_LAYERS} layers, bf16 O2, AdamW({ZERO_LR}, f32 masters), the "
        f"dense loss, batch {ZPP_ROWS} x {ZPP_SEQ}: losses {base['losses']},"
        f" step ms {[round(v, 1) for v in base['step_ms']]} [{card}]")
    log(f"phase 20: pp {ZPP_PP} x sharding {ZPP_SHARDING}, ZeRO stage "
        f"{ZPP_STAGE}, 1F1B, M {ZPP_M} of 1 x {ZPP_SEQ} a sharding rank, "
        f"layers by rank {[r['layers'] for r in ranks]}: losses by rank "
        f"{losses} against pp 1's {base['losses']} (rel "
        f"{[f'{v:.3g}' for v in rel]}, bar {TP_LOSS_TOL}); probe masters "
        f"over their update {({k: round(v, 5) for k, v in masters.items()})}"
        f" (bar {TP_PARAM_BAR}) [{card}]")
    log(f"phase 20: bytes a rank (stage, sharding rank; held / stage 0's): "
        + "; ".join(f"({r['stage']}, {r['sharding_rank']}) state "
                    f"{r['held']['state']} / {r['stage0']['state']}, grads "
                    f"{r['held']['grads']} / {r['stage0']['grads']}"
                    for r in ranks)
        + f"; peak {[round(v, 3) for v in res['peak_gib']]} GiB [{card}]")
    log(f"phase 20: a step by rank: ms {res['step_ms']}; reduce_scatters "
        f"{rs} (buckets {res['buckets']}); traffic {res['traffic']}; sends, "
        f"recvs, staged MiB "
        + "; ".join(f"{c['sends']}, {c['recvs']}, "
                    f"{c['staged_bytes'] / 2 ** 20:.1f}" for c in res["link"])
        + f"; launches by rank {[r['steps'][-1]['launches'] for r in ranks]}"
        f" (four ranks on ONE card over gloo: counts, not a speed) [{card}]")
    log(f"phase 20: checkpoint of step 1: {res['save_bytes'] / 2 ** 30:.3f} "
        f"GiB written by the four ranks, save s by rank (dispatch + wait) "
        f"{[round(v, 2) for v in res['save_s']]}, "
        f"{res['load_bytes'] / 2 ** 30:.3f} GiB read, load s by rank "
        f"{[round(v, 2) for v in res['load_s']]}; committed "
        f"{ranks[0]['committed']} of {ranks[0]['all_steps']} (step 2's "
        f"marker withheld), restore fallbacks "
        f"{[r['fallbacks'] for r in ranks]} [{card}]")
    log(f"phase 20: resumed step 2's loss by rank {resumed} against the "
        f"uninterrupted {[l[-1] for l in losses]}; optimizer state after "
        f"the restore bit-equal to step 1's by rank {res['opt_restored']}; "
        f"masters after step 2 against the uninterrupted run's, over its "
        f"step-2 update {({k: f'{v:.4g}' for k, v in resumed_rel.items()})} "
        f"(bar {ZPP_RESUME_BAR}), against pp 1's over their update "
        f"{({k: round(v, 5) for k, v in resumed_masters.items()})} [{card}]")
    faults = dict(
        moments=dict(rel=moments_rel, restored=[
            r["fault_moments_restored"] for r in ranks]),
        offset_eval=[r["offset_eval"] for r in ranks],
        clean_eval=[r["clean_eval"] for r in ranks],
        reduce_every_microbatch=dict(
            reduce_scatters=[r["fault_reduce"]["traffic"].get(
                "reduce_scatter", 0) for r in ranks],
            buckets=[r["fault_reduce"]["buckets"] for r in ranks]))
    res["faults"] = faults
    log(f"phase 20: planted faults: a restore without the Adam moments: "
        f"state bit-equal by rank {faults['moments']['restored']}, masters "
        f"after step 2 against the uninterrupted run's "
        f"{({k: f'{v:.4g}' for k, v in moments_rel.items()})} (must exceed "
        f"{ZPP_RESUME_BAR}); a piece written one element off: the "
        f"step-2 forward's loss {faults['offset_eval']} against the correct "
        f"restore's {faults['clean_eval']}; a "
        f"reduce_scatter in every microbatch: "
        f"{faults['reduce_every_microbatch']} [{card}]")
    res["process_s"] = spawn_s
    zpp_verify(ranks, res)
    launches = {}
    for r in ranks:
        for s in r["steps"]:
            for name, n in s["launches"].items():
                launches[name] = launches.get(name, 0) + n
    res["launches"] = launches
    log(f"phase 20: launches of its counted steps, every rank: {launches} "
        f"[{card}]")
    return res


def zpp_verify(ranks, res):
    """Phase 20's checks."""
    for r in ranks:
        check(r["mesh"] == ("pp", "sharding"),
              f"phase 20: rank {r['rank']}: mesh {r['mesh']}")
    for l in res["losses"]:
        check(l == res["losses"][0] and all(math.isfinite(v) for v in l),
              f"phase 20: the ranks' losses differ: {res['losses']}")
    check(max(res["loss_rel"]) <= TP_LOSS_TOL,
          f"phase 20: losses {res['losses']} against pp 1's")
    check(max(res["masters"].values()) <= TP_PARAM_BAR,
          f"phase 20: probe masters {res['masters']}")
    for r in ranks:
        # half of stage 0's state and gradient bytes (the buckets' padding
        # within 1 %)
        for part in ("state", "grads"):
            got, whole = r["held"][part], r["stage0"][part]
            check(abs(got - whole / 2) <= 0.01 * whole / 2,
                  f"phase 20 rank {r['rank']}: {part} {got} bytes held, "
                  f"half of stage 0's {whole} expected")
        # exactly one reduce_scatter a bucket a step, never one a
        # microbatch
        for s in r["steps"]:
            check(s["traffic"].get("reduce_scatter") == r["buckets"],
                  f"phase 20 rank {r['rank']}: {s['traffic']} for "
                  f"{r['buckets']} buckets")
            L = len(r["layers"])
            norms = 2 * L + (1 if r["last"] else 0)
            want = dict(flash_fwd=L * ZPP_M, flash_bwd=L * ZPP_M,
                        rms_norm=norms * ZPP_M, rms_norm_bwd=norms * ZPP_M,
                        adam=r["pieces"])
            for name, n in want.items():
                check(s["launches"][name] == n,
                      f"phase 20 rank {r['rank']}: {name} launched "
                      f"{s['launches'][name]} times a step, expected {n}")
        check(r["committed"] == [1] and r["all_steps"] == [1, 2]
              and r["fallbacks"] == 1 and r["trainer_step"] == 1,
              f"phase 20 rank {r['rank']}: committed {r['committed']} of "
              f"{r['all_steps']}, fallbacks {r['fallbacks']}")
    uninterrupted = res["losses"][0][-1]
    check(all(v == uninterrupted for v in res["resumed"]),
          f"phase 20: the resumed step 2's loss {res['resumed']} is not the "
          f"uninterrupted run's {uninterrupted}")
    check(max(res["resumed_masters"].values()) <= TP_PARAM_BAR,
          f"phase 20: resumed masters {res['resumed_masters']}")
    check(all(res["opt_restored"]),
          f"phase 20: the restored optimizer state is not step 1's, by "
          f"rank {res['opt_restored']}")
    check(max(res["resumed_rel"].values()) <= ZPP_RESUME_BAR,
          f"phase 20: resumed masters against the uninterrupted run's "
          f"{res['resumed_rel']}")
    f = res["faults"]
    check(not any(f["moments"]["restored"])
          and min(f["moments"]["rel"].values()) > ZPP_RESUME_BAR,
          f"phase 20: a restore without the Adam moments passed: "
          f"{f['moments']}")
    check(all(a != b for a, b in zip(f["offset_eval"], f["clean_eval"])),
          f"phase 20: a checkpoint piece written one element off gave the "
          f"correct restore's loss: {f['offset_eval']}")
    fr = f["reduce_every_microbatch"]
    check(all(n == ZPP_M * b for n, b in zip(fr["reduce_scatters"],
                                              fr["buckets"])),
          f"phase 20: a reduce_scatter in every microbatch was not counted "
          f"{ZPP_M} a bucket: {fr}")


# ---------------------------------------------------------------------------
# phase 21: the Paddle-shaped core (to_tensor, dtypes and places, backward /
# grad / PyLayer, the ops of paddle_tpu_torch/ops) on the card
# ---------------------------------------------------------------------------

# the card's result against the CPU's, max |got - want| over max |want|:
# bf16 one output rounding of the largest (2^-7; CUDA and the CPU compute
# bf16 ops in f32 and round once), f32 summation order over up to 11008
# terms (1e-4); integer and bool outputs exactly
CORE_BAR = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}
CORE_SQ = (4096, 4096)         # LLaMA-2-7B's hidden x hidden
CORE_BIG = (8, 4096, 11008)    # a batch of 8 x 4096 through the MLP's width
CORE_LAYERS = 4                # of LLaMA-2-7B's 32 layers
CORE_SEQ = 4096
CORE_STEPS = 3                 # counted eager steps after one warm step
CORE_LR = 1e-4
# (b): the core's eager step against the torch-call step on the same
# weights (the bf16 flash backward sums dQ by atomics, so two runs differ
# by rounding): the probe weights after the last step, over their update,
# at most CORE_SPREAD times the two torch-call runs' own distance (plus
# CORE_FLOOR for a spread that reads 0; on the H100 the core read
# 0-0.0742 against a spread of 0-0.0744, PERF.md §6); each later loss, a
# bf16 value, at most CORE_SPREAD times the torch runs' largest loss
# spread over the steps, or 2 of its ulps (one step's spread can read 0
# and the core 2 ulps from it: 3.05e-5 at 0.0039)
CORE_SPREAD = 4.0
CORE_FLOOR = 1e-6
CORE_PROBES = ("llama.embed_tokens.weight",
               "llama.layers.0.self_attn.q_proj.weight",
               f"llama.layers.{CORE_LAYERS - 1}.mlp.down_proj.weight",
               "llama.norm.weight", "lm_head.weight")


def core_op_cases(P):
    """(family, name, function of the inputs, input makers): the core's ops
    at LLaMA-2-7B's widths. A maker takes (a generator on the card, dtype)
    and draws the input there; the CPU gets a copy."""
    def normal(shape):
        return lambda g, dt: torch.randn(shape, generator=g,
                                         device=g.device).to(dt)

    def positive(shape):
        return lambda g, dt: (torch.rand(shape, generator=g,
                                         device=g.device) + 0.5).to(dt)

    def index(n, hi):
        return lambda g, dt: torch.randint(0, hi, (n,), generator=g,
                                           device=g.device)

    n, h = CORE_SQ
    r = min(256, n)
    sq, big, rows = normal(CORE_SQ), normal(CORE_BIG), normal((r, h))
    return [
        ("math", "add", lambda x, y: P.add(x, y), [sq, sq]),
        ("math", "multiply", lambda x, y: P.multiply(x, y), [sq, sq]),
        ("math", "divide", lambda x, y: P.divide(x, y),
         [sq, positive(CORE_SQ)]),
        ("math", "pow", lambda x: P.pow(x, 2.0), [positive(CORE_SQ)]),
        ("math", "exp", lambda x: P.exp(P.scale(x, 0.5)), [sq]),
        ("math", "sqrt", P.sqrt, [positive(CORE_SQ)]),
        ("math", "rsqrt", P.rsqrt, [positive(CORE_SQ)]),
        ("math", "tanh", P.tanh, [sq]),
        ("math", "clip", lambda x: P.clip(x, -0.5, 0.5), [sq]),
        ("math", "lerp", lambda x, y: P.lerp(x, y, 0.25), [sq, sq]),
        ("math", "maximum", P.maximum, [sq, sq]),
        # accumulated in f32 (`dtype`): torch's bf16 cumsum rounds its
        # running sum in bf16 on one of the two devices (0.0672 of the
        # largest against the other on the H100, PERF.md §6)
        ("math", "cumsum", lambda x: P.cumsum(x, axis=1, dtype="float32"),
         [sq]),
        ("math", "multiply_big", lambda x, y: P.multiply(P.silu(x), y),
         [big, big]),
        ("reduction", "sum", lambda x: P.sum(x, axis=-1), [sq]),
        ("reduction", "sum_big", lambda x: P.sum(x, axis=-1), [big]),
        ("reduction", "mean", lambda x: P.mean(x, axis=0), [sq]),
        ("reduction", "max", lambda x: P.max(x, axis=1, keepdim=True), [sq]),
        ("reduction", "var", lambda x: P.var(x, axis=-1), [sq]),
        ("reduction", "std", lambda x: P.std(x, axis=0), [sq]),
        ("reduction", "logsumexp", lambda x: P.logsumexp(x, axis=-1), [sq]),
        ("manipulation", "reshape_transpose",
         lambda x: P.transpose(P.reshape(x, [64, n // 64, h]), [2, 0, 1]),
         [sq]),
        ("manipulation", "concat", lambda x, y: P.concat([x, y], axis=1),
         [sq, sq]),
        ("manipulation", "split",
         lambda x: P.split(x, [h // 4, -1, h // 4], axis=1), [sq]),
        ("manipulation", "gather",
         lambda x, i: P.gather(x, i, axis=0), [sq, index(512, n)]),
        ("manipulation", "scatter",
         lambda x, i, u: P.scatter(x, i, u, overwrite=False),
         [sq, index(2 * r, r), normal((2 * r, h))]),
        ("manipulation", "flatten_expand",
         lambda x: P.expand(P.flatten(P.unsqueeze(x, 0), 1, 2), [2, -1]),
         [sq]),
        ("manipulation", "pad", lambda x: P.pad(x, [0, 0, 3, 5]), [sq]),
        ("manipulation", "index_select",
         lambda x, i: P.index_select(x, i, axis=1), [sq, index(512, h)]),
        ("logic", "greater_than", P.greater_than, [sq, sq]),
        ("logic", "where",
         lambda x, y: P.where(P.greater_than(x, y), x, y), [sq, sq]),
        ("search", "topk", lambda x: P.topk(x, 8, axis=-1)[0], [sq]),
        ("search", "sort", lambda x: P.sort(x, axis=-1), [sq]),
        ("search", "argmax", lambda x: P.argmax(P.cast(x, "float32"),
                                                axis=1), [sq]),
        ("linalg", "matmul", lambda x, y: P.matmul(x, y), [rows, sq]),
        ("linalg", "matmul_t", lambda x, y: P.matmul(x, y, transpose_y=True),
         [rows, sq]),
        ("linalg", "norm", lambda x: P.norm(x, axis=1), [sq]),
        ("activation", "gelu", P.gelu, [sq]),
        ("activation", "silu", P.silu, [sq]),
        ("activation", "softmax", lambda x: P.softmax(x, axis=-1), [sq]),
        ("activation", "relu", P.relu, [sq]),
    ]


def core_err(got, want, dtype):
    """max |got - want| over max |want| (floats), or the count of unequal
    elements (integer and bool outputs)."""
    if not want.is_floating_point():
        return float((got != want).sum())
    w = want.float()
    scale = float(w.abs().max().clamp_min(1e-30))
    return float((got.float() - w).abs().max()) / scale


def core_ops(seed, dev, card):
    """(a): each case on the card's tensors and on the CPU's, bf16 and f32,
    every output on the card; creation ops with no place land on
    CUDAPlace(0); the planted fault: scatter(overwrite=False) adding into
    the old rows (no zeroing), which must fail its bar."""
    P = ptt
    res = dict(cases={}, creation={})
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    worst = {}
    for family, name, fn, makers in core_op_cases(P):
        for dt in (torch.bfloat16, torch.float32):
            card_in = [m(g, dt) for m in makers]
            cpu_in = [t.cpu() for t in card_in]
            got, want = fn(*card_in), fn(*cpu_in)
            gots = list(got) if isinstance(got, (list, tuple)) else [got]
            wants = list(want) if isinstance(want, (list, tuple)) else [want]
            check(all(t.device == dev for t in gots),
                  f"phase 21 (a): {name} {dt}: an output left the card")
            err = max(core_err(a.cpu(), b, dt) for a, b in zip(gots, wants))
            bar = CORE_BAR[dt] if wants[0].is_floating_point() else 0.0
            key = f"{name}_{str(dt).split('.')[1]}"
            res["cases"][key] = dict(family=family, err=err, bar=bar)
            worst[family] = max(worst.get(family, 0.0), err / max(bar, 1e-30)
                                if bar else err)
            del cpu_in, card_in, got, want, gots, wants
    torch.cuda.synchronize()
    # creation with no place, after set_device("gpu")
    place = P.set_device("gpu")
    made = {"zeros": P.zeros([3]), "ones": P.ones([2, 2]),
            "full": P.full([2], 1.5), "arange": P.arange(5),
            "linspace": P.linspace(0.0, 1.0, 4), "eye": P.eye(3),
            "to_tensor": P.to_tensor([1.0, 2.0]),
            "rand": P.rand([2]), "randn": P.randn([2]),
            "randint": P.randint(0, 4, [3]), "randperm": P.randperm(4),
            "uniform": P.uniform([2]), "tril_indices": P.tril_indices(3, 3)}
    for name, t in made.items():
        res["creation"][name] = str(t.device)
        check(P.framework.device._parse_device(t.device) == P.CUDAPlace(0),
              f"phase 21 (a): {name} with no place landed on {t.device}")
    check(place == P.CUDAPlace(0) and P.get_device() == "gpu:0",
          f"phase 21 (a): set_device('gpu') gave {place}")
    # the planted fault, made from the plain version
    r = min(256, CORE_SQ[0])
    x = torch.randn(CORE_SQ, generator=g, device=dev)
    i = torch.randint(0, r, (2 * r,), generator=g, device=dev)
    u = torch.randn((2 * r, CORE_SQ[1]), generator=g, device=dev)
    got = P.scatter(x, i, u, overwrite=False)
    fault = x.cpu().index_add(0, i.cpu(), u.cpu())  # adds into old rows
    res["fault_scatter_no_zeroing"] = core_err(got.cpu(), fault,
                                               torch.float32)
    check(res["fault_scatter_no_zeroing"] > CORE_BAR[torch.float32],
          f"phase 21 (a): the planted fault (scatter adding without zeroing) "
          f"read {res['fault_scatter_no_zeroing']:.3g}, within the bar")
    res["worst_over_bar"] = worst
    log(f"phase 21 (a): {len(res['cases'])} cases (bf16 and f32) at "
        f"{list(CORE_SQ)} and {list(CORE_BIG)} on the card against the CPU; "
        f"worst error over its bar by family: " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items())
        + f"; creation with no place on {sorted(set(res['creation'].values()))};"
        f" the fault (scatter without zeroing) {res['fault_scatter_no_zeroing']:.3g}"
        f" (must exceed {CORE_BAR[torch.float32]}) [{card}]")
    log("phase 21 (a): error by case (bar bf16 2^-7, f32 1e-4, exact 0): "
        + ", ".join(f"{k} {r['err']:.3g}" for k, r in res["cases"].items()))
    for key, r in res["cases"].items():
        check(r["err"] <= r["bar"], f"phase 21 (a): {key}: error "
              f"{r['err']:.3g} over its bar {r['bar']:.3g}")
    return res


def core_model(seed, dev):
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = CORE_LAYERS
    model = amp.decorate(LlamaForCausalLM(cfg, device=dev, seed=seed),
                         level="O2", dtype="bfloat16")
    return cfg, model, AdamW(learning_rate=CORE_LR,
                             parameters=model.parameters())


def core_run(seed, dev, x_np, y_np, via_core, counted=None):
    """One warm step and CORE_STEPS steps of the 7B-width model, through
    the core (`to_tensor`, `paddle.autograd.backward`, `no_grad`) or
    through torch's calls; losses, probe weights before and after, step
    ms; with `counted`, the kernels' launches of the counted steps and of
    the no_grad forward, and paddle.grad of the final norm's weight
    against its .grad from backward."""
    P = ptt
    cfg, model, opt = core_model(seed, dev)
    named = dict(model.named_parameters())
    init = {n: named[n].detach().float().clone() for n in CORE_PROBES}
    if via_core:
        ids, labels = P.to_tensor(x_np), P.to_tensor(y_np)
    else:
        ids = torch.from_numpy(x_np).to(dev)
        labels = torch.from_numpy(y_np).to(dev)

    def step():
        loss = model.compute_loss(model(ids), labels)
        if via_core:
            P.autograd.backward(loss)
        else:
            loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    losses = [step()]
    torch.cuda.synchronize()
    out = dict(step_ms=[])
    if counted is not None:
        for _, mod, attr in TRAIN_COUNTERS:
            setattr(mod, attr, 0)
    for _ in range(CORE_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    if counted is not None:
        out["launches"] = {n: getattr(m, a) for n, m, a in TRAIN_COUNTERS}
        for _, mod, attr in TRAIN_COUNTERS:
            setattr(mod, attr, 0)
    ctx = P.no_grad() if via_core else torch.no_grad()
    with ctx:
        last = model.compute_loss(model(ids), labels)
    check(not last.requires_grad, "phase 21 (b): no_grad's loss needs grad")
    if counted is not None:
        out["no_grad_launches"] = {n: getattr(m, a)
                                   for n, m, a in TRAIN_COUNTERS}
        # paddle.grad against backward's .grad for the final norm's weight
        w = model.llama.norm.weight
        loss = model.compute_loss(model(ids), labels)
        (gw,) = P.grad(loss, [w], retain_graph=True)
        check(w.grad is None, "phase 21 (b): grad left a .grad")
        P.autograd.backward(loss)
        out["grad_equal"] = bool(torch.equal(gw, w.grad))
        out["grad_norm"] = float(gw.float().norm())
        opt.clear_grad()
    out["losses"] = [float(v) for v in losses] + [float(last)]
    out["probes"] = {n: (named[n].detach().float() - init[n]).cpu()
                     for n in CORE_PROBES}
    out["after"] = {n: named[n].detach().float().cpu() for n in CORE_PROBES}
    del model, opt, named, init
    gc.collect()
    torch.cuda.empty_cache()
    return out


def core_dist(a, b, update):
    """||a - b|| over ||update|| (a probe's weights after the steps)."""
    return float((a - b).norm() / update.norm().clamp_min(1e-30))


def core_eager_step(seed, dev, card):
    """(b): the 7B-width eager step through the core, once counted, and
    twice through torch's calls (their spread); the checks of part (b)."""
    P = ptt
    rng = np.random.RandomState(seed + 21)
    vocab = LlamaConfig.llama2_7b().vocab_size
    x_np = rng.randint(0, vocab, (1, CORE_SEQ))
    y_np = rng.randint(0, vocab, (1, CORE_SEQ))
    P.set_device("gpu")
    core = core_run(seed, dev, x_np, y_np, via_core=True, counted=True)
    a = core_run(seed, dev, x_np, y_np, via_core=False)
    b = core_run(seed, dev, x_np, y_np, via_core=False)
    per_step = {"flash_fwd": CORE_LAYERS, "flash_bwd": CORE_LAYERS,
                "rms_norm": 2 * CORE_LAYERS + 1,
                "rms_norm_bwd": 2 * CORE_LAYERS + 1,
                "adam": n_param_tensors(CORE_LAYERS)}
    want = {n: k * CORE_STEPS for n, k in per_step.items()}
    want_nograd = dict(flash_fwd=CORE_LAYERS, flash_bwd=0,
                       rms_norm=2 * CORE_LAYERS + 1, rms_norm_bwd=0, adam=0)
    loss_spread = [abs(u - v) for u, v in zip(a["losses"], b["losses"])]
    loss_core = [min(abs(c - u), abs(c - v)) for c, u, v in
                 zip(core["losses"], a["losses"], b["losses"])]
    w_spread = {n: core_dist(a["after"][n], b["after"][n], a["probes"][n])
                for n in CORE_PROBES}
    w_core = {n: min(core_dist(core["after"][n], a["after"][n],
                               a["probes"][n]),
                     core_dist(core["after"][n], b["after"][n],
                               b["probes"][n])) for n in CORE_PROBES}
    p50 = float(np.median(core["step_ms"]))
    res = dict(losses=core["losses"], torch_losses=[a["losses"],
                                                      b["losses"]],
               loss_spread=loss_spread, loss_core=loss_core,
               weight_spread=w_spread, weight_core=w_core,
               launches=core["launches"], no_grad_launches=core[
                   "no_grad_launches"], grad_equal=core["grad_equal"],
               step_ms=core["step_ms"], step_ms_p50=p50,
               torch_step_ms_p50=float(np.median(a["step_ms"] +
                                                 b["step_ms"])))
    log(f"phase 21 (b): LLaMA-2-7B widths at {CORE_LAYERS} layers, bf16 O2, "
        f"AdamW, 1 x {CORE_SEQ}, through the core: losses "
        + ", ".join(f"{v:.6f}" for v in core["losses"])
        + f" (the last under no_grad); torch calls "
        + " / ".join(", ".join(f"{v:.6f}" for v in r["losses"])
                     for r in (a, b))
        + f"; the first loss bit-equal: {core['losses'][0] == a['losses'][0]}"
        f"; later losses' distance to the nearest torch run "
        + ", ".join(f"{v:.3g}" for v in loss_core[1:])
        + " against the torch runs' spread "
        + ", ".join(f"{v:.3g}" for v in loss_spread[1:])
        + "; probe weights over their update, core "
        + ", ".join(f"{v:.3g}" for v in w_core.values())
        + " against spread " + ", ".join(f"{v:.3g}" for v in
                                         w_spread.values())
        + f"; step p50 {p50:.1f} ms (torch calls "
        f"{res['torch_step_ms_p50']:.1f}); launches {core['launches']}, "
        f"no_grad forward {core['no_grad_launches']}; paddle.grad of the "
        f"final norm's weight bit-equal to backward's .grad: "
        f"{core['grad_equal']} [{card}]")
    check(core["launches"] == want, f"phase 21 (b): launches "
          f"{core['launches']}, expected {want}")
    check(core["no_grad_launches"] == want_nograd, f"phase 21 (b): the "
          f"no_grad forward launched {core['no_grad_launches']}, expected "
          f"{want_nograd}")
    check(core["losses"][0] == a["losses"][0] == b["losses"][0],
          f"phase 21 (b): first losses {core['losses'][0]}, "
          f"{a['losses'][0]}, {b['losses'][0]} not bit-equal")
    check(all(math.isfinite(v) for v in core["losses"]),
          f"phase 21 (b): losses {core['losses']}")
    for i, c in enumerate(loss_core):
        ulp = 2.0 ** (math.floor(math.log2(abs(a["losses"][i]))) - 7)
        bar = max(CORE_SPREAD * max(loss_spread), 2 * ulp)
        check(c <= bar, f"phase 21 (b): loss {i}: {c:.3g} from the torch "
              f"runs, over {bar:.3g} (their spread {loss_spread})")
    for n in CORE_PROBES:
        check(w_core[n] <= CORE_SPREAD * w_spread[n] + CORE_FLOOR,
              f"phase 21 (b): {n}: {w_core[n]:.3g} from the torch runs, "
              f"their spread {w_spread[n]:.3g}")
    check(core["grad_equal"], "phase 21 (b): paddle.grad of the final "
          "norm's weight differs from backward's .grad")
    return res


def core_pylayer(seed, dev, card):
    """(c): a PyLayer over the RMSNorm kernels against RMSNormFunction at
    [4096, 4096] bf16: y, dx and dw bit-equal, one forward and one
    backward launch; the planted fault: a non-scalar backward seeded with
    zeros, which must differ."""
    P = ptt

    class KernelRMSNorm(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, w, eps):
            y, rstd = krms.rms_norm(x, w, eps, with_rstd=True)
            ctx.save_for_backward(x, w, rstd)
            return y

        @staticmethod
        def backward(ctx, g):
            x, w, rstd = ctx.saved_tensor()
            return krms.rms_norm_bwd(x, w, rstd, g.contiguous())

    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    x0 = torch.randn(CORE_SQ, device=dev, generator=gen).to(torch.bfloat16)
    w0 = (1 + 0.1 * torch.randn(CORE_SQ[1], device=dev, generator=gen)).to(
        torch.bfloat16)

    def run(fn, seed_zeros=False):
        x = x0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        y = fn(x, w)
        if seed_zeros:
            torch.autograd.backward(y, torch.zeros_like(y))
        else:
            P.autograd.backward(y)  # a non-scalar output: seeded with ones
        return y.detach(), x.grad, w.grad

    krms.launches = krms.bwd_launches = 0
    got = run(lambda x, w: KernelRMSNorm.apply(x, w, 1e-6))
    launches = dict(rms_norm=krms.launches, rms_norm_bwd=krms.bwd_launches)
    want = run(lambda x, w: krms.RMSNormFunction.apply(x, w, 1e-6))
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    bad = run(lambda x, w: KernelRMSNorm.apply(x, w, 1e-6), seed_zeros=True)
    fault = [bool(torch.equal(a, b)) for a, b in zip(bad, want)]
    res = dict(equal=equal, launches=launches, fault_equal=fault)
    log(f"phase 21 (c): a PyLayer over the RMSNorm kernels at {list(CORE_SQ)} "
        f"bf16 against RMSNormFunction: y, dx, dw bit-equal {equal}, "
        f"launches {launches}; the fault (backward seeded with zeros): "
        f"bit-equal {fault} (dx and dw must differ) [{card}]")
    check(all(equal), f"phase 21 (c): PyLayer against RMSNormFunction: "
          f"{equal}")
    check(launches == dict(rms_norm=1, rms_norm_bwd=1),
          f"phase 21 (c): launches {launches}")
    check(not fault[1] and not fault[2], "phase 21 (c): the planted fault "
          "(a backward seeded with zeros) was not caught")
    return res


def core_phase(seed, dev, card):
    """Phase 21: (a), (b), (c), the place restored after."""
    from paddle_tpu_torch.framework import device as tdevice

    t0 = time.perf_counter()
    prev = tdevice._current_place
    try:
        res = dict(ops=core_ops(seed, dev, card))
        res["ops_s"] = time.perf_counter() - t0
        res["eager"] = core_eager_step(seed, dev, card)
        res["pylayer"] = core_pylayer(seed, dev, card)
    finally:
        tdevice._current_place = prev
    res["phase_s"] = time.perf_counter() - t0
    launches = dict(res["eager"]["launches"])
    for part in (res["eager"]["no_grad_launches"],
                 res["pylayer"]["launches"]):
        for n, k in part.items():
            launches[n] = launches.get(n, 0) + k
    res["launches"] = launches
    log(f"phase 21: {res['phase_s']:.1f} s ((a) {res['ops_s']:.1f}); "
        f"launches {launches} [{card}]")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--phase11", choices=CELLS, default=None,
                    help="run one cell of phase 11 in this process (the "
                    "script starts one process a cell itself)")
    ap.add_argument("--phase12", choices=PREFIX_CELLS, default=None,
                    help="run one cell of phase 12 in this process (the "
                    "script starts one process a cell itself)")
    ap.add_argument("--phase13", choices=SPEC_CELLS, default=None,
                    help="run one cell of phase 13 in this process (the "
                    "script starts one process a cell itself)")
    ap.add_argument("--phase14", choices=GPT_CELLS, default=None,
                    help="run one cell of phase 14 in this process (the "
                    "script starts one process a cell itself)")
    ap.add_argument("--phase15", action="store_true",
                    help="build the kernels and run phase 15 alone (a probe: "
                    "no kernels line, no final line)")
    ap.add_argument("--phase16", action="store_true",
                    help="build the kernels and run phase 16 alone (a probe: "
                    "no kernels line, no final line)")
    ap.add_argument("--phase17", action="store_true",
                    help="build the kernels and run phase 17 alone (a probe: "
                    "no kernels line, no final line)")
    ap.add_argument("--phase18", action="store_true",
                    help="build the kernels and run phase 18 alone (a probe: "
                    "no kernels line, no final line)")
    ap.add_argument("--phase19", action="store_true",
                    help="build the kernels and run phase 19 alone (a probe: "
                    "no kernels line, no final line)")
    ap.add_argument("--phase20", action="store_true",
                    help="build the kernels and run phase 20 alone (a probe: "
                    "no kernels line, no final line)")
    ap.add_argument("--phase21", action="store_true",
                    help="build the kernels and run phase 21 alone (a probe: "
                    "no kernels line, no final line)")
    ap.add_argument("--go", default=None,
                    help="with --phase11 to --phase14: wait for this file "
                    "after the imports and the CUDA context (the script "
                    "starts each cell's process while the one before runs)")
    ap.add_argument("--io", default=None,
                    help="with --phase11: the directory of the streams it "
                    "is held to and of its result; with --phase12, "
                    "--phase13 or --phase14: of its result")
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
    child = args.phase11 or args.phase12 or args.phase13 or args.phase14
    if child:
        stage(child, "imports and CUDA context")
        if args.go:
            wait_go(args.go, child)
    if args.phase11:
        res = multi_step_cell(args.phase11, args.seed, dev, card, args.io)
        with open(os.path.join(args.io, f"{args.phase11}.json"), "w") as f:
            json.dump(res, f)
        stage(child, "done")
        return 0
    if args.phase12:
        res = prefix_cell(args.phase12, args.seed, dev, card)
        with open(os.path.join(args.io, f"{args.phase12}.json"), "w") as f:
            json.dump(res, f)
        stage(child, "done")
        return 0
    if args.phase13:
        res = spec_cell(args.phase13, args.seed, dev, card)
        with open(os.path.join(args.io, f"{args.phase13}.json"), "w") as f:
            json.dump(res, f)
        stage(child, "done")
        return 0
    if args.phase14:
        res = GPT_CELL_FNS[args.phase14](args.seed, dev, card)
        with open(os.path.join(args.io, f"{args.phase14}.json"), "w") as f:
            json.dump(res, f)
        stage(child, "done")
        return 0

    t_script = time.perf_counter()

    def mark(what):
        log(f"timeline: {what} done at "
            f"{time.perf_counter() - t_script:.1f} s")

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

    if args.phase15:
        finetune_phase(args.seed, card)
        return 0
    if args.phase16:
        tp_phase(args.seed, card, ("16",))
        return 0
    if args.phase20:
        tp_phase(args.seed, card, ("20",))
        return 0
    if args.phase17:
        tps_phase(args.seed, card)
        return 0
    if args.phase18 or args.phase19:
        zero_phase(args.seed, card, ("18",) if args.phase18 else ("19",))
        return 0
    if args.phase21:
        core_phase(args.seed, dev, card)
        return 0

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
    # checked, not timed: contexts at the split edges of each plan, one
    # 4096-token row among rows of 0 and 1, batch 1 x 4096, and 5-token
    # pages (page segments that cross a 32-token stage; int8: 20-byte scale
    # rows, the kernel's second copy path)
    lone = [0, 1, 0, 1, 4096, 1, 0, 1]
    lens5 = [0, 1, 4, 5, 6, 1000, 2049, 4096]
    paged += [paged_case(f"{tag}_bf16_split_edges", bf16, qh, kvh, gen, dev,
                         split_lens(qh, kvh, 128), timed=False)
              for tag, qh, kvh in (("mha", 32, 32), ("gqa", 32, 8),
                                   ("mqa", 32, 1))]
    paged += [paged_case("mha_bf16_lone_long", bf16, 32, 32, gen, dev, lone,
                         timed=False),
              paged_case("mha_bf16_b1", bf16, 32, 32, gen, dev, [4096],
                         timed=False),
              paged_case("gqa_bf16_page5", bf16, 32, 8, gen, dev, lens5,
                         page=5, pages_per_seq=820, timed=False),
              paged_case("mha_f32_page5", f32, 8, 8, gen, dev, lens5, page=5,
                         pages_per_seq=820, timed=False)]
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
    paged_q8 += [paged_q8_case(f"{tag}_split_edges", bf16, qh, kvh, gen,
                               dev, split_lens(qh, kvh, 128), timed=False)
                 for tag, qh, kvh in (("mha_bf16_13b", 40, 40),
                                      ("gqa_bf16", 32, 8))]
    paged_q8 += [paged_q8_case("mha_bf16_13b_lone_long", bf16, 40, 40, gen,
                               dev, lone, timed=False),
                 paged_q8_case("mha_bf16_13b_b1", bf16, 40, 40, gen, dev,
                               [4096], timed=False),
                 paged_q8_case("gqa_bf16_page5", bf16, 32, 8, gen, dev,
                               lens5, page=5, pages_per_seq=820, timed=False),
                 paged_q8_case("mha_f32_page5", f32, 8, 8, gen, dev, lens5,
                               page=5, pages_per_seq=820, timed=False)]
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
    grouped += [grouped_case(f"{tag}_bf16_split_edges", bf16, qh, kvh, gen,
                             dev, split_lens(qh, kvh, 128),
                             timed=False)
                for tag, qh, kvh in (("mha", 32, 32), ("gqa", 32, 8))]
    grouped += [grouped_case("mha_bf16_lone_long", bf16, 32, 32, gen, dev,
                             lone, timed=False),
                grouped_case("mha_bf16_b1", bf16, 32, 32, gen, dev, [4096],
                             timed=False)]
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

    mark("phase 3 (checks)")
    # 4. the serving path: LLaMA-2-7B
    serving = serve_7b(args.seed, dev, card)
    mark("phase 4")

    # 4b. quantized serving: LLaMA-2-13B, int8 weights, then int4 g128,
    # over an int8 KV cache
    serving13 = serve_13b(args.seed, dev, card, "weight_only_int8", -1)
    serving13_int4 = serve_13b(args.seed, dev, card, "weight_only_int4", 128,
                               lone=False)
    mark("phase 4b")

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
    mark("phase 3 (times)")
    gc.collect()
    torch.cuda.empty_cache()

    # 5. a tiny model decodes the same on CUDA and CPU, float and quantized
    parity = tiny_parity(args.seed, dev)
    quant_parity = tiny_quant_parity(args.seed, dev)
    mqa_parity = tiny_mqa_parity(args.seed, dev)

    mark("phase 5")
    # 6. the training path: 20-layer LLaMA-2-7B widths, batch 1 x 4096
    training = train_7b(args.seed, dev, card)
    mark("phase 6")

    # 7. tiny training: CUDA kernels against the CPU's plain versions
    train_parity = tiny_train_parity(args.seed, dev)

    # 8. measured dispatch: serving and training with FLAGS_autotune and
    # FLAGS_paged_grouped_kernel on, then off again
    mark("phase 7")
    dispatch = measured_dispatch(args.seed, dev, card, serving)
    mark("phase 8")

    # 9. varlen and dropout flash attention: the seg, drop and seg_drop
    # kernels, packed LLaMA-2-7B attention, the fused GPT-3 1.3B encoder
    # with attention dropout, the lse entry, a tiny CUDA-vs-CPU encoder
    variants, timed = flash_variants(args.seed, dev, card)
    mark("phase 9")

    # 10. the rest of the training step: (a) the Adam kernel against its
    # plain version at the 7B shapes; (b) the 7B-width step through the new
    # surface; (c) an O1 + GradScaler eager loop; (d) tiny CUDA-vs-CPU
    # parity of (b)'s options
    adam_k = adam_kernel_cases(gen, dev, card)
    surface = train_surface(training["max_memory_allocated_gib"], args.seed,
                            dev, card)
    o1 = o1_scaler_loop(args.seed, dev, card)
    surface_parity = tiny_surface_parity(args.seed, dev)
    mark("phase 10")

    # from here on, each child process (phases 11-14's cells, phases 15-20's
    # ranks) starts while the work before it runs, and waits for its turn
    start_child("11", CELLS[0], args.seed)

    # 21. the Paddle-shaped core: (a) its ops on the card against the CPU at
    # the 7B widths; (b) the 7B-width eager step through to_tensor,
    # backward, grad and no_grad against the torch-call step; (c) a PyLayer
    # over the RMSNorm kernels
    core = core_phase(args.seed, dev, card)
    mark("phase 21")

    # 11. multi-step serving decode: phase 4's and 4b's cells at
    # decode_burst 8 (each program a CUDA graph), sync and async, in fresh
    # processes
    multi_step = multi_step_serving(args.seed, card, serving, serving13,
                                    then=("12", PREFIX_CELLS[0]))
    mark("phase 11")

    # 12. the prefix cache and chunked prefill: the 7B and 13B int8 cells,
    # each in a fresh process
    prefix = prefix_serving(args.seed, card, then=("13", SPEC_CELLS[0]))
    mark("phase 12")
    p7, p13 = prefix["7b"]["launches"], prefix["13b_int8"]["launches"]

    # 13. speculative decoding: the 7B, 7B target-as-draft and 13B int8
    # cells, each in a fresh process
    spec = spec_serving(args.seed, card, then=("14", GPT_CELLS[0]))
    mark("phase 13")
    s7, s13 = dict(spec["7b"]["launches"]), spec["13b_int8"]["launches"]
    for name, n in spec["7b_target_draft"]["launches"].items():
        s7[name] = s7.get(name, 0) + n

    # 14. the GPT family: GPT-3 1.3B served, trained and run as
    # FusedMultiTransformer, a tiny GPT on CUDA against the CPU, each cell
    # in a fresh process
    ft_start("ft_full", args.seed, card)  # waits through phase 14
    gpt = gpt_phase(args.seed, card)
    mark("phase 14")
    g_serve = gpt["serve"]["launches"]
    g_train = gpt["train"]["launches"]
    g_fwd = g_train["flash_fwd"] + gpt["fmt"]["launches"]["flash_fwd"]

    # 15. the data-parallel fine-tune: the uninterrupted run and the resume
    # (each spawned at world 1 over NCCL), two gloo ranks on the card, the
    # tensor checker; the kernels' launches on its main path (the full run
    # and the resumed steps)
    finetune = finetune_phase(
        args.seed, card, early=lambda: tp_start("llama", args.seed),
        then=lambda: tp_start("gpt", args.seed))
    mark("phase 15")
    ft = {n: finetune["full"]["launches"][n]
          + finetune["resume"]["resumed"]["launches"][n]
          for n in finetune["full"]["launches"]}

    # 16. tensor parallelism through fleet: GPT-3 1.3B at TP 4 and
    # LLaMA-2-7B's widths at TP 2 over gloo on the card, against tp 1; the
    # kernels' launches of every rank's counted steps
    tensor_parallel = tp_phase(args.seed, card,
                               then=lambda: tps_start(args.seed))
    mark("phases 16 and 20")
    # phases 15, 16 and 20's launches, one sum a kernel
    par = {n: ft[n] + tensor_parallel["launches"][n]
           + tensor_parallel["20"]["launches"].get(n, 0) for n in ft}

    # 17. tensor-parallel serving: LLaMA-2-7B's widths and LLaMA-2-13B's
    # int8 at TP 2, two engines on gloo ranks on the card, against tp 1;
    # the kernels' launches of both ranks' counted runs
    tp_serving = tps_phase(args.seed, card,
                           then=lambda: zero_start(args.seed))
    mark("phase 17")
    t17 = tp_serving["launches"]

    # 18. ZeRO stages 0-3 at LLaMA-2-7B's widths on two gloo ranks of the
    # card, and DTensor's shard / reshard there; 19. in the same ranks, the
    # pipeline schedules at pp 2 against pp 1; the kernels' launches of
    # every stage's and schedule's counted steps on both ranks, added to
    # phases 15-16's
    both = zero_phase(args.seed, card)
    zero, pipeline = both["18"], both["19"]
    mark("phases 18-19")
    par = {n: par[n] + zero["launches"].get(n, 0)
           + pipeline["launches"].get(n, 0) for n in par}

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
    for counts in (dispatch["serving"]["launches"]["matmul_by_variant"],
                   dispatch["serving_pinned"]["launches"][
                       "matmul_by_variant"],
                   dispatch["training"]["readonly_pinned"]["launches"][
                       "matmul_by_variant"],
                   t17.get("matmul_by_variant", {})):
        for v, n in counts.items():
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
    # phase 11's launches inside graphs, counted from the profiler's records
    # of its traffic and burst windows (the 13B cell's paged decodes are
    # the int8 kernel's)
    def graphed(cell):
        out = {}
        for mode in ("sync", "async"):
            r = multi_step[f"{cell}_{mode}"]
            for part in (r["launches"], r["profile"]["launches"]):
                for name, n in part.items():
                    out[name] = out.get(name, 0) + n
        return out

    g7, g13 = graphed("7b"), graphed("13b_int8")
    kernels = [
        # launches: the serving runs' counts plus the training run's
        row("rms_norm", csrc + "rms_norm.cu", ref + "rms_norm.py:71", rms[0],
            served["rms_norm"] + q8["rms_norm"] + q4["rms_norm"]
            + trained["rms_norm"] + g7["rms_norm"] + g13["rms_norm"]
            + p7["rms_norm"] + p13["rms_norm"] + s7["rms_norm"]
            + s13["rms_norm"] + par["rms_norm"] + t17["rms_norm"]
            + core["launches"]["rms_norm"]),
        row("rms_norm_bwd", csrc + "rms_norm.cu", ref + "rms_norm.py:101",
            rms_bwd[0], trained["rms_norm_bwd"] + par["rms_norm_bwd"]
            + core["launches"]["rms_norm_bwd"]),
        row("paged_attention", csrc + "paged_attention.cu",
            ref + "paged_attention.py:584", paged[0],
            served["paged_attention"] + g7["paged_attention"]
            + p7["paged_attention"] + s7["paged_attention"]
            + g_serve["paged_attention"] + t17["paged_attention"]),
        # the plain flash bodies: the training run's and phase 9 (d)'s
        row("flash_fwd", csrc + "flash_attention.cu",
            ref + "flash_attention.py:214", flash[0]["fwd"],
            trained["flash_fwd"] + lse_launches["fwd_plain"] + g_fwd
            + par["flash_fwd"] + core["launches"]["flash_fwd"]),
        # the one backward kernel, under both sites it replaces: the dK/dV
        # pass and the dQ pass
        row("flash_bwd", csrc + "flash_attention.cu",
            ref + "flash_attention.py:473", flash[0]["bwd"],
            trained["flash_bwd"] + lse_launches["bwd_plain"]
            + g_train["flash_bwd"] + par["flash_bwd"]
            + core["launches"]["flash_bwd"]),
        row("flash_bwd", csrc + "flash_attention.cu",
            ref + "flash_attention.py:534", flash[0]["bwd"],
            trained["flash_bwd"] + lse_launches["bwd_plain"]
            + g_train["flash_bwd"] + par["flash_bwd"]
            + core["launches"]["flash_bwd"]),
        # the dequant matmul's two bf16 kernels: m > 16 and m <= 16
        row("quant_matmul_prefill", csrc + "quant_matmul.cu",
            ref + "quant_matmul.py:208",
            case(qmm, "5120->13824 m2512 int8 g-1"),
            q8by["prefill"] + q4by["prefill"]
            + p13["quant_matmul_prefill"] + s13["quant_matmul_prefill"]
            + t17["quant_matmul_prefill"]),
        row("quant_matmul_decode", csrc + "quant_matmul.cu",
            ref + "quant_matmul.py:208", case(qmm, "5120->13824 m8 int8 g-1"),
            q8by["decode"] + q4by["decode"] + g13["quant_matmul_decode"]
            + p13["quant_matmul_decode"] + s13["quant_matmul_decode"]
            + t17["quant_matmul_decode"]),
        row("paged_attention_int8", csrc + "paged_attention.cu",
            ref + "paged_attention.py:584", paged_q8[0],
            q8["paged_attention_int8"] + q4["paged_attention_int8"]
            + g13["paged_attention"] + p13["paged_attention_int8"]
            + s13["paged_attention"] + t17["paged_attention_int8"]),
        # the GEMM's variants that ran; launches: phase 8's counted runs
        *[variant_row(v, n) for v, n in sorted(by_variant.items()) if n],
        row("paged_attention_grouped", csrc + "paged_attention.cu",
            ref + "paged_attention.py:523", grouped[0],
            dispatch["serving"]["launches"]["paged_attention_grouped"]
            + dispatch["serving_pinned"]["launches"][
                "paged_attention_grouped"]),
    ]
    # the Adam update (no pallas_call: the reference's XLA-fused update);
    # launches: phase 6's timed steps and phase 10 (b)'s timed calls
    kernels.append(row("adam_update", csrc + "adam.cu",
                       "paddle_tpu/optimizer/optimizer.py:248",
                       adam_k["timed"],
                       trained["adam"] + surface["launches"]["adam"]
                       + g_train["adam"] + par["adam"]
                       + core["launches"]["adam"]))
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
                           adam=adam_k, surface=surface, o1_scaler=o1,
                           surface_parity=surface_parity,
                           multi_step=multi_step, prefix=prefix, spec=spec,
                           gpt=gpt, finetune=finetune,
                           tensor_parallel=tensor_parallel,
                           tp_serving=tp_serving, zero=zero,
                           pipeline=pipeline, core=core,
                           kernels=kernels),
                      f, indent=1)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        end_started()
    sys.exit(rc)
