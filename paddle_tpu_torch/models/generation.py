"""Token sampling and `generate` (counterpart of `sample_logits`,
`sample_logits_per_row` and `generate` in `paddle_tpu/models/generation.py`).

Random draws come from an explicit `torch.Generator` on the logits' device.
A generator and a `jax.random` key give different numbers from one seed, so
sampled streams match the JAX package in distribution, not token for token;
greedy streams match exactly. Every function here reads nothing back to the
host, so it runs inside a captured CUDA graph; a graph that draws from a
generator other than the device's default must have it registered
(`CUDAGraph.register_generator_state`, as the serving engine does) so that
each replay advances it. A greedy row's token never depends on the draws.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import random as _random

_MASKED = -1e30


def _categorical(logits, generator):
    """One draw per row from softmax(logits) by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _pick(lp, tok):
    return lp.gather(-1, tok[:, None])[:, 0]


def sample_logits(logits, generator, decode_strategy="sampling",
                  temperature=1.0, top_k=0, top_p=1.0):
    """Next tokens from [b, vocab] logits, one set of parameters for all
    rows. Returns (tokens [b] int64, logprobs [b] f32)."""
    logits = logits.float()
    if decode_strategy == "greedy_search":
        tok = torch.argmax(logits, dim=-1)
        return tok, _pick(torch.log_softmax(logits, dim=-1), tok)
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1, descending=True).values[
            :, int(top_k) - 1][:, None]
        logits = logits.masked_fill(logits < kth, _MASKED)
    if top_p < 1.0:
        logits = _nucleus(logits, torch.full(
            (logits.shape[0],), float(top_p), device=logits.device))
    tok = _categorical(logits, generator)
    return tok, _pick(torch.log_softmax(logits, dim=-1), tok)


def _nucleus(f, top_p):
    """Mask tokens outside each row's top-p nucleus. A token is kept when
    the probability mass before it (in descending order) is below top_p;
    the argmax is always kept."""
    sorted_f = torch.sort(f, dim=-1, descending=True).values
    probs = torch.softmax(sorted_f, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    first = torch.arange(f.shape[-1], device=f.device)[None, :] == 0
    keep = ((cum - probs) < top_p[:, None]) | first
    thresh = torch.where(keep, sorted_f, torch.inf).amin(dim=-1,
                                                         keepdim=True)
    return f.masked_fill(f < thresh, _MASKED)


def filter_logits_per_row(logits, temperature, top_k, top_p):
    """The per-row temperature, top-k and top-p filters of
    `sample_logits_per_row` (top_k == 0 and top_p == 1.0 disable a filter
    for that row). Returns the filtered f32 logits; masked entries are
    -1e30."""
    f = logits.float() / temperature.float().clamp_min(1e-6)[:, None]
    sorted_desc = torch.sort(f, dim=-1, descending=True).values
    kk = top_k.long().clamp(0, f.shape[-1])
    kth = sorted_desc.gather(-1, (kk - 1).clamp_min(0)[:, None])
    f = f.masked_fill((kk[:, None] > 0) & (f < kth), _MASKED)
    top_p = top_p.float()
    nucleus = _nucleus(f, top_p)
    return torch.where((top_p < 1.0)[:, None], nucleus, f)


def sample_logits_per_row(logits, generator, greedy, temperature, top_k,
                          top_p):
    """Per-row sampling from [b, vocab] logits, each row with its own
    parameters ([b] tensors on the logits' device): greedy rows take the
    argmax, the others draw from their filtered distribution. Returns
    (tokens [b] int64, logprobs [b] f32)."""
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1)
    f = filter_logits_per_row(logits, temperature, top_k, top_p)
    sampled = _categorical(f, generator)
    tok = torch.where(greedy, greedy_tok, sampled)
    lp = torch.where(greedy,
                     _pick(torch.log_softmax(logits, dim=-1), greedy_tok),
                     _pick(torch.log_softmax(f, dim=-1), sampled))
    return tok, lp


@torch.no_grad()
def generate(model, input_ids, max_length=None, max_new_tokens=None,
             decode_strategy="greedy_search", temperature=1.0, top_k=0,
             top_p=1.0, eos_token_id=None, pad_token_id=0, seed=None):
    """PaddleNLP-style generation over the model's dense caches: one
    prefill of the prompt through `forward_cached` (`init_kv_caches` sized
    for prompt + new tokens, f32), then one token a step through
    `forward_cached` until `max_new_tokens` (PaddleNLP's `max_length`
    counts generated tokens too; default 20) or every row has emitted
    `eos_token_id`; a finished row takes `pad_token_id` and adds nothing to
    its score. Returns (new tokens [b, n_new] int64, scores [b] f32: each
    row's summed log-probabilities), on the model's device.

    The loop runs eagerly, one host read a step for the stop test, where
    the reference compiles it as one while loop. Decode steps take their
    position as a tensor, as the reference's traced loop does, so a learned
    position past `max_position_embeddings` clamps (GPT) rather than
    raising. Sampling draws from a `torch.Generator` seeded by `seed`, or
    from the global stream: other tokens than `jax.random`'s for one seed;
    greedy streams are the reference's."""
    dev = model._backbone_embed_weight().device
    ids = torch.as_tensor(np.asarray(input_ids) if not torch.is_tensor(
        input_ids) else input_ids).to(dev, torch.int64)
    if ids.dim() == 1:
        ids = ids[None, :]
    batch, prompt_len = ids.shape
    if max_new_tokens is None:
        max_new_tokens = max_length if max_length is not None else 20
    if int(max_new_tokens) < 1:
        raise ValueError(
            f"max_new_tokens/max_length must be >= 1, got {max_new_tokens}")
    total_len = prompt_len + int(max_new_tokens)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) if seed is not None else _random.next_seed())
    caches = model.init_kv_caches(batch, total_len)
    logits, caches = model.forward_cached(ids, caches, 0)
    last = model.gather_logits(logits[:, -1, :])
    tokens = torch.cat([ids, torch.full((batch, total_len - prompt_len),
                                        pad_token_id, dtype=torch.int64,
                                        device=dev)], dim=1)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    scores = torch.zeros(batch, dtype=torch.float32, device=dev)
    cur = prompt_len
    while cur < total_len and not bool(done.all()):
        tok, lp = sample_logits(last, gen, decode_strategy, temperature,
                                top_k, top_p)
        tok = torch.where(done, pad_token_id, tok)
        scores = scores + torch.where(done, 0.0, lp)
        tokens[:, cur] = tok
        if eos_token_id is not None:
            done = done | (tok == eos_token_id)
        if cur + 1 < total_len:  # nothing left to predict after the last
            logits, caches = model.forward_cached(
                tok[:, None], caches, torch.tensor(cur))
            last = model.gather_logits(logits[:, -1, :])
        cur += 1
    return tokens[:, prompt_len:], scores
