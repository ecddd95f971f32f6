"""Token sampling (counterpart of `sample_logits` and
`sample_logits_per_row` in `paddle_tpu/models/generation.py`).

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

import torch

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
