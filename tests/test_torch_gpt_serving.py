"""The port's serving engine over a GPT against the JAX package's, on the CPU
in f32: greedy token streams bit for bit, and the speculative engines'
proposed and accepted totals equal.

The models are the reference's serving GPTs on identical weights (carried
across by `weights.load_gpt_state`): `tests/test_serving_spec.py::
test_gpt_model_window_path`'s (vocab 89, hidden 32, 4 layers, 4 heads, 64
positions, seed 2) for every engine mode the port serves LLaMA with (eager,
`decode_burst` 4, `async_depth` 1, int8 KV, the prefix cache with chunked
prefill, shallow-exit and draft-model speculation), and
`tests/test_serving_async.py::TestGPTServing`'s (vocab 97, hidden 128, 2
layers, one head, seed 0) against `generate`. Neither config has
`num_key_value_heads`: the engine takes one KV head a query head, for the
target and for a draft model. Learned positions go per row
(`context_lens + arange(s)`) in every path; past the table they clamp
(the reference's gather fills NaN there), and the streams stay equal
because no such position is committed.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.weights import load_gpt_state
from torch_parity import jax_state, serve

VOCAB = 89
KW = dict(max_batch=2, max_seq_len=32, page_size=8,
          decode_strategy="greedy_search")
_PAIRS = {}


def gpt_pair(name="window"):
    """(JAX, port) GPT of the reference's serving tests: "window" (test_gpt_
    model_window_path's), "draft" (its 2-layer draft, seed 4) or
    "generate" (TestGPTServing's)."""
    if name not in _PAIRS:
        if name == "generate":
            paddle.seed(0)
            kw = dict(vocab_size=97, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=1, max_position_embeddings=64)
            jcfg, tcfg = JaxGPTConfig(**kw), GPTConfig(**kw)
        else:
            paddle.seed(2 if name == "window" else 4)
            kw = dict(vocab=VOCAB, hidden=32,
                      layers=4 if name == "window" else 2, heads=4, seq=64)
            jcfg, tcfg = JaxGPTConfig.tiny(**kw), GPTConfig.tiny(**kw)
        jm = JaxGPT(jcfg)
        jm.eval()
        tm = GPTForCausalLM(tcfg, device="cpu")
        load_gpt_state(tm, jax_state(jm))
        tm.eval()
        assert not hasattr(tcfg, "num_key_value_heads")
        _PAIRS[name] = jm, tm
    return _PAIRS[name]


def _prompts(seed, lens, vocab=VOCAB):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)) for n in lens]


def both(prompts, budgets, kw, draft=False, **req):
    """The JAX engine and the port's over the same requests: equal streams
    (returned, with the port's engine and the JAX engine)."""
    jm, tm = gpt_pair()
    jkw, tkw = dict(kw), dict(kw)
    if draft:
        jkw["draft_model"], tkw["draft_model"] = gpt_pair("draft")
    jeng = JaxEngine(jm, **jkw)
    teng = ServingEngine(tm, device="cpu", **tkw)
    want = serve(jeng, prompts, budgets, **req)
    got = serve(teng, prompts, budgets, **req)
    assert got == want
    return got, teng, jeng


@pytest.mark.parametrize("mode", [
    {}, dict(decode_burst=4), dict(decode_burst=4, async_depth=1),
    dict(kv_cache_quant="int8"), dict(prefix_cache=1, prefill_chunk=8)])
def test_greedy_streams_equal_the_jax_engine(mode):
    """Three requests through two slots (one waits), budgets ending
    mid-burst; the third prompt's first 16 tokens are the first's (a
    prefix hit of two pages with the cache)."""
    p = _prompts(5, (19, 9, 3))
    p[2] = np.concatenate([p[0][:16], p[2]])
    _, teng, _ = both(p, [8, 12, 10], dict(KW, **mode))
    if "prefix_cache" in mode:
        assert teng._prefix_hits_total > 0 and teng.chunk_rounds > 0


@pytest.mark.parametrize("spec", [
    dict(spec_decode=4), dict(spec_decode=3, spec_draft_layers=1),
    dict(spec_decode=4, decode_burst=4, kv_cache_quant="int8")])
def test_shallow_spec_equals_the_jax_engines(spec):
    """The counterpart of the reference's `test_gpt_model_window_path`:
    the spec stream is the single-step stream, and the port's proposed and
    accepted totals are the JAX spec engine's. Budgets run the windows
    past the positions a row holds, so the verify and the drafts embed
    positions past their limits."""
    p = _prompts(5, (5, 11))
    want, _, _ = both(p, [8, 19], KW)
    got, teng, jeng = both(p, [8, 19], dict(KW, **spec))
    assert got == want
    assert (teng._spec_proposed_total, teng._spec_accepted_total) == \
        (jeng._spec_proposed_total, jeng._spec_accepted_total)
    assert teng._spec_proposed_total > 0 and teng.spec_rounds > 0


def test_spec_windows_past_the_position_table_equal_the_jax_engines():
    """Rows that end at position 63 of 64: the drafts and the verify embed
    positions past the table (clamped here, NaN-filled by the reference's
    gather); none is committed, so the streams and totals agree."""
    p = _prompts(8, (50, 45))
    kw = dict(KW, max_seq_len=64)
    want, _, _ = both(p, [14, 19], kw)
    got, teng, jeng = both(p, [14, 19], dict(kw, spec_decode=4))
    assert got == want
    assert (teng._spec_proposed_total, teng._spec_accepted_total) == \
        (jeng._spec_proposed_total, jeng._spec_accepted_total)


def test_draft_model_spec_equals_the_jax_engines():
    """A 2-layer GPT draft model (its own pools, one KV head a query
    head)."""
    p = _prompts(6, (5, 7))
    want, _, _ = both(p, [9, 6], KW)
    got, teng, jeng = both(p, [9, 6], dict(KW, spec_decode=4), draft=True)
    assert got == want
    assert (teng._spec_proposed_total, teng._spec_accepted_total) == \
        (jeng._spec_proposed_total, jeng._spec_accepted_total)
    kp = teng._draft_caches[0][0]
    assert kp.shape[0] == 4  # kv heads taken from num_attention_heads


def test_engine_matches_generate():
    """The counterpart of the reference's `TestGPTServing`: the burst
    engine with async_depth 1 decodes what `generate` decodes, and what
    the JAX engine decodes."""
    jm, tm = gpt_pair("generate")
    rng = np.random.RandomState(21)
    prompts = [rng.randint(0, 97, (5,)) for _ in range(2)]
    kw = dict(max_batch=2, max_seq_len=32, page_size=8, decode_burst=4,
              async_depth=1, decode_strategy="greedy_search")
    got = serve(ServingEngine(tm, device="cpu", **kw), prompts, [8, 8])
    assert got == serve(JaxEngine(jm, **kw), prompts, [8, 8])
    for p, out in zip(prompts, got):
        ref = tm.generate(torch.from_numpy(p[None]), max_new_tokens=8)[0]
        assert ref.numpy()[0].tolist() == out
        jref = jm.generate(paddle.to_tensor(p[None]), max_new_tokens=8)[0]
        assert np.asarray(jref._data)[0].tolist() == out


def test_forward_paged_clamps_positions_past_the_table():
    """A window whose positions run past `max_position_embeddings` embeds
    the last row there (the engine's verify and drafts past a row's
    limit): finite logits, equal at those positions to an explicit clamp,
    and no host check."""
    _, tm = gpt_pair()
    eng = ServingEngine(tm, device="cpu", **dict(KW, max_seq_len=64))
    ids = torch.from_numpy(_prompts(7, (4,))[0])[None]
    lens = torch.tensor([62], dtype=torch.int32)
    tables = torch.from_numpy(eng.block_tables[:1].copy())
    with torch.no_grad():
        logits, _ = tm.forward_paged(ids, eng._caches, tables, lens,
                                     scratch_page=eng._scratch,
                                     limit_lens=lens + 2)
        h = tm.gpt.embed_tokens(ids) + tm.gpt.embed_positions(
            torch.tensor([[62, 63, 63, 63]]))
    assert torch.isfinite(logits).all()
    got = tm.gpt.embed_tokens(ids) + tm.gpt.embed_positions(
        tm.gpt._positions(lens.long()[:, None] + torch.arange(4)))
    assert torch.equal(got, h)
