"""The port's ServingEngine, scheduler and samplers against the JAX package,
on the CPU in f32.

Greedy token streams must be identical to `paddle_tpu.inference`'s engine
on the same weights: mixed prompt lengths, eos, on-demand page growth and
recompute preemption. Sampled streams come from a torch.Generator, so they
are checked for seeded determinism, the vocabulary and the top-k / top-p
masks, not token for token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models import generation as jgen
from paddle_tpu_torch.inference import FifoSchedulerPolicy, ServingEngine
from paddle_tpu_torch.models import generation as tgen
from torch_parity import PAGE, tiny_pair

_PROMPT_LENS = (5, 9, 17, 3, 12, 1)
_NEW = (10, 20, 6, 25, 12, 4)


def _serve(engine_cls, model, withhold=0, eos=None, **kw):
    eng = engine_cls(model, max_batch=3, max_seq_len=48, page_size=PAGE,
                     decode_strategy="greedy_search", eos_token_id=eos,
                     **kw)
    if withhold:
        eng._free_pages = eng._free_pages[:-withhold]
    rng = np.random.RandomState(5)
    rids = [eng.add_request(rng.randint(0, 256, (n,)), max_new_tokens=m)
            for n, m in zip(_PROMPT_LENS, _NEW)]
    done = {f.request_id: f.output_ids.tolist() for f in eng.run()}
    assert sorted(done) == rids
    return done, eng


@pytest.mark.parametrize("scenario", ["mixed", "eos", "preempt"])
def test_greedy_streams_match_jax_engine(scenario):
    jm, tm, _ = tiny_pair(seed=3)
    kw = {}
    if scenario == "preempt":
        kw["withhold"] = 10  # an 8-page pool: growth must preempt
    if scenario == "eos":
        ref, _ = _serve(JaxEngine, jm)
        kw["eos"] = ref[3][4]  # a token request 3 emits mid-stream
    want, _ = _serve(JaxEngine, jm, **kw)
    got, eng = _serve(ServingEngine, tm, device="cpu", **kw)
    assert got == want
    if scenario == "preempt":
        assert eng.preemptions > 0
    if scenario == "eos":
        assert any(len(v) < m for v, m in zip(
            (got[r] for r in sorted(got)), _NEW))
    # every page is back in the pool
    assert len(eng._free_pages) == eng.max_batch * eng.pages_per_seq \
        - kw.get("withhold", 0)
    assert not eng.has_work()


def test_token_budget_and_counters():
    _, tm, _ = tiny_pair()
    eng = ServingEngine(tm, max_batch=2, max_seq_len=32, page_size=PAGE,
                        device="cpu")
    streamed = []
    rid = eng.add_request(np.arange(7), max_new_tokens=12,
                          on_token=lambda r, t: streamed.append((r, t)))
    eng._admit()
    assert eng.slots[0].n_pages == 1  # the prompt's pages only
    (out,) = eng.run()
    assert out.request_id == rid and len(out.output_ids) == 12
    assert [t for _, t in streamed] == out.output_ids.tolist()
    # one prefill; the first token comes from it, 11 decode steps follow
    assert (eng.prefills, eng.decode_steps) == (1, 11)


def test_prompt_overflow_rejected():
    _, tm, _ = tiny_pair()
    eng = ServingEngine(tm, max_batch=1, max_seq_len=16, page_size=PAGE,
                        device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.add_request(np.arange(12), max_new_tokens=8)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.add_request(np.arange(2), max_new_tokens=0)


def test_engine_rejects_model_on_another_device():
    _, tm, _ = tiny_pair()
    with pytest.raises(ValueError, match="multiple of page_size"):
        ServingEngine(tm, max_seq_len=20, page_size=8, device="cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        ServingEngine(tm, max_seq_len=128, page_size=8, device="cpu")


def _sampling_engine(tm, seed):
    eng = ServingEngine(tm, max_batch=3, max_seq_len=48, page_size=PAGE,
                        decode_strategy="sampling", temperature=0.8,
                        top_k=20, top_p=0.9, seed=seed, device="cpu")
    rng = np.random.RandomState(0)
    for i, n in enumerate((4, 7, 10, 3)):
        eng.add_request(rng.randint(0, 256, (n,)), max_new_tokens=8,
                        decode_strategy="greedy_search" if i == 1 else None)
    return {f.request_id: f.output_ids.tolist() for f in eng.run()}


def test_sampling_is_seeded_and_in_vocab():
    _, tm, cfg = tiny_pair()
    a, b, c = (_sampling_engine(tm, s) for s in (7, 7, 8))
    assert a == b
    assert a != c
    assert a[1] == c[1]  # the greedy request ignores the seed
    assert all(0 <= t < cfg.vocab_size for v in a.values() for t in v)


def _jax_filtered(logits, temp, tk, tp):
    """The JAX per-row filters, read off `sample_logits_per_row`: a token
    is kept iff its logprob under the filtered distribution is finite
    enough to be drawn (masked entries sit at -1e30)."""
    keep = np.zeros(logits.shape, bool)
    for key in range(200):
        tok, _ = jgen.sample_logits_per_row(
            jnp.asarray(logits), jax.random.PRNGKey(key),
            jnp.zeros(logits.shape[0], bool), jnp.asarray(temp),
            jnp.asarray(tk), jnp.asarray(tp))
        keep[np.arange(logits.shape[0]), np.asarray(tok)] = True
    return keep


def test_per_row_filters_match_jax_and_numpy():
    rng = np.random.RandomState(3)
    logits = (rng.randn(4, 40) * 3).astype(np.float32)
    temp = np.array([1.0, 0.5, 2.0, 1.0], np.float32)
    tk = np.array([0, 5, 3, 0], np.int64)
    tp = np.array([1.0, 1.0, 0.6, 0.3], np.float32)
    f = tgen.filter_logits_per_row(*map(torch.from_numpy,
                                        (logits, temp, tk, tp))).numpy()
    kept = f > -1e29
    # numpy statement of the same filters
    want = np.ones_like(kept)
    for r in range(4):
        z = logits[r] / temp[r]
        if tk[r]:
            want[r] &= z >= np.sort(z)[::-1][tk[r] - 1]
        if tp[r] < 1.0:
            zz = np.where(want[r], z, -1e30)
            order = np.argsort(-zz, kind="stable")
            p = np.exp(zz[order] - zz[order].max())
            p /= p.sum()
            before = np.cumsum(p) - p
            k = order[(before < tp[r]) | (np.arange(40) == 0)]
            want[r] &= np.isin(np.arange(40), k)
    np.testing.assert_array_equal(kept, want)
    # every token JAX draws in 200 tries lies inside the port's filter
    assert not (_jax_filtered(logits, temp, tk, tp) & ~kept).any()


def test_per_row_sampler_greedy_rows_and_logprobs_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 50).astype(np.float32)
    greedy = np.array([True, False, True])
    temp = np.ones(3, np.float32)
    tk = np.array([0, 1, 0], np.int64)  # top-1: a deterministic draw
    tp = np.ones(3, np.float32)
    jt, jl = jgen.sample_logits_per_row(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(greedy),
        jnp.asarray(temp), jnp.asarray(tk), jnp.asarray(tp))
    g = torch.Generator().manual_seed(0)
    tt, tl = tgen.sample_logits_per_row(
        *map(torch.from_numpy, (logits,)), g, torch.from_numpy(greedy),
        *map(torch.from_numpy, (temp, tk, tp)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(top_k=3), dict(top_p=0.5),
                                dict(temperature=0.5, top_k=2, top_p=0.9)])
def test_scalar_sampler_stays_inside_its_mask(kw):
    rng = np.random.RandomState(6)
    logits = torch.from_numpy((rng.randn(2, 30) * 2).astype(np.float32))
    g = torch.Generator().manual_seed(1)
    b = logits.shape[0]
    allowed = tgen.filter_logits_per_row(
        logits, torch.full((b,), kw.get("temperature", 1.0)),
        torch.full((b,), kw.get("top_k", 0)),
        torch.full((b,), kw.get("top_p", 1.0))) > -1e29
    for _ in range(50):
        tok, lp = tgen.sample_logits(logits, g, "sampling", **kw)
        assert allowed[torch.arange(b), tok].all()
        assert (lp <= 0).all()
    tok, _ = tgen.sample_logits(logits, g, "greedy_search")
    torch.testing.assert_close(tok, logits.argmax(-1))


class _Eng:
    def __init__(self, free, pending, admit_seqs, page_size=8, max_batch=8):
        self._free_pages = list(range(free))
        self._pending = pending
        self.page_size = page_size
        self.max_batch = max_batch

        class S:
            def __init__(self, a):
                self.admit_seq = a

        self.slots = [S(a) for a in admit_seqs]


def test_fifo_policy_decisions():
    pol = FifoSchedulerPolicy()
    # the head needs 3 pages (17 tokens + 3 prior at page 8)
    head = (0, np.arange(17), 4, [1, 2, 3])
    assert pol.select_admission(_Eng(3, [head], [])) == 0
    assert pol.select_admission(_Eng(2, [head, (1, np.arange(1), 1, [])],
                                     [])) is None  # head-of-line blocking
    assert pol.select_victim(_Eng(0, [], [4, 9, 2]), [0, 2]) == 0
    new = [(0, np.arange(5)), (1, np.arange(20)), (2, np.arange(3))]
    assert pol.prefill_bucket(_Eng(0, [], [], max_batch=8), new) == (4, 24)
    assert pol.prefill_bucket(_Eng(0, [], [], max_batch=2), new) == (2, 24)
