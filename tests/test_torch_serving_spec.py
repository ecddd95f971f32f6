"""The port's speculative decoding against the JAX package's, on the CPU in
f32.

The cases of the reference's `tests/test_serving_spec.py` (its tiny LLaMA:
vocab 97, hidden 32, 4 layers, 4 heads, page 8), each run through three
engines on the same weights (carried across by `weights.py`): the JAX
single-step engine, the live JAX spec engine and the port's spec engine.
Both spec streams must equal the single-step streams, and the port's
proposed / accepted totals the JAX spec engine's. The target as its own
draft model accepts every draft, so planted faults in the draft model's
pools show in its acceptance. Below the engine:
`forward_paged(max_layers=N)` against the reference's at every depth, the
verify's window step (`window_rows`) against the reference's window step,
and `paged_attention_window_rows` (the window as decode rows, each clamped
to its limit) against `paged_attention_window` and the reference's
`paged_attention_window_xla`, float and int8 pages, MHA and GQA.

Left out with the features they need: `test_gpt_model_window_path` (GPT is
not ported), the spec counters of the metrics registry and `/statusz`'s
spec section (telemetry is not ported).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.tensor import Tensor, as_array
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_llama_state
from torch_parity import jax_state, serve, serving_pair

VOCAB = 97
KW = dict(max_batch=2, max_seq_len=32, page_size=8,
          decode_strategy="greedy_search")
_PAIRS = {}


def pair(seed=0):
    """The reference's 4-layer `_tiny_model(seed=seed)` in both packages."""
    if seed not in _PAIRS:
        _PAIRS[seed] = serving_pair(seed, layers=4)
    return _PAIRS[seed]


def draft_pair():
    """The reference's 2-layer draft model (seed 4) in both packages."""
    if "draft" not in _PAIRS:
        paddle.seed(4)
        jd = JaxLlama(JaxLlamaConfig.tiny(vocab=VOCAB, hidden=32, layers=2,
                                          heads=4, seq=64))
        jd.eval()
        td = LlamaForCausalLM(LlamaConfig.tiny(vocab=VOCAB, hidden=32,
                                               layers=2, heads=4, seq=64),
                              device="cpu")
        load_llama_state(td, jax_state(jd))
        _PAIRS["draft"] = jd, td
    return _PAIRS["draft"]


def three_way(seed, prompts, budgets, kw, spec, draft=None, run=serve,
              prepare=lambda eng: None, **req):
    """The JAX single-step engine, the JAX spec engine and the port's spec
    engine (with `draft`, a (JAX, port) pair of draft models) over the
    same requests (each engine through `prepare` first):
    both spec streams equal the single-step ones, and the port's proposed
    / accepted totals the JAX engine's. Returns (the port's engine, the
    JAX spec engine)."""
    jm, tm = pair(seed)
    jkw, tkw = dict(kw, **spec), dict(kw, **spec)
    if draft is not None:
        jkw["draft_model"], tkw["draft_model"] = draft
    engines = (JaxEngine(jm, **kw), JaxEngine(jm, **jkw),
               ServingEngine(tm, device="cpu", **tkw))
    for eng in engines:
        prepare(eng)
    want = run(engines[0], prompts, budgets, **req)
    _, jeng, teng = engines
    assert run(jeng, prompts, budgets, **req) == want
    assert run(teng, prompts, budgets, **req) == want
    assert (teng._spec_proposed_total, teng._spec_accepted_total) == \
        (jeng._spec_proposed_total, jeng._spec_accepted_total)
    assert teng._spec_proposed_total > 0 and teng.spec_rounds > 0
    return teng, jeng


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)) for n in lens]


# ---------------------------------------------------------------------------
# the engine against the live JAX engines
# ---------------------------------------------------------------------------


def test_mixed_budgets_equal_the_jax_engines():
    """Budgets straddle the window: 1 (done at the prefill sample), 3
    (mid-window), 4 (one window), 9 (a window's tail)."""
    three_way(0, _prompts(11, (4, 6, 5, 7)), [1, 3, 4, 9],
              dict(KW, max_batch=4), dict(spec_decode=4))


@pytest.mark.parametrize("window", [2, 3, 5])
def test_window_sizes_equal_the_jax_engines(window):
    teng, _ = three_way(1, _prompts(3, (5,)), [9], KW,
                        dict(spec_decode=window))
    assert teng.spec_decode == window


def test_eos_mid_window_truncates_as_the_jax_engines():
    """An eos whose first occurrence is past the prefill sample stops the
    stream there, mid-window, on every engine."""
    jm, _ = pair(0)
    for seed in range(5, 30):
        p = _prompts(seed, (4,))
        probe, = serve(JaxEngine(jm, **KW), p, [8])
        fresh = [i for i in range(1, len(probe)) if probe[i] not in probe[:i]]
        if fresh:
            break
    stop = fresh[0]
    teng, _ = three_way(0, p, [8], KW, dict(spec_decode=4),
                        eos_token_id=probe[stop])
    assert teng.slots[0].tokens[-1] == probe[stop]
    assert len(teng.slots[0].tokens) == stop + 1


def _withhold(eng, n=2):
    """Take n pages out of the pool for good (a holder outside the
    engine), so that concurrent rows exhaust it."""
    for _ in range(n):
        eng._page_refs[eng._free_pages.pop(0)] += 1


def test_preemption_under_spec_equals_the_jax_engines():
    """The reference's case (3 rows of 4 + 10 tokens, 2 pages each) with 2
    of the 6 pages withheld from every engine, so that the pool runs dry
    mid-stream: a round reserves min(window, rem) positions and preempts
    the policy's victim, which re-prefills later."""
    teng, jeng = three_way(0, _prompts(7, (4, 4, 4)), [10, 10, 10],
                           dict(KW, max_batch=3, max_seq_len=16),
                           dict(spec_decode=3), prepare=_withhold)
    assert teng.preemptions > 0


def test_slot_reuse_waves_equal_the_jax_engines():
    """A second wave on slots whose stale tables point at freed pages, one
    row draining to its last token while its neighbour keeps drafting: an
    overhanging draft or verify write must land on the scratch page."""
    jm, tm = pair(0)
    rng = np.random.RandomState(41)
    waves = [([rng.randint(0, VOCAB, (4,)), rng.randint(0, VOCAB, (6,))],
              [10, 10]),
             ([rng.randint(0, VOCAB, (7,)), rng.randint(0, VOCAB, (5,))],
              [2, 12])]
    one = JaxEngine(jm, **KW)
    jeng = JaxEngine(jm, spec_decode=4, **KW)
    teng = ServingEngine(tm, spec_decode=4, device="cpu", **KW)
    for prompts, budgets in waves:
        want = serve(one, prompts, budgets)
        assert serve(jeng, prompts, budgets) == want
        assert serve(teng, prompts, budgets) == want
    assert (teng._spec_proposed_total, teng._spec_accepted_total) == \
        (jeng._spec_proposed_total, jeng._spec_accepted_total)


def test_int8_kv_equals_the_jax_engines():
    three_way(3, _prompts(9, (5,)), [8], dict(KW, kv_cache_quant="int8"),
              dict(spec_decode=3))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_separate_draft_model_equals_the_jax_engines(kv):
    """A 2-layer draft model over pools of its own, prefilled beside the
    target's; the target's verify decides every committed token."""
    teng, jeng = three_way(0, _prompts(13, (5, 3)), [8, 6],
                           dict(KW, kv_cache_quant=kv), dict(spec_decode=3),
                           draft=draft_pair())
    assert teng.spec_draft_layers is None and jeng.spec_draft_layers is None
    pools = teng._draft_caches
    assert len(pools) == 2 and len(pools[0]) == (4 if kv else 2)
    # one page more than the free list hands out: the scratch page
    assert pools[0][0].shape[1] == len(teng._page_refs) + 1
    assert pools[0][0].dtype == (torch.int8 if kv else torch.float32)


SELF_DRAFT = dict(prompts=_prompts(13, (5, 3)), budgets=[12, 10])


@pytest.mark.parametrize("kv", [None, "int8"])
def test_target_as_its_own_draft_model_accepts_every_draft(kv):
    """The target's own weights as a separate draft model: its pools
    hold the prompts (the draft's prefill) and every draft's K/V (the
    extra draft step), so each draft is the target's greedy token and
    every one is accepted, on the JAX engine and the port's alike."""
    jm, tm = pair(0)
    teng, _ = three_way(0, SELF_DRAFT["prompts"], SELF_DRAFT["budgets"],
                        dict(KW, kv_cache_quant=kv), dict(spec_decode=3),
                        draft=(jm, tm))
    assert teng._spec_accepted_total == teng._spec_proposed_total


def _skip_draft_prefill(eng):
    real = eng._write_prompts
    eng._write_prompts = lambda pools, *a: None \
        if pools is eng._draft_caches else real(pools, *a)


def _no_extra_draft_step(eng):
    real = eng._get_spec_draft_fn
    eng._get_spec_draft_fn = lambda n: real(n - 1)


@pytest.mark.parametrize("plant", [_skip_draft_prefill,
                                   _no_extra_draft_step],
                         ids=["no_draft_prefill", "no_extra_step"])
def test_target_as_draft_acceptance_catches_a_broken_draft_cache(plant):
    """Each planted fault leaves K/V out of the draft model's pools (the
    prompts, or the last draft of a round): the verify still decides every
    token, so the streams stay greedy's, and only the acceptance of the
    target as its own draft shows the fault."""
    jm, tm = pair(0)
    eng = ServingEngine(tm, draft_model=tm, spec_decode=3, device="cpu",
                        **KW)
    plant(eng)
    want = serve(JaxEngine(jm, **KW), SELF_DRAFT["prompts"],
                 SELF_DRAFT["budgets"])
    assert serve(eng, SELF_DRAFT["prompts"], SELF_DRAFT["budgets"]) == want
    assert eng._spec_accepted_total < eng._spec_proposed_total


def _one_at_a_time(eng, prompts, budgets):
    """One request after the other, so that later admissions hit the
    trie."""
    out = []
    for p, b in zip(prompts, budgets):
        out += serve(eng, [p], [b])
    return out


@pytest.mark.parametrize("chunk", [0, 8])
def test_shallow_spec_with_the_prefix_cache_equals_the_jax_engines(chunk):
    """Shallow spec over shared pages (the reference's
    `test_spec_decode_parity`) and, with chunked prefill, rows that stay
    inactive in the spec programs until their suffix is cached."""
    rng = np.random.RandomState(5)
    shared = rng.randint(0, VOCAB, (24,))
    prompts = [np.concatenate([shared, rng.randint(0, VOCAB, (t,))])
               for t in (3, 7, 5)]
    teng, _ = three_way(0, prompts, [8, 6, 7], dict(KW, max_seq_len=64),
                        dict(spec_decode=3, prefix_cache=1,
                             prefill_chunk=chunk),
                        run=_one_at_a_time)
    assert teng._prefix_hits_total == 48
    assert teng.chunk_rounds > 0


def test_sampling_row_falls_back_to_the_classic_path():
    """Acceptance is greedy-exact prefix matching: a batch with a sampling
    row takes the classic dispatch (nothing drafted), and the greedy row's
    stream equals the single-step one."""
    jm, tm = pair(0)
    pg, ps = _prompts(19, (5, 5))
    ref, = serve(JaxEngine(jm, **KW), [pg], [6])
    for eng in (JaxEngine(jm, spec_decode=4, **KW),
                ServingEngine(tm, spec_decode=4, device="cpu", **KW)):
        rid_g = eng.add_request(pg, max_new_tokens=6)
        rid_s = eng.add_request(ps, max_new_tokens=6,
                                decode_strategy="sampling", temperature=0.9)
        fin = {f.request_id: f.output_ids.tolist() for f in eng.run()}
        assert fin[rid_g] == ref
        assert len(fin[rid_s]) == 6
        assert eng._spec_proposed_total == 0


# ---------------------------------------------------------------------------
# the constructor, flags and warmup
# ---------------------------------------------------------------------------


def test_spec_with_async_depth_raises_as_the_reference():
    jm, tm = pair(0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        JaxEngine(jm, spec_decode=4, async_depth=2, **KW)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServingEngine(tm, spec_decode=4, async_depth=2, decode_burst=4,
                      device="cpu", **KW)


@pytest.mark.parametrize("window", [None, 0, 1])
def test_window_below_two_is_off(window):
    jm, tm = pair(0)
    j = JaxEngine(jm, spec_decode=window, **KW)
    t = ServingEngine(tm, spec_decode=window, device="cpu", **KW)
    assert t.spec_decode == j.spec_decode == 0
    serve(t, _prompts(2, (5,)), [6])
    assert t.spec_rounds == 0 and not t._spec_draft_fns


def test_flag_default_and_keyword_override():
    jm, tm = pair(0)
    names = ["FLAGS_spec_decode", "FLAGS_spec_draft_layers"]
    old = get_flags(names)
    new = {"FLAGS_spec_decode": 3, "FLAGS_spec_draft_layers": 1}
    set_flags(new)
    paddle.set_flags(new)
    try:
        for make in (lambda **k: JaxEngine(jm, **KW, **k),
                     lambda **k: ServingEngine(tm, device="cpu", **KW, **k)):
            e = make()
            assert (e.spec_decode, e.spec_draft_layers) == (3, 1)
            e2 = make(spec_decode=2, spec_draft_layers=2)
            assert (e2.spec_decode, e2.spec_draft_layers) == (2, 2)
    finally:
        set_flags(old)
        paddle.set_flags({n: 0 for n in names})


@pytest.mark.parametrize("layers,want", [(None, 2), (0, 2), (1, 1), (3, 3),
                                         (9, 4)])
def test_draft_layers_default_to_half_the_depth(layers, want):
    jm, tm = pair(0)
    j = JaxEngine(jm, spec_decode=4, spec_draft_layers=layers, **KW)
    t = ServingEngine(tm, spec_decode=4, spec_draft_layers=layers,
                      device="cpu", **KW)
    assert t.spec_draft_layers == j.spec_draft_layers == want


@pytest.mark.parametrize("draft", [False, True])
def test_warmup_builds_both_spec_programs(draft):
    """warmup's greedy request asks for window + 1 tokens, so one whole
    round runs: the draft program (window - 1 steps; a draft model's one
    more) and the verify program are built before traffic, and traffic
    builds nothing new."""
    jm, tm = pair(0)
    kw = dict(spec_decode=3)
    if draft:
        kw["draft_model"] = draft_pair()[1]
    eng = ServingEngine(tm, device="cpu", **KW, **kw)
    eng.warmup()
    assert set(eng._spec_draft_fns) == {3 if draft else 2}
    assert set(eng._spec_verify_fns) == {3}
    built = (dict(eng._spec_draft_fns), dict(eng._spec_verify_fns))
    p = _prompts(23, (4,))
    want = serve(JaxEngine(jm, **KW), p, [6])
    assert serve(eng, p, [6]) == want
    assert (eng._spec_draft_fns, eng._spec_verify_fns) == built
    with pytest.raises(ValueError, match="no room"):
        eng.warmup(prompt_len=30)


# ---------------------------------------------------------------------------
# the model: max_layers and the verify's window step
# ---------------------------------------------------------------------------

TABLES = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]], np.int32)
N_PAGES = 12


def _pools(seed, layers, quant, kvh=4, d=8):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(layers):
        shape = (kvh, N_PAGES, 8, d)
        if quant:
            out.append((rng.randint(-127, 128, shape).astype(np.int8),
                        rng.randint(-127, 128, shape).astype(np.int8),
                        rng.uniform(0.01, 0.2, shape[:3]).astype(np.float32),
                        rng.uniform(0.01, 0.2, shape[:3]).astype(np.float32)))
        else:
            out.append((rng.randn(*shape).astype(np.float32),
                        rng.randn(*shape).astype(np.float32), None, None))
    return out


def _lane_pad(scales):
    """The reference's [kvh, n_pages, 128] scale pool around the port's."""
    out = np.zeros(scales.shape[:2] + (128,), np.float32)
    out[..., :scales.shape[2]] = scales
    return out


def _both_caches(pools):
    jc, tc = [], []
    for kp, vp, ks, vs in pools:
        if ks is None:
            jc.append((jnp.asarray(kp), jnp.asarray(vp)))
            tc.append((torch.from_numpy(kp.copy()),
                       torch.from_numpy(vp.copy())))
        else:
            jc.append(tuple(jnp.asarray(a) for a in
                            (kp, vp, _lane_pad(ks), _lane_pad(vs))))
            tc.append(tuple(torch.from_numpy(a.copy())
                            for a in (kp, vp, ks, vs)))
    return jc, tc


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, None])
def test_max_layers_logits_equal_the_reference(depth, quant):
    """A shallow-exit decode step (the first `depth` layers over as many
    caches, then the final norm and the head) against the JAX model's,
    logits within 1e-4; the layers past `depth` are not touched."""
    jm, tm = pair(0)
    n = depth or 4
    pools = _pools(20 + n, 4, quant)
    jc, tc = _both_caches(pools)
    ids = np.array([[5], [17], [90], [3]], np.int64)
    lens = np.array([5, 0, 16, 23], np.int32)
    active = np.array([True, True, False, True])
    jl, _ = jm.forward_paged(Tensor(jnp.asarray(ids)), jc[:n],
                             jnp.asarray(TABLES), jnp.asarray(lens),
                             active=jnp.asarray(active), max_layers=depth)
    before = [t.clone() for t in tc[-1]]
    with torch.no_grad():
        tl, tnew = tm.forward_paged(
            torch.from_numpy(ids), tc[:n], torch.from_numpy(TABLES),
            torch.from_numpy(lens), active=torch.from_numpy(active),
            max_layers=depth)
    assert len(tnew) == n
    np.testing.assert_allclose(tl.numpy()[active],
                               np.asarray(as_array(jl))[active], rtol=0,
                               atol=1e-4)
    if n < 4:
        assert all(torch.equal(a, b) for a, b in zip(before, tc[-1]))


@pytest.mark.parametrize("quant", [False, True])
def test_verify_window_step_equals_the_reference(quant):
    """The verify's forward: a window of 4 at ragged starts (0, 15, 16,
    17), one row overhanging its limit, one inactive, attention as decode
    rows (`window_rows`) against the reference's window step: logits
    within 1e-4 at every position below its row's limit, the pools within
    1e-5 (int8: within one step)."""
    jm, tm = pair(0)
    pools = _pools(31, 4, quant)
    jc, tc = _both_caches(pools)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, VOCAB, (4, 4)).astype(np.int64)
    lens = np.array([0, 15, 16, 17], np.int32)
    limit = np.array([4, 17, 20, 21], np.int32)  # row 1 overhangs by 2
    active = np.array([True, True, False, True])
    jl, jnew = jm.forward_paged(
        Tensor(jnp.asarray(ids)), jc, jnp.asarray(TABLES), jnp.asarray(lens),
        active=jnp.asarray(active), limit_lens=jnp.asarray(limit))
    with torch.no_grad():
        tl, tnew = tm.forward_paged(
            torch.from_numpy(ids), tc, torch.from_numpy(TABLES),
            torch.from_numpy(lens), active=torch.from_numpy(active),
            scratch_page=None, limit_lens=torch.from_numpy(limit),
            window_rows=True)
    below = (lens[:, None] + np.arange(4)) < limit[:, None]
    keep = below & active[:, None]
    np.testing.assert_allclose(tl.numpy()[keep],
                               np.asarray(as_array(jl))[keep], rtol=0,
                               atol=1e-4)
    for jcache, tcache in zip(jnew, tnew):
        for j, t in zip(jcache, tcache):
            w = np.asarray(as_array(j))
            if w.shape != tuple(t.shape):  # the reference's lane pad
                w = w[..., :8]
            np.testing.assert_allclose(
                t.numpy().astype(np.float32), w.astype(np.float32), rtol=0,
                atol=1 if t.dtype == torch.int8 else 1e-5)


# ---------------------------------------------------------------------------
# the window as decode rows
# ---------------------------------------------------------------------------


def _rows_inputs(seed, quant, q_heads, kvh, s=5, d=8):
    rng = np.random.RandomState(seed)
    shape = (kvh, N_PAGES, 8, d)
    if quant:
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)
    else:
        kp = rng.randn(*shape).astype(np.float32)
        vp = rng.randn(*shape).astype(np.float32)
        ks = vs = None
    q = rng.randn(4, s, q_heads, d).astype(np.float32)
    return q, kp, vp, ks, vs


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("lens", [(0, 15, 16, 17), (16, 0, 17, 15)])
def test_window_rows_equal_the_window_attention(lens, quant, heads):
    """Every position below its row's limit within 1e-5 of
    `paged_attention_window` and of the reference's
    `paged_attention_window_xla`; a position at or past the limit attends
    the limit's context (the decode reference at that length); an
    inactive row is 0."""
    q, kp, vp, ks, vs = _rows_inputs(7, quant, *heads)
    s = q.shape[1]
    lens = np.asarray(lens, np.int32)
    limit = lens + np.array([5, 2, 5, 3], np.int32)  # rows 1, 3 overhang
    active = np.array([True, True, True, False])
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs).items()}
    tables = torch.from_numpy(TABLES)
    rows = tpa.window_rows(tables, torch.from_numpy(lens), s,
                           limit_lens=torch.from_numpy(limit),
                           active=torch.from_numpy(active))
    got = tpa.paged_attention_window_rows(
        t["q"], t["kp"], t["vp"], rows, k_scales=t["ks"],
        v_scales=t["vs"]).numpy()
    gathered = tpa.paged_attention_window(
        t["q"], t["kp"], t["vp"], tables, torch.from_numpy(lens),
        k_scales=t["ks"], v_scales=t["vs"]).numpy()
    jkw = {} if not quant else dict(k_scales=jnp.asarray(_lane_pad(ks)),
                                    v_scales=jnp.asarray(_lane_pad(vs)))
    ref = np.asarray(jpa.paged_attention_window_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(TABLES), jnp.asarray(lens), **jkw))
    pos = lens[:, None] + np.arange(s)
    below = (pos < limit[:, None]) & active[:, None]
    np.testing.assert_allclose(got[below], gathered[below], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[below], ref[below], rtol=0, atol=1e-5)
    assert not got[~active].any()
    for b, w in zip(*np.nonzero(~below & active[:, None])):
        want = tpa.paged_attention_ref(
            t["q"][b:b + 1, w], t["kp"], t["vp"], tables[b:b + 1],
            torch.tensor([limit[b]], dtype=torch.int32), k_scales=t["ks"],
            v_scales=t["vs"]).numpy()
        np.testing.assert_allclose(got[b, w], want[0], rtol=0, atol=1e-5)
