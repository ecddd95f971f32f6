"""Multi-step (burst) decode of the port's ServingEngine against the JAX
engine, on the CPU in f32, and the scheduler policy surface through both
packages.

The cases mirror the reference's `tests/test_serving_burst.py` (a burst
engine is observationally identical to the single-step one for greedy
decoding) on the same tiny LLaMA and weights: greedy streams with
`decode_burst=4` must EQUAL both the JAX engine's (burst 4) and the port's
`decode_burst=1`. Each JAX engine runs once, in a module-scoped fixture.
Sampled streams come from a torch.Generator: checked for seeded determinism
and the vocabulary, not token for token. The graph-safe cache writers are
held against the JAX writers on every page a live row owns.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework import config as jcfg
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.kernels import paged_attention as tpa
from torch_parity import serve, serving_pair

VOCAB = 97
KW = dict(page_size=8, decode_strategy="greedy_search")


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)) for n in lens]


# (engine kwargs, prompt seed, prompt lengths, budgets, pages withheld
# from the pool)
CASES = {
    # budgets straddle the burst: 1 (done at the prefill sample), 3
    # (mid-burst), 4 (one burst), 9 (a burst tail)
    "mixed": (dict(max_batch=4, max_seq_len=32), 11, (4, 6, 5, 7),
              (1, 3, 4, 9), 0),
    # 4 pages for 3 rows of 14 tokens (2 pages each): growth must preempt
    "preempt": (dict(max_batch=3, max_seq_len=16), 7, (4, 4, 4),
                (10, 10, 10), 2),
    "int8_kv": (dict(max_batch=3, max_seq_len=40, kv_cache_quant="int8"),
                9, (6, 6, 6), (10, 7, 10), 0),
}


def _run_case(engine_cls, model, case, burst, **extra):
    ekw, seed, lens, news, withhold = CASES[case]
    eng = engine_cls(model, decode_burst=burst, **KW, **ekw, **extra)
    if withhold:
        eng._free_pages = eng._free_pages[:-withhold]
    return serve(eng, _prompts(seed, lens), news), eng


def _port(tm, case, burst):
    return _run_case(ServingEngine, tm, case, burst, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return serving_pair()


@pytest.fixture(scope="module")
def jax_streams(pair):
    """Each case's JAX streams at decode_burst=4 (one engine run each)."""
    return {case: _run_case(JaxEngine, pair[0], case, 4)[0]
            for case in CASES}


@pytest.mark.parametrize("burst", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_burst_greedy_streams_equal_the_jax_engine(pair, jax_streams, case,
                                                   burst):
    got, eng = _port(pair[1], case, burst)
    assert got == jax_streams[case]
    assert [len(s) for s in got] == list(CASES[case][3])
    if case == "preempt":
        assert eng.preemptions > 0
    assert not eng.has_work() and eng.discarded_tokens == 0
    assert len(eng._free_pages) == eng.max_batch * eng.pages_per_seq \
        - CASES[case][4]
    # decode_steps counts token steps: a burst of 4 counts 4
    assert eng.decode_steps >= max(CASES[case][3]) - 1


def _eos_probe(tm):
    """A prompt and the position of a token whose first occurrence in its
    greedy stream is past 0 and not the last of its burst of 4 (so an eos
    on it stops mid-burst): (prompt, stop_at, eos)."""
    for seed in range(5, 60):
        p = np.random.RandomState(seed).randint(0, VOCAB, (4,))
        eng = ServingEngine(tm, max_batch=2, max_seq_len=32, device="cpu",
                            **KW)
        probe, = serve(eng, [p], [8])
        for i in range(1, len(probe)):
            if probe[i] not in probe[:i] and (i - 1) % 4 != 3:
                return p, i, probe[i]
    raise AssertionError("no prompt gave a fresh mid-burst token")


def test_eos_mid_burst_truncates_as_the_jax_engine(pair):
    jm, tm = pair
    p, stop_at, eos = _eos_probe(tm)
    kw = dict(max_batch=2, max_seq_len=32, **KW)
    want, = serve(JaxEngine(jm, decode_burst=4, **kw), [p], [8],
                  eos_token_id=eos)
    assert want[-1] == eos and len(want) == stop_at + 1
    for burst in (1, 4):
        eng = ServingEngine(tm, decode_burst=burst, device="cpu", **kw)
        got, = serve(eng, [p], [8], eos_token_id=eos)
        assert got == want
        assert eng.discarded_tokens == 0  # the program stopped the row


def test_a_burst_body_that_ignores_eos_is_seen(pair, monkeypatch):
    """The planted fault of chip_smoke's phase 11, on the CPU: a body that
    keeps a row active past its eos emits tokens the host has to drop
    (the host's own finish rule keeps the stream right)."""
    _, tm = pair
    p, stop_at, eos = _eos_probe(tm)

    rules = tserving.burst_rules

    def no_eos(tok, lens, act, rem, nxt, eos):
        return rules(tok, lens, act, rem, nxt, torch.full_like(eos, -1))

    monkeypatch.setattr(tserving, "burst_rules", no_eos)
    eng = ServingEngine(tm, decode_burst=4, max_batch=2, max_seq_len=32,
                        device="cpu", **KW)
    got, = serve(eng, [p], [8], eos_token_id=eos)
    assert len(got) == stop_at + 1 and eng.discarded_tokens > 0


def test_mixed_greedy_and_sampled_rows(pair):
    """A greedy row is unaffected by a sampled row in its bursts; the
    sampled row is seeded and in the vocabulary."""
    jm, tm = pair
    pg, ps = _prompts(19, (5, 5))
    kw = dict(max_batch=2, max_seq_len=32, **KW)
    ref, = serve(JaxEngine(jm, **kw), [pg], [6])

    def mixed():
        e = ServingEngine(tm, decode_burst=3, seed=4, device="cpu", **kw)
        rg = e.add_request(pg, max_new_tokens=6)
        rs = e.add_request(ps, max_new_tokens=6, decode_strategy="sampling",
                           temperature=0.9)
        fin = {f.request_id: f.output_ids.tolist() for f in e.run()}
        return fin[rg], fin[rs]

    (g1, s1), (g2, s2) = mixed(), mixed()
    assert g1 == ref and g2 == ref
    assert s1 == s2 and len(s1) == 6
    assert all(0 <= t < VOCAB for t in s1)


def test_seeded_burst_sampling_deterministic_and_in_vocab(pair):
    _, tm = pair
    prompts = _prompts(17, (4, 4))

    def run_once(seed):
        e = ServingEngine(tm, max_batch=2, max_seq_len=32, page_size=8,
                          decode_strategy="sampling", temperature=0.8,
                          top_k=20, seed=seed, decode_burst=4, device="cpu")
        return serve(e, prompts, [6, 6])

    a, b = run_once(42), run_once(42)
    assert a == b
    assert all(len(s) == 6 and all(0 <= t < VOCAB for t in s) for s in a)


def test_callback_order_matches_single_step(pair):
    _, tm = pair
    prompts = _prompts(9, (4, 4))

    def collect(burst):
        seen = []
        eng = ServingEngine(tm, max_batch=2, max_seq_len=32,
                            decode_burst=burst, device="cpu", **KW)
        rids = [eng.add_request(p, max_new_tokens=6,
                                on_token=lambda r, t: seen.append((r, t)))
                for p in prompts]
        out = {f.request_id: f.output_ids.tolist() for f in eng.run()}
        return seen, rids, out

    s1, r1, o1 = collect(1)
    s3, r3, o3 = collect(3)
    for a, b in zip(r1, r3):
        # per request: the same tokens in the same order, equal to the
        # finished stream (bursts interleave requests differently)
        assert [t for r, t in s1 if r == a] == [t for r, t in s3 if r == b] \
            == o3[b] == o1[a]


def test_abort_from_callback_mid_burst(pair):
    _, tm = pair
    (p,) = _prompts(13, (4,))
    eng = ServingEngine(tm, max_batch=2, max_seq_len=32, decode_burst=4,
                        device="cpu", **KW)
    got = []

    def cb(rid, t):
        got.append(t)
        if len(got) == 2:
            assert eng.abort(rid)

    eng.add_request(p, max_new_tokens=8, on_token=cb)
    assert eng.run() == [] and len(got) == 2
    assert not eng.has_work()
    assert len(eng._free_pages) == eng.max_batch * eng.pages_per_seq
    # token 1 is the prefill's, token 2 the first of a burst of 4: the
    # burst's other 3 were dropped on the host
    assert eng.discarded_tokens == 3


def test_abort_pending_and_unknown(pair):
    _, tm = pair
    eng = ServingEngine(tm, max_batch=1, max_seq_len=32, decode_burst=4,
                        device="cpu", **KW)
    a, b = (eng.add_request(p, max_new_tokens=5)
            for p in _prompts(3, (4, 4)))
    assert eng.abort(b)            # still queued
    assert not eng.abort(b)        # already gone
    assert not eng.abort(12345)    # never seen
    out = eng.run()
    assert [f.request_id for f in out] == [a]


def test_warmup_idle_busy_and_burst_engines(pair):
    jm, tm = pair
    eng = ServingEngine(tm, max_batch=2, max_seq_len=32, decode_burst=4,
                        device="cpu", **KW)
    assert eng.warmup(sampling=True) > 0
    assert set(eng._burst_fns) == {(True, 4), (True, 1), (False, 4),
                                   (False, 1)}
    assert not eng.has_work()
    (p,) = _prompts(23, (4,))
    out, = serve(eng, [p], [6])
    ref, = serve(ServingEngine(tm, max_batch=2, max_seq_len=32,
                               device="cpu", **KW), [p], [6])
    assert out == ref
    one = ServingEngine(tm, max_batch=2, max_seq_len=32, device="cpu", **KW)
    one.warmup()
    assert set(one._burst_fns) == {(True, 1)}
    one.add_request(p, max_new_tokens=3)
    with pytest.raises(RuntimeError, match="idle"):
        one.warmup()
    # a prompt_len that leaves no room for the burst: both packages refuse
    with pytest.raises(ValueError, match="no room"):
        JaxEngine(jm, max_batch=2, max_seq_len=32, decode_burst=4,
                  **KW).warmup(prompt_len=30)
    with pytest.raises(ValueError, match="no room"):
        eng.warmup(prompt_len=30)


def test_engine_raises_on_unported_arguments(pair):
    _, tm = pair
    kw = dict(max_batch=2, max_seq_len=32, device="cpu", **KW)
    ServingEngine(tm, mesh=None, spec_decode=0, prefix_cache=0,
                  prefill_chunk=0, kv_host_cache_mb=0, kv_disk_cache_dir="",
                  **kw)
    for name, value, item in (("kv_host_cache_mb", 64, "KV tiers"),
                              ("kv_disk_cache_dir", "/x", "KV tiers")):
        with pytest.raises(NotImplementedError, match=item):
            ServingEngine(tm, **{name: value}, **kw)
    # tensor-parallel serving is ported: `mesh` takes a DeviceMesh
    # (tests/test_torch_serving_tp.py), and refuses anything else
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServingEngine(tm, mesh=object(), **kw)


# ---------------------------------------------------------------------------
# graph-safe cache writers
# ---------------------------------------------------------------------------


def _writer_inputs(seed, quant):
    """12 pages of 8 tokens, 4 rows; row 1 is inactive and its stale table
    row points at the pages rows 0 and 2 write now (same positions)."""
    rng = np.random.RandomState(seed)
    tables = np.array([[3, 7], [3, 5], [5, 9], [0, 2]], np.int32)
    lens = np.array([5, 5, 11, 15], np.int32)
    active = np.array([True, False, True, True])
    kn = (rng.randn(4, 2, 16) * 3).astype(np.float32)
    vn = rng.randn(4, 2, 16).astype(np.float32)
    dt = np.int8 if quant else np.float32
    kp = (rng.randn(2, 12, 8, 16) * (40 if quant else 1)).astype(dt)
    vp = (rng.randn(2, 12, 8, 16) * (40 if quant else 1)).astype(dt)
    return kp, vp, kn, vn, tables, lens, active


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_safe_writer_matches_jax(seed):
    kp, vp, kn, vn, tables, lens, active = _writer_inputs(seed, False)
    jk, jv = jpa.update_paged_kv_cache(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(tables), jnp.asarray(lens), active=jnp.asarray(active))
    # the port's pools carry one scratch page past the 12
    tk = torch.from_numpy(np.concatenate([kp, kp[:, :1]], 1))
    tv = torch.from_numpy(np.concatenate([vp, vp[:, :1]], 1))
    tpa.update_paged_kv_cache(tk, tv, torch.from_numpy(kn),
                              torch.from_numpy(vn), torch.from_numpy(tables),
                              torch.from_numpy(lens),
                              active=torch.from_numpy(active),
                              scratch_page=12)
    np.testing.assert_array_equal(tk[:, :12].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv[:, :12].numpy(), np.asarray(jv))
    # the inactive row's write went to the scratch page
    np.testing.assert_array_equal(tk[:, 12, 0].numpy(), kn[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_safe_q8_writer_matches_jax(seed):
    kp, vp, kn, vn, tables, lens, active = _writer_inputs(seed, True)
    rng = np.random.RandomState(seed + 7)
    ks = rng.rand(2, 12, 8).astype(np.float32)
    vs = rng.rand(2, 12, 8).astype(np.float32)
    pad = np.zeros((2, 12, 128 - 8), np.float32)  # the reference's lanes
    jout = jpa.update_paged_kv_cache_q8(
        jnp.asarray(kp), jnp.asarray(np.concatenate([ks, pad], -1)),
        jnp.asarray(vp), jnp.asarray(np.concatenate([vs, pad], -1)),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(tables),
        jnp.asarray(lens), active=jnp.asarray(active))
    port = [torch.from_numpy(np.concatenate([a, a[:, :1]], 1))
            for a in (kp, ks, vp, vs)]
    tpa.update_paged_kv_cache_q8(
        *port, torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(tables), torch.from_numpy(lens),
        active=torch.from_numpy(active), scratch_page=12)
    for got, want in zip(port, jout):
        want = np.asarray(want)
        np.testing.assert_array_equal(got[:, :12].numpy(),
                                      want[..., :8] if want.ndim == 3
                                      else want)


# ---------------------------------------------------------------------------
# the policy surface, through both packages
# ---------------------------------------------------------------------------

PACKAGES = {"jax": jsched, "port": tsched}


class _FakeSlot:
    def __init__(self, admit_seq, tokens=0, max_new=0):
        self.admit_seq = admit_seq
        self.tokens = [0] * tokens
        self.max_new_tokens = max_new


class _FakeEngine:
    def __init__(self, slots=(), pending=(), free_pages=64, page_size=8,
                 decode_burst=4, prefill_chunk=32):
        self.slots = list(slots)
        self._pending = list(pending)
        self._free_pages = list(range(free_pages))
        self.page_size = page_size
        self.decode_burst = decode_burst
        self.prefill_chunk = prefill_chunk
        self.max_batch = 8


def _entry(rid, prompt_len, prior_len=0):
    return (rid, np.zeros((prompt_len,), np.int64), 8, [0] * prior_len)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_policy_registry_and_resolution(pkg):
    m = PACKAGES[pkg]
    assert m.available_policies() == ["fifo", "slo"]
    assert isinstance(m.resolve_policy(), m.FifoSchedulerPolicy)
    inst = m.FifoSchedulerPolicy()
    assert m.resolve_policy(inst) is inst
    with pytest.raises(ValueError, match="unknown scheduler policy"):
        m.resolve_policy("nope")

    @m.register_policy
    class Custom(m.FifoSchedulerPolicy):
        name = "custom_test"

    try:
        assert isinstance(m.resolve_policy("custom_test"), Custom)
    finally:
        m._POLICIES.pop("custom_test")


def test_slo_by_name_needs_its_alert_source():
    # the reference reads its SLO engine; the port's is not ported, so the
    # policy never quietly reports "not burning"
    assert isinstance(jsched.resolve_policy("slo"),
                      jsched.SloAwareSchedulerPolicy)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tsched.resolve_policy("slo")
    with pytest.raises(NotImplementedError, match="firing_fn"):
        tsched.SloAwareSchedulerPolicy()


def test_engines_resolve_the_policy_flag(pair):
    jm, tm = pair
    old_j = jcfg.get_flag("FLAGS_scheduler_policy")
    old_t = get_flags("FLAGS_scheduler_policy")["FLAGS_scheduler_policy"]
    assert old_j == old_t == "fifo"
    kw = dict(max_batch=2, max_seq_len=32, page_size=8)
    jcfg.set_flags({"FLAGS_scheduler_policy": "slo"})
    set_flags({"FLAGS_scheduler_policy": "slo"})
    try:
        assert isinstance(JaxEngine(jm, **kw).scheduler,
                          jsched.SloAwareSchedulerPolicy)
        with pytest.raises(NotImplementedError):
            ServingEngine(tm, device="cpu", **kw)
        # an explicit scheduler wins over the flag, in both
        pol = tsched.SloAwareSchedulerPolicy(firing_fn=lambda: [])
        assert ServingEngine(tm, device="cpu", scheduler=pol,
                             **kw).scheduler is pol
        assert isinstance(JaxEngine(jm, scheduler="fifo", **kw).scheduler,
                          jsched.FifoSchedulerPolicy)
    finally:
        jcfg.set_flags({"FLAGS_scheduler_policy": old_j})
        set_flags({"FLAGS_scheduler_policy": old_t})
    assert isinstance(ServingEngine(tm, device="cpu", **kw).scheduler,
                      tsched.FifoSchedulerPolicy)


def _both(make):
    """The same decision through both packages' policies."""
    return [make(m) for m in (jsched, tsched)]


def test_burst_k_bucketing_both_packages():
    for m in (jsched, tsched):
        pol = m.SchedulerPolicy()
        e = _FakeEngine(decode_burst=4)
        assert pol.burst_k(e, [0, 1], {0: 5, 1: 1}) == 4
        assert pol.burst_k(e, [0, 1], {0: 1, 1: 1}) == 1
        assert pol.burst_k(_FakeEngine(decode_burst=1), [0], {0: 9}) == 1
        assert pol.prefill_chunk_budget(e, [0]) == 32
        assert pol.promotion_budget(e, 5) == 5


def test_default_victim_is_youngest_both_packages():
    eng = _FakeEngine(slots=[_FakeSlot(5), _FakeSlot(9), _FakeSlot(2)])
    for m in (jsched, tsched):
        pol = m.FifoSchedulerPolicy()
        assert pol.select_victim(eng, [0, 1, 2], "page_stall") == 1
        assert pol.select_victim(eng, [0, 2], "decode_oom") == 0


@pytest.mark.parametrize("firing,pending,free,want", [
    ([], [(0, 9), (1, 3)], 64, 0),                 # FIFO when not burning
    (["ttft_p95"], [(0, 9), (1, 3), (2, 6)], 64, 1),  # shortest first
    (["ttft_p95"], [(0, 4, 9), (1, 6)], 64, 1),    # prior tokens count
    (["ttft_p95"], [(0, 12), (1, 5)], 1, 1),       # skip unfitting heads
    (["ttft_p95"], [(0, 12)], 1, None),            # nothing fits
    ([], [(0, 12), (1, 5)], 1, None),              # head-of-line blocking
    (["itl_p99"], [(0, 9), (1, 3)], 64, 0),        # only ttft alerts count
])
def test_slo_admission_both_packages(firing, pending, free, want):
    eng = _FakeEngine(pending=[_entry(*p) for p in pending],
                      free_pages=free)
    got = _both(lambda m: m.SloAwareSchedulerPolicy(
        firing_fn=lambda: firing).select_admission(eng))
    assert got == [want, want]


def test_slo_victim_and_budgets_both_packages():
    eng = _FakeEngine(slots=[_FakeSlot(0, 2, 10), _FakeSlot(1, 9, 10),
                             _FakeSlot(2, 4, 12)], prefill_chunk=32)
    for firing, chunk, promo in (([], 32, 7), (["ttft_fast"], 16, 3)):
        for m in (jsched, tsched):
            pol = m.SloAwareSchedulerPolicy(firing_fn=lambda f=firing: f)
            assert pol.select_victim(eng, [0, 1, 2], "page_stall") == 2
            assert pol.select_victim(eng, [0, 1], "decode_oom") == 0
            assert pol.prefill_chunk_budget(eng, [0]) == chunk
            assert pol.promotion_budget(eng, 7) == promo


def test_slo_firing_cache_ttl_and_broken_source_both_packages():
    for m in (jsched, tsched):
        calls, t = [], [0.0]
        pol = m.SloAwareSchedulerPolicy(
            firing_fn=lambda: calls.append(1) or ["ttft_p95"],
            clock=lambda: t[0])
        eng = _FakeEngine(pending=[_entry(0, 3)])
        pol.select_admission(eng)
        pol.select_admission(eng)
        assert len(calls) == 1  # within the TTL: one evaluation
        t[0] += 1.0
        pol.select_admission(eng)
        assert len(calls) == 2

        def boom():
            raise RuntimeError("slo plane down")

        broken = m.SloAwareSchedulerPolicy(firing_fn=boom)
        assert broken.select_admission(eng) == 0  # FIFO, admission goes on
