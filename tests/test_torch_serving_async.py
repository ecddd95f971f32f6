"""Async (dispatch-ahead) decode of the port's ServingEngine against the JAX
engine and the port's own sync path, on the CPU in f32.

With `async_depth=N` the pure-decode phase keeps the decode state in the
device buffers and dispatches burst n+1 off burst n's carry before the host
replays burst n's tokens. The cases mirror the reference's
`tests/test_serving_async.py`: greedy async decoding is observationally
identical to the sync engine (streams, eos, callbacks, abort), here also
token for token equal to the JAX engine's (each JAX engine runs once, in a
module-scoped fixture).
"""
import numpy as np
import pytest

from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu_torch.inference import ServingEngine
from torch_parity import serve, serving_pair

VOCAB = 97
KW = dict(page_size=8, decode_strategy="greedy_search")


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)) for n in lens]


# (engine kwargs, prompt seed, prompt lengths, budgets)
CASES = {
    # budgets straddle burst and pipeline boundaries
    "mixed": (dict(max_batch=4, max_seq_len=40), 11, (4, 6, 5, 7),
              (1, 3, 9, 13)),
    "int8_kv": (dict(max_batch=3, max_seq_len=40, kv_cache_quant="int8"),
                9, (6, 6, 6), (10, 7, 10)),
    # more requests than slots: admission between pipelined phases
    "queue_drains": (dict(max_batch=2, max_seq_len=32), 13, (4,) * 5,
                     (8,) * 5),
    # a nearly-done row beside a long one: the reservation stops at each
    # row's budget (an uncapped (inflight + 1) * k would overrun row 0's
    # table)
    "budget_capped": (dict(max_batch=4, max_seq_len=40), 17, (30, 4),
                      (9, 30)),
}


def _run(engine_cls, model, case, **extra):
    ekw, seed, lens, news = CASES[case]
    eng = engine_cls(model, decode_burst=4, **KW, **ekw, **extra)
    return serve(eng, _prompts(seed, lens), news), eng


def _count_bursts(eng):
    """Record the bursts each `_decode_async` call dispatched."""
    real, seen = eng._decode_async, []

    def counted(max_bursts):
        out = real(max_bursts)
        seen.append(out[1])
        return out

    eng._decode_async = counted
    return seen


@pytest.fixture(scope="module")
def pair():
    return serving_pair()


@pytest.fixture(scope="module")
def jax_streams(pair):
    return {case: _run(JaxEngine, pair[0], case)[0] for case in CASES}


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_async_greedy_streams_equal_sync_and_jax(pair, jax_streams, case,
                                                 depth):
    tm = pair[1]
    ekw, seed, lens, news = CASES[case]
    eng = ServingEngine(tm, decode_burst=4, async_depth=depth,
                        device="cpu", **KW, **ekw)
    seen = _count_bursts(eng)
    got = serve(eng, _prompts(seed, lens), news)
    assert got == jax_streams[case]
    assert eng.discarded_tokens == 0 and not eng.has_work()
    assert len(eng._free_pages) == eng.max_batch * eng.pages_per_seq
    if depth:  # the pipeline ran, with bursts in flight (the last request
        # of the queue is left one burst when the queue empties)
        assert seen and (case == "queue_drains" or max(seen) > 1)
    else:
        assert not seen


def test_eos_finishes_inside_the_pipeline(pair):
    jm, tm = pair
    prompts = _prompts(5, (6, 6))
    kw = dict(max_batch=2, max_seq_len=48, decode_burst=4, **KW)
    free = serve(ServingEngine(tm, device="cpu", **kw), prompts, [12, 12])
    eos = free[0][5]
    want = serve(JaxEngine(jm, **kw), prompts, [12, 12], eos_token_id=eos)
    for depth in (0, 2):
        eng = ServingEngine(tm, async_depth=depth, device="cpu", **kw)
        got = serve(eng, prompts, [12, 12], eos_token_id=eos)
        assert got == want and eng.discarded_tokens == 0
    assert len(want[0]) <= 6


def test_streaming_and_abort_from_callback(pair):
    _, tm = pair
    prompts = _prompts(7, (5, 5))
    kw = dict(max_batch=2, max_seq_len=48, **KW)

    def run(burst, depth):
        streamed, aborted = {}, []
        eng = ServingEngine(tm, decode_burst=burst, async_depth=depth,
                            device="cpu", **kw)

        def cb(rid, tok):
            streamed.setdefault(rid, []).append(tok)
            # abort request 0 after its 6th token, mid-burst
            if rid == rid0 and len(streamed[rid]) == 6 and not aborted:
                aborted.append(rid)
                assert eng.abort(rid)

        rid0 = eng.add_request(prompts[0], max_new_tokens=14, on_token=cb)
        rid1 = eng.add_request(prompts[1], max_new_tokens=10, on_token=cb)
        fin = {f.request_id: f.output_ids.tolist() for f in eng.run()}
        assert rid0 not in fin and len(streamed[rid0]) == 6
        assert streamed[rid1] == fin[rid1] and len(fin[rid1]) == 10
        assert not eng.has_work()
        assert len(eng._free_pages) == eng.max_batch * eng.pages_per_seq
        return [streamed[rid0], streamed[rid1]]

    single = run(1, 0)
    # callbacks of a request in the same order as the single-step engine
    assert run(4, 0) == single
    assert run(4, 2) == single


def test_abort_pending_and_unknown_on_an_async_engine(pair):
    _, tm = pair
    eng = ServingEngine(tm, max_batch=1, max_seq_len=32, decode_burst=4,
                        async_depth=2, device="cpu", **KW)
    a, b, c = (eng.add_request(p, max_new_tokens=9)
               for p in _prompts(3, (4, 4, 4)))
    assert eng.abort(b) and not eng.abort(b) and not eng.abort(999)
    out = eng.run()
    assert [f.request_id for f in out] == [a, c]
    assert all(len(f.output_ids) == 9 for f in out)


def test_warmup_on_an_async_engine(pair):
    _, tm = pair
    kw = dict(max_batch=2, max_seq_len=48, decode_burst=4, **KW)
    eng = ServingEngine(tm, async_depth=2, device="cpu", **kw)
    assert eng.warmup() > 0
    assert set(eng._burst_fns) == {(True, 4), (True, 1)}
    prompts = _prompts(19, (6, 6))
    ref = serve(ServingEngine(tm, device="cpu", **kw), prompts, [8, 8])
    assert serve(eng, prompts, [8, 8]) == ref


def test_seeded_async_sampling_deterministic_and_in_vocab(pair):
    _, tm = pair
    prompts = _prompts(21, (4, 5))

    def once():
        eng = ServingEngine(tm, max_batch=2, max_seq_len=40, page_size=8,
                            decode_strategy="sampling", top_k=20, top_p=0.9,
                            seed=7, decode_burst=4, async_depth=2,
                            device="cpu")
        return serve(eng, prompts, [13, 11])

    a = once()
    assert a == once()
    assert [len(s) for s in a] == [13, 11]
    assert all(0 <= t < VOCAB for s in a for t in s)
