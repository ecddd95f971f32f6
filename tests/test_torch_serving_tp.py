"""The port's paged engine at tensor-parallel degree > 1 against the JAX
package's engine on a tp mesh, on the CPU in f32.

The port: four gloo ranks (`torch_tp_workers.serving_runs_main`), one
engine a rank. Each rank runs `fleet.init` (mp_degree 2 and dp_degree 2,
or mp_degree 4), builds the model under the mesh (so it holds its shards)
from the reference model's full numpy state, and serves the same requests
in the same order. The reference: `paddle_tpu.inference.ServingEngine(...,
mesh=build_mesh(tp=t))` on `conftest.py`'s 8-device CPU mesh, the
configurations of its own TP serving tests: `test_serving_tp.py` (sync
decode at tp 4 and 2, burst, preemption, GPT with burst and async),
`test_gqa.py:94` (kvh 2 at tp 2), `test_kv_quant.py:215-235` (int8 KV at
tp 2), and here also the prefix cache with chunked prefill, shallow-exit
and draft-model speculative decoding, int8 weights (`nn.quant`, lm_head
kept) and a mixed greedy / sampled batch.

Held: every greedy stream equal to the reference's token for token; every
rank's streams (sampled ones too) equal bit for bit; the gathered logits
of the first sampled position within 1e-4 (max abs) of the reference
model's; each rank's pools (and int8 scale pools, and a draft model's)
holding kv_heads / tp heads; no CUDA graph; `kv_heads % tp` raising the
reference's message, and a model built at tp 1 under a tp mesh raising.
The weights are the reference's seeded ones with every matrix scaled by
`SHARPEN`, so that greedy streams do not settle on one repeated token.
"""
import functools

import jax
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as jmesh
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn.quant import quantize_for_inference as jax_quantize
from torch_dist_workers import run_group
from torch_parity import jax_state
from torch_tp_workers import serving_runs_main

WORLD = 4
VOCAB, HIDDEN, HEADS, SEQ = 128, 64, 4, 64
SHARPEN = 4.0
RNG = np.random.RandomState(7)


def _prompts(*lens):
    return [RNG.randint(0, VOCAB, (n,)) for n in lens]


def _phase(prompts, n, **kw):
    return [(p, n, dict(kw)) for p in prompts]


_SAMPLED = _prompts(9, 5)
_SYSTEM = RNG.randint(0, VOCAB, (16,))
_TAILS = [RNG.randint(0, VOCAB, (n,)) for n in (5, 9, 3)]

# tag: family, tp, layers, kv heads, engine arguments, phases (and
# withheld pages, warmup, weight quantization, a draft model's layers)
CASES = {
    # test_serving_tp.py:31, at tp 4 and tp 2
    "llama_tp4": dict(family="llama", tp=4, kvh=4, engine=dict(
        max_batch=4, max_seq_len=64, page_size=8),
        phases=[_phase(_prompts(9, 17, 5, 12), 12)]),
    "llama_sync": dict(family="llama", tp=2, kvh=4, engine=dict(
        max_batch=4, max_seq_len=64, page_size=8),
        phases=[_phase(_prompts(9, 17, 5, 12), 12)]),
    # test_serving_tp.py:67, with warmup first
    "llama_burst": dict(family="llama", tp=2, kvh=4, warmup=True,
                        engine=dict(max_batch=3, max_seq_len=64, page_size=8,
                                    decode_burst=4),
                        phases=[_phase(_prompts(9, 5, 12), 10)]),
    # test_serving_tp.py:308-344
    "gpt_burst_async": dict(family="gpt", tp=2, engine=dict(
        max_batch=3, max_seq_len=64, page_size=8, decode_burst=4,
        async_depth=1), phases=[_phase(_prompts(6, 11, 4), 10)]),
    # test_gqa.py:94
    "gqa": dict(family="llama", tp=2, kvh=2, engine=dict(
        max_batch=2, max_seq_len=64, page_size=8),
        phases=[_phase(_prompts(9, 5), 8)]),
    # test_kv_quant.py:215-235
    "kv_int8": dict(family="llama", tp=2, kvh=4, engine=dict(
        max_batch=2, max_seq_len=32, page_size=8, kv_cache_quant="int8"),
        phases=[_phase(_prompts(6, 10), 8)]),
    # test_serving_tp.py:108, with pages withheld so that growth preempts
    "preempt": dict(family="llama", tp=2, kvh=4, withhold=4, engine=dict(
        max_batch=3, max_seq_len=32, page_size=8),
        phases=[_phase(_prompts(8, 8, 8), 14)]),
    "prefix_chunk": dict(family="llama", tp=2, kvh=4, engine=dict(
        max_batch=3, max_seq_len=64, page_size=8, prefix_cache=1,
        prefill_chunk=8), phases=[
            _phase([np.concatenate([_SYSTEM, _TAILS[0]])], 8),
            _phase([np.concatenate([_SYSTEM, t]) for t in _TAILS[1:]], 8)]),
    "spec_shallow": dict(family="llama", tp=2, kvh=4, engine=dict(
        max_batch=3, max_seq_len=64, page_size=8, spec_decode=3),
        phases=[_phase(_prompts(9, 5, 12), 10)]),
    "spec_draft": dict(family="llama", tp=2, kvh=4, draft_layers=1,
                       engine=dict(max_batch=2, max_seq_len=64, page_size=8,
                                   spec_decode=3),
                       phases=[_phase(_prompts(7, 11), 10)]),
    "int8_weights": dict(family="llama", tp=2, kvh=4,
                         quant=("weight_only_int8", -1), engine=dict(
                             max_batch=3, max_seq_len=64, page_size=8,
                             decode_burst=4),
                         phases=[_phase(_prompts(9, 5, 12), 10)]),
    # each prompt sampled and greedy in one batch, at decode_burst 4
    "sampled": dict(family="llama", tp=2, kvh=2, engine=dict(
        max_batch=4, max_seq_len=64, page_size=8, decode_burst=4,
        decode_strategy="sampling", temperature=0.8, top_k=20, top_p=0.9,
        seed=5), phases=[[
            (p, 10, kw) for p in _SAMPLED
            for kw in ({}, dict(decode_strategy="greedy_search"))]]),
}
TAGS = list(CASES)


def _configs(family, layers, kvh):
    """(the reference's config, the port's config fields)."""
    if family == "llama":
        jcfg = JaxLlamaConfig.tiny(vocab=VOCAB, hidden=HIDDEN, layers=layers,
                                   heads=HEADS, seq=SEQ)
        jcfg.num_key_value_heads = kvh
        return jcfg, dict(vocab_size=VOCAB, hidden_size=HIDDEN,
                          intermediate_size=4 * HIDDEN,
                          num_hidden_layers=layers, num_attention_heads=HEADS,
                          num_key_value_heads=kvh,
                          max_position_embeddings=SEQ)
    fields = dict(vocab_size=VOCAB, hidden_size=HIDDEN,
                  num_hidden_layers=layers, num_attention_heads=HEADS,
                  max_position_embeddings=SEQ)
    return JaxGPTConfig(**fields), fields


def _jax_model(family, layers, kvh, seed):
    """The reference model from `seed`, every matrix scaled by SHARPEN;
    (model, its full numpy state, the port's config fields)."""
    jcfg, fields = _configs(family, layers, kvh)
    paddle.seed(seed)
    jm = (JaxLlama if family == "llama" else JaxGPT)(jcfg)
    state = {k: (v * SHARPEN if v.ndim == 2 else v).astype(v.dtype)
             for k, v in jax_state(jm).items()}
    jm.set_state_dict(state)
    jm.eval()
    return jm, state, fields


def _build(tag):
    """The case's reference models and the rank program's case dict."""
    c = CASES[tag]
    seed = TAGS.index(tag)
    jm, state, fields = _jax_model(c["family"], 2, c.get("kvh"), seed)
    if c.get("quant"):
        jax_quantize(jm, *c["quant"], exclude=("lm_head",))
    case = dict(tag=tag, tp=c["tp"], family=c["family"], cfg=fields,
                state=state, engine=c["engine"], phases=c["phases"],
                withhold=c.get("withhold", 0), warmup=c.get("warmup", False),
                quant=c.get("quant"))
    jdraft = None
    if c.get("draft_layers"):
        jdraft, dstate, dfields = _jax_model(c["family"], c["draft_layers"],
                                             c.get("kvh"), seed + 100)
        case.update(draft_cfg=dfields, draft_state=dstate)
    return jm, jdraft, case


def _first_position(tag):
    """The position of the first prompt the engine samples first: its
    last, or with chunked prefill the first chunk's last (a chunk round
    samples every row it runs)."""
    c = CASES[tag]
    n = len(c["phases"][0][0][0])
    chunk = c["engine"].get("prefill_chunk")
    return min(n, chunk) - 1 if chunk else n - 1


@functools.lru_cache(maxsize=None)
def _reference(tag):
    """The reference engine on a tp mesh: the streams in request order,
    and the reference model's logits of the first prompt at the position
    the port's engine samples first."""
    c = CASES[tag]
    jm, jdraft, _ = _build(tag)
    jmesh.set_mesh(None)
    mesh = jmesh.set_mesh(jmesh.build_mesh(
        tp=c["tp"], devices=np.asarray(jax.devices("cpu")[:c["tp"]])))
    try:
        eng = JaxEngine(jm, mesh=mesh, draft_model=jdraft, **c["engine"])
        if c.get("withhold"):
            eng._free_pages = eng._free_pages[:-c["withhold"]]
        if c.get("warmup"):
            eng.warmup(sampling=True)
        rids, streams = [], {}
        for phase in c["phases"]:
            for prompt, n, kw in phase:
                rids.append(eng.add_request(prompt, max_new_tokens=n, **kw))
            for f in eng.run():
                streams[f.request_id] = np.asarray(f.output_ids).tolist()
        first = c["phases"][0][0][0]
        logits = np.asarray(jm(paddle.to_tensor(first[None]))._data)[
            0, _first_position(tag)]
    finally:
        jmesh.set_mesh(None)
    return dict(streams=[streams[r] for r in rids], logits=logits)


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, from one group of WORLD ranks."""
    cases = [_build(tag)[2] for tag in TAGS]
    _, refusal = _configs("llama", 2, HEADS)
    return run_group(serving_runs_main, WORLD, cases, refusal)


def _greedy(tag):
    """Which requests of the case decode greedily, in request order."""
    c = CASES[tag]
    engine_greedy = c["engine"].get("decode_strategy",
                                    "greedy_search") == "greedy_search"
    return [kw.get("decode_strategy", "greedy_search" if engine_greedy
                   else "sampling") == "greedy_search"
            for phase in c["phases"] for _p, _n, kw in phase]


@pytest.mark.parametrize("tag", TAGS)
def test_greedy_streams_match_the_reference_tp_mesh_engine(ranks, tag):
    want = _reference(tag)["streams"]
    greedy = _greedy(tag)
    for r in ranks:
        got = r[tag]["streams"]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            if greedy[i]:
                assert g == w, (tag, i, g, w)
    c = CASES[tag]
    news = [n for phase in c["phases"] for _p, n, _kw in phase]
    assert [len(s) for s in ranks[0][tag]["streams"]] == news


@pytest.mark.parametrize("tag", TAGS)
def test_every_rank_commits_the_same_tokens(ranks, tag):
    """Greedy and sampled streams equal bit for bit on every rank (both tp
    ranks, and at tp 2 both dp replicas), every token in the vocabulary."""
    want = ranks[0][tag]["streams"]
    for r in ranks[1:]:
        assert r[tag]["streams"] == want
    assert all(0 <= t < VOCAB for s in want for t in s)
    assert sorted({(r[tag]["tp_rank"], r[tag]["dp_rank"]) for r in ranks}) \
        == sorted((t, d) for t in range(CASES[tag]["tp"])
                  for d in range(WORLD // CASES[tag]["tp"]))


def test_sampled_rows_draw(ranks):
    """The mixed batch's sampled rows draw (temperature 0.8, top-k 20):
    a prompt's sampled stream is not its greedy one, on every rank
    alike."""
    assert _greedy("sampled") == [False, True, False, True]
    for r in ranks:
        got = r["sampled"]["streams"]
        assert got[0] != got[1] or got[2] != got[3]


@pytest.mark.parametrize("tag", TAGS)
def test_first_sampled_logits_are_gathered_and_match_the_reference(
        ranks, tag):
    """The logits the engine samples the first token from are the whole
    vocabulary's (gathered from the ranks' shards), equal on every rank,
    and within 1e-4 of the reference model's on the first prompt."""
    want = _reference(tag)["logits"]
    first = ranks[0][tag]["first_logits"]
    assert first.shape[-1] == VOCAB
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[tag]["first_logits"], first)
    assert np.abs(first[0] - want).max() <= 1e-4, \
        np.abs(first[0] - want).max()


@pytest.mark.parametrize("tag", TAGS)
def test_pools_hold_kv_heads_over_tp_and_no_graph(ranks, tag):
    c = CASES[tag]
    kvh = c.get("kvh") or HEADS
    for r in ranks:
        got = r[tag]
        assert got["tp"] == c["tp"]
        assert got["pools"][0] == kvh // c["tp"]
        if c["engine"].get("kv_cache_quant"):
            assert got["scales"][0] == kvh // c["tp"]
        if c.get("draft_layers"):
            assert got["draft_pools"][0] == kvh // c["tp"]
        assert got["graphs"] == (False, False)
        assert got["counters"]["graph_captures"] == 0


def test_each_mode_ran(ranks):
    """Each configuration went through its own path on every rank."""
    for r in ranks:
        assert r["preempt"]["counters"]["preemptions"] > 0
        assert r["prefix_chunk"]["counters"]["chunk_rounds"] > 0
        # the later requests share the first's 16-token prefix: 2 pages
        assert r["prefix_chunk"]["counters"]["prefix_hits"] == 2 * 16
        assert r["spec_shallow"]["counters"]["spec_rounds"] > 0
        assert r["spec_draft"]["counters"]["spec_rounds"] > 0
        # 7 linears a layer, each a quantized shard (lm_head kept)
        assert r["int8_weights"]["quantized"] == 14


def test_kv_heads_that_tp_does_not_divide_raise_the_references_message(
        ranks):
    """An engine on a tp-2 mesh over a model with one KV head raises, in
    both packages, with the reference's message."""
    paddle.seed(0)
    jcfg, _ = _configs("llama", 2, 1)
    jmesh.set_mesh(None)
    mesh = jmesh.set_mesh(jmesh.build_mesh(
        tp=2, devices=np.asarray(jax.devices("cpu")[:2])))
    try:
        with pytest.raises(ValueError) as e:
            JaxEngine(JaxLlama(jcfg), max_batch=2, max_seq_len=64,
                      page_size=8, mesh=mesh)
    finally:
        jmesh.set_mesh(None)
    assert "kv-head count must be divisible by tp" in str(e.value)
    for r in ranks:
        assert r["refusals"]["kv_heads"] == str(e.value)


def test_a_model_built_at_tp1_under_a_tp_mesh_raises(ranks):
    for r in ranks:
        msg = r["refusals"]["built_at_tp1"]
        assert msg is not None
        assert "tensor-parallel degree 1" in msg and "degree 2" in msg
