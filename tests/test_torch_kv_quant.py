"""The port's int8 KV cache against the JAX package, on the CPU.

The q8 cache writers give the reference's int8 pages and scales (the
port's scale pools are [kv_heads, n_pages, page_size]; the reference pads
the last dim to 128 lanes, so its `[..., :page_size]` is compared); the
plain decode attention over int8 pages agrees with the reference's
dequantizing `paged_attention_xla` and its interpret-mode Pallas kernel at
the reference's own rtol=2e-4, atol=2e-5 (tests/test_kv_quant.py); and the
port's engine, serving a tiny LLaMA quantized in JAX, gives greedy streams
identical to the JAX engine's for int8 and int4 weights, float and int8 KV,
with and without preemption.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.nn.quant import quantize_for_inference as jax_quantize
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.nn.quant import quantize_for_inference
from paddle_tpu_torch.weights import load_llama_state
from torch_parity import PAGE, jax_state, tiny_pair

_KVH, _N_PAGES, _PS, _HD = 2, 8, 4, 8


def _jax_pools():
    kp = jnp.zeros((_KVH, _N_PAGES, _PS, _HD), jnp.int8)
    ks, vs = jpa.alloc_page_scales(_N_PAGES, _PS, _KVH)
    return kp, ks, jnp.zeros_like(kp), vs


def _port_pools():
    kp, vp = tpa.alloc_pages(_N_PAGES, _PS, _KVH, _HD, torch.int8, "cpu")
    ks, vs = tpa.alloc_page_scales(_N_PAGES, _PS, _KVH, "cpu")
    return kp, ks, vp, vs


def _same(port, ref):
    """int8 pages identical, scales equal to the reference's first
    page_size lanes."""
    kp, ks, vp, vs = port
    jkp, jks, jvp, jvs = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(kp.numpy(), jkp)
    np.testing.assert_array_equal(vp.numpy(), jvp)
    np.testing.assert_array_equal(ks.numpy(), jks[..., :_PS])
    np.testing.assert_array_equal(vs.numpy(), jvs[..., :_PS])
    assert not jks[..., _PS:].any()


@pytest.mark.parametrize("active", [None, (True, False, True)])
def test_update_q8_matches_reference(active):
    rng = np.random.RandomState(0)
    k_new = (rng.randn(3, _KVH, _HD) * 3).astype(np.float32)
    v_new = rng.randn(3, _KVH, _HD).astype(np.float32)
    tables = np.array([[0, 1], [2, 3], [5, 4]], np.int32)
    lens = np.array([0, 5, 6], np.int32)
    act = None if active is None else np.array(active)
    ref = jpa.update_paged_kv_cache_q8(
        *_jax_pools(), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(tables), jnp.asarray(lens),
        active=None if act is None else jnp.asarray(act))
    kp, ks, vp, vs = _port_pools()
    out = tpa.update_paged_kv_cache_q8(
        kp, ks, vp, vs, torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(tables), torch.from_numpy(lens),
        active=None if act is None else torch.from_numpy(act))
    assert out[0] is kp and out[1] is ks  # written in place
    _same((kp, ks, vp, vs), ref)
    if act is not None:  # the inactive row's page stays empty
        assert not kp[:, 2].any() and not ks[:, 2].any()


def test_prefill_q8_matches_reference():
    rng = np.random.RandomState(1)
    kseq = rng.randn(2, 10, _KVH, _HD).astype(np.float32)
    vseq = rng.randn(2, 10, _KVH, _HD).astype(np.float32)
    tables = np.array([[4, 5, 6], [0, 1, 2]], np.int32)
    slens = np.array([10, 3], np.int32)  # the second row's tail is padding
    ref = jpa.prefill_paged_kv_cache_q8(
        *_jax_pools(), jnp.asarray(kseq), jnp.asarray(vseq),
        jnp.asarray(tables), jnp.asarray(slens))
    port = _port_pools()
    tpa.prefill_paged_kv_cache_q8(*port, torch.from_numpy(kseq),
                                  torch.from_numpy(vseq),
                                  torch.from_numpy(tables),
                                  torch.from_numpy(slens))
    _same(port, ref)
    assert not port[0][:, 1:3].any()  # padding wrote nothing


def test_quant_token_matches_reference_bf16_input():
    x = torch.randn(4, 3, 128).bfloat16()
    q, s = tpa._quant_kv_token(x)
    jq, js = jpa._quant_kv_token(jnp.asarray(x.float().numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _decode_inputs(seed, b, qh, kvh, hd=16, ps=8, pps=4):
    """The reference suite's set-up: float pages quantized per slot, a
    shuffled block table, contexts 13 and 27."""
    rng = np.random.RandomState(seed)
    n_pages = 16
    q = rng.randn(b, qh, hd).astype(np.float32)
    kf = rng.randn(kvh, n_pages, ps, hd).astype(np.float32)
    vf = rng.randn(kvh, n_pages, ps, hd).astype(np.float32)
    kq, ks = (t.numpy() for t in tpa._quant_kv_token(torch.from_numpy(kf)))
    vq, vs = (t.numpy() for t in tpa._quant_kv_token(torch.from_numpy(vf)))
    tables = rng.permutation(n_pages)[: b * pps].reshape(b, pps) \
        .astype(np.int32)
    lens = np.array([13, 27][:b], np.int32)
    return q, kq, vq, ks, vs, tables, lens


@pytest.mark.parametrize("b,qh,kvh", [(2, 4, 2), (2, 4, 4), (1, 8, 2)])
def test_paged_attention_q8_matches_reference(b, qh, kvh):
    q, kq, vq, ks, vs, tables, lens = _decode_inputs(b + qh, b, qh, kvh)
    pad = ((0, 0), (0, 0), (0, jpa._SCALE_LANES - ks.shape[-1]))
    jargs = [jnp.asarray(a) for a in (q, kq, vq, tables, lens)]
    jsc = dict(k_scales=jnp.asarray(np.pad(ks, pad)),
               v_scales=jnp.asarray(np.pad(vs, pad)))
    got = tpa.paged_attention(
        *(torch.from_numpy(a) for a in (q, kq, vq, tables, lens)),
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    for want in (jpa.paged_attention_xla(*jargs, **jsc),
                 jpa.paged_attention(*jargs, **jsc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)
    # leaving the K scales out is a different function
    bad = tpa.paged_attention_ref(
        *(torch.from_numpy(a) for a in (q, kq, vq, tables, lens)),
        k_scales=torch.ones_like(torch.from_numpy(ks)),
        v_scales=torch.from_numpy(vs))
    assert not np.allclose(bad.numpy(), got.numpy(), rtol=2e-4, atol=2e-5)


def test_paged_attention_wants_both_scales():
    q, kq, vq, ks, vs, tables, lens = _decode_inputs(0, 2, 4, 2)
    with pytest.raises(ValueError, match="both"):
        tpa.paged_attention(
            *(torch.from_numpy(a) for a in (q, kq, vq, tables, lens)),
            k_scales=torch.from_numpy(ks))


_PROMPT_LENS = (5, 9, 17, 3, 12, 1)
_NEW = (10, 20, 6, 25, 12, 4)


def _serve(engine_cls, model, kv, withhold=0, **kw):
    eng = engine_cls(model, max_batch=3, max_seq_len=48, page_size=PAGE,
                     decode_strategy="greedy_search", kv_cache_quant=kv,
                     **kw)
    if withhold:
        eng._free_pages = eng._free_pages[:-withhold]
    rng = np.random.RandomState(5)
    for n, m in zip(_PROMPT_LENS, _NEW):
        eng.add_request(rng.randint(0, 256, (n,)), max_new_tokens=m)
    return {f.request_id: f.output_ids.tolist() for f in eng.run()}, eng


@pytest.mark.parametrize("algo,gs,kv,withhold", [
    ("weight_only_int8", -1, None, 0),
    ("weight_only_int8", -1, "int8", 0),
    ("weight_only_int4", 64, None, 0),
    ("weight_only_int4", 64, "int8", 0),
    ("weight_only_int8", -1, "int8", 10),   # an 8-page pool: preempts
])
def test_quantized_engine_streams_match_jax(algo, gs, kv, withhold):
    jm, tm, _ = tiny_pair(seed=3)
    jax_quantize(jm, algo=algo, group_size=gs, exclude=("lm_head",))
    quantize_for_inference(tm, algo=algo, group_size=gs,
                           exclude=("lm_head",))
    load_llama_state(tm, jax_state(jm))
    want, _ = _serve(JaxEngine, jm, kv, withhold)
    got, eng = _serve(ServingEngine, tm, kv, withhold, device="cpu")
    assert got == want
    assert all(len(got[r]) == n for r, n in zip(sorted(got), _NEW))
    if kv:
        assert eng.k_pages[0].dtype == torch.int8
        # the pool's pages and the scratch page inactive rows write
        assert eng.k_scales[0].shape == (2, eng.max_batch *
                                         eng.pages_per_seq + 1, PAGE)
    if withhold:
        assert eng.preemptions > 0
        assert len(eng._free_pages) == eng.max_batch * eng.pages_per_seq \
            - withhold


def test_engine_rejects_unknown_kv_quant():
    _, tm, _ = tiny_pair()
    with pytest.raises(ValueError, match="kv_cache_quant"):
        ServingEngine(tm, max_seq_len=32, page_size=8, device="cpu",
                      kv_cache_quant="fp8")
