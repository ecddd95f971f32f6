"""The port's LLaMA serving paths against the JAX model on identical weights,
both on the CPU in f32.

Tolerances: 1e-5 abs for rope (the same f32 formula, a different pow/cos
implementation); 1e-4 abs for logits (two layers of f32 matmuls summed in
another order by each framework).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import rope as jrope
from paddle_tpu.tensor import Tensor, as_array
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn.functional import apply_rope, rope_tables
from paddle_tpu_torch.weights import llama_param_shapes, load_llama_state
from torch_parity import KV_HEADS, PAGE, jax_state, tiny_pair

LOGIT_ATOL = 1e-4


@pytest.mark.parametrize("offset", [0, 5, "rows"])
def test_rope_matches_jax(offset):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 4, 2, 32).astype(np.float32)
    if offset == "rows":
        off_np = np.array([0, 7, 30], np.int32)
        j_off, t_off = jnp.asarray(off_np), torch.from_numpy(off_np)
    else:
        j_off = t_off = offset
    jc, js = jrope.rope_tables(4, 32, base=10000.0, position_offset=j_off)
    tc, ts = rope_tables(4, 32, base=10000.0, position_offset=t_off)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js))
    got = apply_rope(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rope_tables_follow_query_dtype():
    c, s = rope_tables(4, 32, dtype=torch.bfloat16,
                       position_offset=torch.tensor([1, 2]))
    assert c.dtype == s.dtype == torch.bfloat16 and c.shape == (2, 4, 16)


def test_linear_uses_paddle_in_out_layout():
    lin = Linear(3, 5, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.arange(15.0).reshape(3, 5))
    x = torch.tensor([[1.0, 0.0, 2.0]])
    torch.testing.assert_close(lin(x), x @ lin.weight)
    assert lin.weight.shape == (3, 5)


def test_config_presets_match_jax():
    from paddle_tpu.models.llama import LlamaConfig as JC

    for name in ("llama2_7b",):
        j, t = getattr(JC, name)(), getattr(LlamaConfig, name)()
        for f in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "max_position_embeddings",
                  "rms_norm_eps", "rope_theta", "tie_word_embeddings"):
            assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("tie", [False, True])
def test_param_names_and_shapes_match_jax(tie):
    jm, tm, cfg = tiny_pair(tie=tie)
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want == llama_param_shapes(cfg)


def test_load_rejects_mismatched_state():
    jm, tm, _ = tiny_pair()
    state = jax_state(jm)
    bad = dict(state)
    bad.pop("llama.norm.weight")
    with pytest.raises(KeyError, match="missing"):
        load_llama_state(tm, bad)
    bad = dict(state, extra=np.zeros(3))
    with pytest.raises(KeyError, match="unexpected"):
        load_llama_state(tm, bad)
    bad = dict(state)
    bad["lm_head.weight"] = bad["lm_head.weight"].T
    with pytest.raises(ValueError, match="shape"):
        load_llama_state(tm, bad)


def test_init_kv_caches_dense_f32():
    _, tm, cfg = tiny_pair()
    caches = tm.init_kv_caches(3, 16)
    assert len(caches) == cfg.num_hidden_layers
    k, v = caches[0]
    assert k.shape == v.shape == (3, 16, KV_HEADS, 32)
    assert k.dtype == torch.float32


@pytest.mark.parametrize("tie", [False, True])
def test_forward_cached_logits_match_jax(tie):
    """A 12-token prefill, then 3 more tokens at cur_len 12."""
    jm, tm, cfg = tiny_pair(seed=1, tie=tie)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, cfg.vocab_size, (2, 15)).astype(np.int64)
    jc = jm.init_kv_caches(2, 16)
    tc = tm.init_kv_caches(2, 16)
    for lo, hi in ((0, 12), (12, 15)):
        jl, jc = jm.forward_cached(Tensor(jnp.asarray(ids[:, lo:hi])), jc,
                                   lo)
        jc = [(as_array(k), as_array(v)) for k, v in jc]
        with torch.no_grad():
            tl, tc = tm.forward_cached(torch.from_numpy(ids[:, lo:hi]), tc,
                                       lo)
        np.testing.assert_allclose(tl.numpy(), np.asarray(as_array(jl)),
                                   rtol=0, atol=LOGIT_ATOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=1e-5)


def test_forward_paged_logits_and_pages_match_jax():
    """One decode token per row over random page contents, ragged context
    lengths, one inactive row (its logits are not compared: the port gives
    an inactive row context 0, the JAX step lens + 1)."""
    jm, tm, cfg = tiny_pair(seed=2)
    rng = np.random.RandomState(2)
    b, pps, n_pages = 4, 4, 16
    tables = rng.permutation(n_pages).reshape(b, pps).astype(np.int32)
    lens = np.array([0, 7, 8, 20], np.int32)
    active = np.array([True, True, False, True])
    ids = rng.randint(0, cfg.vocab_size, (b, 1)).astype(np.int64)
    shape = (KV_HEADS, n_pages, PAGE, 32)
    pools = [(rng.randn(*shape).astype(np.float32),
              rng.randn(*shape).astype(np.float32))
             for _ in range(cfg.num_hidden_layers)]
    jl, jcaches = jm.forward_paged(
        Tensor(jnp.asarray(ids)),
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools],
        jnp.asarray(tables), jnp.asarray(lens), active=jnp.asarray(active))
    tcaches = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
               for k, v in pools]
    n0 = tpa.launches
    with torch.no_grad():
        tl, tcaches = tm.forward_paged(
            torch.from_numpy(ids), tcaches, torch.from_numpy(tables),
            torch.from_numpy(lens), active=torch.from_numpy(active))
    assert tpa.launches == n0  # the CPU runs the plain version
    np.testing.assert_allclose(tl.numpy()[active],
                               np.asarray(as_array(jl))[active], rtol=0,
                               atol=LOGIT_ATOL)
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        np.testing.assert_allclose(tk.numpy(), np.asarray(as_array(jk)),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(as_array(jv)),
                                   rtol=0, atol=1e-5)


def test_forward_paged_rejects_windows():
    """A window (s > 1) runs since the window step is ported, and rejects
    the positions it must not write: those at or past `limit_lens` and
    every position of an inactive row leave the pages as they were."""
    _, tm, _ = tiny_pair()
    caches = [tpa.alloc_pages(5, PAGE, KV_HEADS, 32) for _ in range(2)]
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lens = torch.tensor([3, 0], dtype=torch.int32)
    with torch.no_grad():
        logits, _ = tm.forward_paged(
            torch.ones(2, 6, dtype=torch.long), caches, tables, lens,
            active=torch.tensor([True, False]),
            limit_lens=torch.tensor([7, 6], dtype=torch.int32))
    assert logits.shape == (2, 6, 256) and torch.isfinite(logits).all()
    for kp, vp in caches:
        for pool in (kp, vp):
            written = pool.abs().sum(dim=(0, 3)) != 0  # [page, slot]
            assert written[0, 3:7].all()
            assert written.sum() == 4  # positions 3..6 of row 0 alone


def test_init_weights_is_seeded():
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = LlamaConfig.tiny(vocab=64, hidden=64, layers=1, heads=2)
    a = LlamaForCausalLM(cfg, device="cpu", seed=3).state_dict()
    b = LlamaForCausalLM(cfg, device="cpu", seed=3).state_dict()
    c = LlamaForCausalLM(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head.weight"], c["lm_head.weight"])
    assert torch.equal(a["llama.norm.weight"], torch.ones(64))
