"""The port's GPT family against the JAX package's, on the CPU in f32.

The tiny GPT here (vocab 256, hidden 256, 2 heads of 128, 2 layers, 256
positions; batch 2 x 256 in training) has the flash kernels' head_dim, so
the port trains through the flash autograd function (its plain versions on
the CPU), and the reference through its interpret-mode Pallas passes
(`_PALLAS_BWD_MIN_SEQ` lowered to 128, as `test_torch_train.py` does).
Weights are the JAX model's, carried across by `weights.load_gpt_state`.

Tolerances: logits and the cached forward 1e-4 abs (f32 matmuls summed in
another order); losses 1e-5 relative; after 3 AdamW steps each tensor's
update within 1e-3 of its norm (`test_torch_train_slice.py`'s bar: Adam's
step is about lr * g / |g|, so an element whose gradient is at rounding
level moves by another fraction of lr; the key part of the fused QKV bias,
whose gradient is zero in exact arithmetic, moves at most lr a step in
both); `generate`'s greedy tokens bit for bit and its scores 1e-4 abs; the
weights' round trip bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.models import build_train_step as jax_build_train_step
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, build_train_step
from paddle_tpu_torch.models.gpt import GPTAttention
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import (gpt_state_from_numpy,
                                      gpt_state_to_numpy, load_gpt_state)
from torch_parity import jax_state

TINY = dict(vocab=256, hidden=256, layers=2, heads=2, seq=256)
BATCH, SEQ = 2, 256


@pytest.fixture
def flash_training(monkeypatch):
    monkeypatch.setattr(jfa, "_PALLAS_BWD_MIN_SEQ", 128)


def gpt_pair(seed=0, tie=True, recompute=False, chunks=0, random_biases=True,
             **tiny):
    """(JAX model, port model) of one tiny config on identical weights;
    with `random_biases` every bias and LayerNorm parameter is moved off
    its initial value, so that each one matters."""
    paddle.seed(seed)
    cfg_kw = dict(TINY, **tiny)
    jcfg = JaxGPTConfig.tiny(**cfg_kw)
    tcfg = GPTConfig.tiny(**cfg_kw)
    for c in (jcfg, tcfg):
        c.tie_word_embeddings = tie
        c.use_recompute = recompute
        c.fused_ce_chunks = chunks
    jm = JaxGPT(jcfg)
    state = jax_state(jm)
    if random_biases:
        rng = np.random.RandomState(seed + 100)
        state = {n: (a + 0.05 * rng.randn(*a.shape).astype(np.float32)
                     if n.endswith("bias") or ".ln_" in n else a)
                 for n, a in state.items()}
        jm.set_state_dict({n: paddle.to_tensor(a) for n, a in state.items()})
    tm = GPTForCausalLM(tcfg, device="cpu")
    load_gpt_state(tm, state)
    return jm, tm


def _ids(seed, b=BATCH, s=SEQ, vocab=TINY["vocab"]):
    return np.random.RandomState(seed).randint(0, vocab, (b, s))


def _np(t):
    return np.asarray(t._data)


# ---------------------------------------------------------------------------
# configuration, weights, layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["gpt2_small", "gpt3_1p3b", "tiny"])
def test_config_presets_match_the_reference(preset):
    want, got = getattr(JaxGPTConfig, preset)(), getattr(GPTConfig, preset)()
    for field in want.__dataclass_fields__:
        assert getattr(got, field) == getattr(want, field), field
    assert set(got.__dataclass_fields__) == set(want.__dataclass_fields__)
    assert tmodels.GPTConfig is GPTConfig
    assert tmodels.GPTForCausalLM is GPTForCausalLM


@pytest.mark.parametrize("tie", [True, False])
def test_weights_round_trip_and_refuse_a_mismatch(tie):
    jm, tm = gpt_pair(1, tie=tie)
    want = jax_state(jm)
    got = gpt_state_to_numpy(tm)
    assert sorted(got) == sorted(want)
    for n, a in want.items():
        np.testing.assert_array_equal(got[n], a)
    assert ("lm_head.weight" in got) == (not tie)
    assert all(n.startswith("gpt.") or n == "lm_head.weight" for n in got)
    with pytest.raises(KeyError, match="missing"):
        gpt_state_from_numpy({n: a for n, a in got.items()
                              if n != "gpt.ln_f.bias"}, tm.config,
                             device="cpu")
    bad = dict(got)
    bad["gpt.layers.0.attn.qkv_proj.bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="qkv_proj.bias"):
        gpt_state_from_numpy(bad, tm.config, device="cpu")
    # a tied model has 2 + 12 L + 2 parameter tensors
    n_params = len(list(tm.parameters()))
    assert n_params == 4 + 12 * TINY["layers"] + (0 if tie else 1)


def test_qkv_columns_are_head_major():
    """Distinct q, k and v weights: the port reads the fused projection as
    [heads, 3, d] columns, as the reference does; a [3, heads] split of the
    same weights computes something else."""
    jm, tm = gpt_pair(2, hidden=256, heads=4, seq=64)
    tm.eval()
    jm.eval()
    x = _ids(3, b=1, s=32)
    want = _np(jm(paddle.to_tensor(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    attn = tm.gpt.layers[0].attn
    h = torch.randn(1, 5, 256, generator=torch.Generator().manual_seed(0))
    q, k, v = attn._qkv(h)
    qkv = attn.qkv_proj(h).reshape(1, 5, 4, 3, 64)
    assert torch.equal(q, qkv[..., 0, :]) and torch.equal(v, qkv[..., 2, :])
    wrong = attn.qkv_proj(h).reshape(1, 5, 3, 4, 64)
    assert not torch.allclose(q, wrong[:, :, 0], atol=1e-3)
    # the whole model with the other split differs from the reference
    real = GPTAttention._qkv

    def three_heads(self, hs):
        b, s = hs.shape[:2]
        t = self.qkv_proj(hs).reshape(b, s, 3, self.num_heads,
                                      self.head_dim)
        return t[:, :, 0], t[:, :, 1], t[:, :, 2]

    GPTAttention._qkv = three_heads
    try:
        other = tm(torch.from_numpy(x)).detach().numpy()
    finally:
        GPTAttention._qkv = real
    assert np.abs(other - want).max() > 1e-2


# ---------------------------------------------------------------------------
# forward, forward_cached, positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tie", [True, False])
def test_logits_match_the_reference(tie):
    jm, tm = gpt_pair(4, tie=tie)
    jm.eval()
    tm.eval()
    x = _ids(4)
    want = _np(jm(paddle.to_tensor(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the pipeline decomposition composes to the same forward
    h = tm.pp_embed(torch.from_numpy(x))
    for layer in tm.pp_layers():
        h = layer(h)
    np.testing.assert_allclose(tm.pp_head(h).detach().numpy(), got,
                               rtol=0, atol=1e-5)


def test_padding_mask_logits_match_the_reference():
    jm, tm = gpt_pair(5, seq=64)
    jm.eval()
    tm.eval()
    x = _ids(5, s=48)
    mask = np.ones((BATCH, 1, 1, 48), bool)
    mask[1, ..., 40:] = False
    want = _np(jm(paddle.to_tensor(x), paddle.to_tensor(mask)))
    got = tm(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_forward_cached_matches_the_full_forward_and_the_reference():
    jm, tm = gpt_pair(6, seq=64)
    jm.eval()
    tm.eval()
    x = _ids(6, s=12)
    full = tm(torch.from_numpy(x)).detach().numpy()
    jc, tc = jm.init_kv_caches(BATCH, 16), tm.init_kv_caches(BATCH, 16)
    assert tc[0][0].shape == (BATCH, 16, 2, 128)
    assert tc[0][0].dtype == torch.float32
    jl, jc = jm.forward_cached(paddle.to_tensor(x[:, :8]), jc, 0)
    with torch.no_grad():
        tl, tc = tm.forward_cached(torch.from_numpy(x[:, :8]), tc, 0)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), full[:, :8], rtol=0, atol=1e-4)
    for t in range(8, 12):
        jl, jc = jm.forward_cached(paddle.to_tensor(x[:, t:t + 1]), jc, t)
        with torch.no_grad():
            tl, tc = tm.forward_cached(torch.from_numpy(x[:, t:t + 1]), tc,
                                       t)
        np.testing.assert_allclose(tl.numpy()[:, 0], _np(jl)[:, 0], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(tl.numpy()[:, 0], full[:, t], rtol=0,
                                   atol=1e-4)


def test_position_overflow_raises_as_the_reference():
    jm, tm = gpt_pair(7, seq=16)
    x = _ids(7, s=17, vocab=256)
    for model, ids in ((jm, paddle.to_tensor(x)), (tm, torch.from_numpy(x))):
        with pytest.raises(ValueError, match="exceeds max_position"):
            model(ids)
        with pytest.raises(ValueError, match="position 18 exceeds"):
            model.forward_cached(ids[:, :4], model.init_kv_caches(2, 32), 14)
    # a tensor offset (a traced one in the reference) clamps to the last row
    tm.eval()
    with torch.no_grad():
        a, _ = tm.forward_cached(torch.from_numpy(x[:, :1]),
                                 tm.init_kv_caches(2, 40), torch.tensor(30))
        emb = tm.gpt._embed(torch.from_numpy(x[:, :1]), torch.tensor(30))
        last = tm.gpt._embed(torch.from_numpy(x[:, :1]), 15)
    assert torch.equal(emb, last) and torch.isfinite(a).all()


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "eos", "past_positions"])
def test_generate_greedy_matches_the_reference(case):
    jm, tm = gpt_pair(8, seq=32, hidden=128, heads=1, random_biases=False)
    jm.eval()
    tm.eval()
    prompt = _ids(8, s=5, vocab=256)
    new = 30 if case == "past_positions" else 12  # 35 > 32 positions
    kw = dict(max_new_tokens=new, decode_strategy="greedy_search")
    if case == "eos":
        first = _np(jm.generate(paddle.to_tensor(prompt), **kw)[0])
        kw.update(eos_token_id=int(first[0, 3]), pad_token_id=7)
    jt, js = jm.generate(paddle.to_tensor(prompt), **kw)
    tt, ts = tm.generate(torch.from_numpy(prompt), **kw)
    assert tt.dtype == torch.int64 and tuple(tt.shape) == (BATCH, new)
    if case == "past_positions":
        # token i comes from the forward at position 4 + i: from position
        # 32 on, the reference's gather fills the position embedding with
        # NaN (token 0, a NaN score), the port's clamps to the last row
        np.testing.assert_array_equal(tt.numpy()[:, :28], _np(jt)[:, :28])
        assert np.isnan(_np(js)).all() and (_np(jt)[:, 28:] == 0).all()
        assert torch.isfinite(ts).all()
        return
    np.testing.assert_array_equal(tt.numpy(), _np(jt))
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=0, atol=1e-4)
    if case == "eos":
        assert (tt.numpy() == 7).any()


def test_generate_sampling_draws_from_its_seed():
    _, tm = gpt_pair(9, seq=32, hidden=128, heads=1)
    tm.eval()
    prompt = _ids(9, s=4, vocab=256)
    kw = dict(max_new_tokens=8, decode_strategy="sampling", top_k=5,
              top_p=0.9, temperature=0.8)
    a, sa = tm.generate(prompt, seed=3, **kw)
    b, sb = tm.generate(prompt, seed=3, **kw)
    assert torch.equal(a, b) and torch.equal(sa, sb)
    assert ((a >= 0) & (a < 256)).all() and torch.isfinite(sa).all()
    with pytest.raises(ValueError, match=">= 1"):
        tm.generate(prompt, max_new_tokens=0)
    # max_length counts the generated tokens (PaddleNLP), default 20
    assert tm.generate(prompt[0], max_length=3)[0].shape == (1, 3)
    assert tm.generate(prompt[:1])[0].shape == (1, 20)


# ---------------------------------------------------------------------------
# training through build_train_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tie,recompute,chunks", [
    (True, False, 0), (True, True, 0), (False, False, 4), (True, True, 8)])
def test_train_steps_match_the_reference(flash_training, tie, recompute,
                                         chunks):
    """3 AdamW steps (lr 1e-3) on one batch through each package's
    build_train_step: losses, then every parameter's update."""
    jm, tm = gpt_pair(10, tie=tie, recompute=recompute, chunks=chunks)
    x, y = _ids(10), _ids(11)
    before = gpt_state_to_numpy(tm)  # copies
    jstep = jax_build_train_step(jm, paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()), mesh=None)
    step = build_train_step(tm, AdamW(learning_rate=1e-3,
                                      parameters=tm.parameters()))
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = [float(jstep(jx, jy)) for _ in range(3)]
    got = [step(tx, ty).item() for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] < got[0]
    after = jax_state(jm)
    h, d = TINY["hidden"], TINY["hidden"] // TINY["heads"]
    key_cols = (np.arange(3 * h) % (3 * d) // d) == 1
    for n, p in tm.named_parameters():
        d_got = p.detach().numpy() - before[n]
        d_want = after[n] - before[n]
        if n.endswith("qkv_proj.bias"):
            # the key bias's gradient is zero in exact arithmetic (it shifts
            # a query's every logit alike): Adam moves each element by the
            # sign of rounding noise, at most lr a step, in both packages
            for upd in (d_got, d_want):
                assert np.abs(upd[key_cols]).max() <= 3 * 1e-3 * 1.001, n
            d_got, d_want = d_got[~key_cols], d_want[~key_cols]
        err = np.linalg.norm(d_got - d_want)
        assert err <= 1e-3 * max(np.linalg.norm(d_want), 1e-12), (n, err)
