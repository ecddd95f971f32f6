"""The port's `nn/transformer.py` against the JAX package's, on the CPU in
f32, from the JAX layers' weights (carried across by name,
`weights.fused_encoder_state_from_numpy`).

Every class: `MultiHeadAttention` (self and cross attention, `kdim` /
`vdim`, `need_weights`, the incremental `Cache` and the `StaticCache`),
`TransformerEncoderLayer` / `TransformerEncoder` and
`TransformerDecoderLayer` / `TransformerDecoder` (post- and pre-norm, with
and without their caches), `Transformer` and
`generate_square_subsequent_mask`. Each compares in eval (dropout 0.1
would draw other masks than `jax.random`; in training the seeded stream
repeats itself). Tolerance: outputs and caches 2e-5 abs (f32 products
summed in another order); the encoder layer's parameter gradients 1e-4 of
each tensor's largest magnitude (the key bias's, zero in exact arithmetic,
1e-6 abs). At head_dim 128 without a mask the
attention takes the flash kernel's path (its plain version here).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.weights import fused_encoder_state_from_numpy

ATOL = 2e-5
D, HEADS, FF, B = 64, 4, 96, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return np.asarray(t._data)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return paddle.to_tensor(np.asarray(a))


def _carry(jl, tl, rng=None):
    """tl takes jl's weights (random biases and norm scales with `rng`, so
    that every parameter matters); both in eval."""
    state = {n: _np(v) for n, v in jl.state_dict().items()}
    if rng is not None:
        state = {n: (a if n.endswith("proj.weight") or "linear" in n
                     and n.endswith("weight") else
                     a + 0.1 * rng.randn(*a.shape).astype(np.float32))
                 for n, a in state.items()}
        jl.set_state_dict({n: _j(a) for n, a in state.items()})
    assert sorted(state) == sorted(tl.state_dict())
    tl.load_state_dict(fused_encoder_state_from_numpy(state, tl))
    jl.eval()
    tl.eval()
    return jl, tl


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=0,
                               atol=atol)


def _causal(n):
    return np.where(np.tril(np.ones((n, n), bool)), 0.0,
                    -np.inf).astype(np.float32)


def _mha(embed=D, heads=HEADS, **kw):
    paddle.seed(1)
    return _carry(jnn.MultiHeadAttention(embed, heads, **kw),
                  tnn.MultiHeadAttention(embed, heads, device="cpu", **kw),
                  np.random.RandomState(2))


# ---------------------------------------------------------------------------
# MultiHeadAttention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("need_weights", [False, True])
def test_self_attention_matches_the_reference(masked, need_weights):
    jl, tl = _mha(need_weights=need_weights)
    x = np.random.RandomState(3).randn(B, 7, D).astype(np.float32)
    mask = _causal(7) if masked else None
    want = jl(_j(x), attn_mask=None if mask is None else _j(mask))
    got = tl(_t(x), attn_mask=None if mask is None else _t(mask))
    if need_weights:
        assert got[1] is None and want[1] is None
        got, want = got[0], want[0]
    _close(got, want)


def test_cross_attention_with_kdim_vdim_matches_the_reference():
    jl, tl = _mha(kdim=24, vdim=40)
    rng = np.random.RandomState(4)
    q = rng.randn(B, 5, D).astype(np.float32)
    k = rng.randn(B, 9, 24).astype(np.float32)
    v = rng.randn(B, 9, 40).astype(np.float32)
    _close(tl(_t(q), _t(k), _t(v)), jl(_j(q), _j(k), _j(v)))


def test_incremental_cache_matches_the_reference_and_the_full_pass():
    """Tokens fed one at a time through the `Cache` equal the reference's
    steps and the masked full pass."""
    jl, tl = _mha()
    x = np.random.RandomState(5).randn(B, 6, D).astype(np.float32)
    full = tl(_t(x), attn_mask=_t(_causal(6))).detach().numpy()
    jc, tc = jl.gen_cache(_j(x)), tl.gen_cache(_t(x))
    assert isinstance(tc, tnn.MultiHeadAttention.Cache)
    assert tuple(tc.k.shape) == (B, 0, HEADS, D // HEADS)
    for i in range(6):
        jo, jc = jl(_j(x[:, i:i + 1]), cache=jc)
        to, tc = tl(_t(x[:, i:i + 1]), cache=tc)
        _close(to, jo)
        np.testing.assert_allclose(to.detach().numpy()[:, 0], full[:, i],
                                   rtol=0, atol=ATOL)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)


def test_static_cache_matches_the_reference():
    jl, tl = _mha()
    rng = np.random.RandomState(6)
    q = rng.randn(B, 3, D).astype(np.float32)
    mem = rng.randn(B, 8, D).astype(np.float32)
    typ_j, typ_t = jnn.MultiHeadAttention.StaticCache, \
        tnn.MultiHeadAttention.StaticCache
    jc = jl.gen_cache(_j(mem), _j(mem), typ_j)
    tc = tl.gen_cache(_t(mem), _t(mem), typ_t)
    assert isinstance(tc, typ_t)
    _close(tc.k, jc.k)
    got = tl(_t(q), _t(mem), _t(mem), cache=tc)
    assert torch.is_tensor(got)  # a static cache returns out alone
    _close(got, jl(_j(q), _j(mem), _j(mem), cache=jc))


def test_attention_reaches_the_flash_path_at_head_dim_128(monkeypatch):
    calls = []
    real = tfa.flash_attention_bshd
    monkeypatch.setattr(tfa, "flash_attention_bshd",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    jl, tl = _mha(embed=256, heads=2)
    x = np.random.RandomState(7).randn(1, 128, 256).astype(np.float32)
    _close(tl(_t(x)), jl(_j(x)))
    assert len(calls) == 1 and not calls[0]["causal"]
    tl(_t(x), attn_mask=_t(_causal(128)))
    assert len(calls) == 1  # a mask takes the dense path


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _encoder_layer(pre, seed=8):
    paddle.seed(seed)
    kw = dict(dropout=0.1, normalize_before=pre)
    return _carry(jnn.TransformerEncoderLayer(D, HEADS, FF, **kw),
                  tnn.TransformerEncoderLayer(D, HEADS, FF, device="cpu",
                                              **kw),
                  np.random.RandomState(seed))


@pytest.mark.parametrize("pre", [False, True])
def test_encoder_layer_matches_the_reference(pre):
    jl, tl = _encoder_layer(pre)
    rng = np.random.RandomState(9)
    x = rng.randn(B, 7, D).astype(np.float32)
    g = rng.randn(B, 7, D).astype(np.float32)
    jo = jl(_j(x), _j(_causal(7)))
    to = tl(_t(x), _t(_causal(7)))
    _close(to, jo)
    (jo * _j(g)).sum().backward()
    (to * _t(g)).sum().backward()
    jgrads = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        want = _np(jgrads[name].grad)
        err = np.abs(p.grad.numpy() - want).max()
        if name == "self_attn.k_proj.bias":
            # zero in exact arithmetic (it shifts a query's every logit by
            # q . b): both read rounding noise
            assert err <= 1e-6, name
            continue
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-30), name


@pytest.mark.parametrize("pre", [False, True])
def test_encoder_with_caches_matches_the_reference(pre):
    jl, tl = _encoder_layer(pre)
    norm = (jnn.LayerNorm(D), tnn.LayerNorm(D)) if pre else (None, None)
    jenc = jnn.TransformerEncoder(jl, 3, norm[0])
    tenc = tnn.TransformerEncoder(tl, 3, norm[1])
    _carry(jenc, tenc, np.random.RandomState(10))
    x = np.random.RandomState(11).randn(B, 5, D).astype(np.float32)
    _close(tenc(_t(x)), jenc(_j(x)))
    jc, tc = jenc.gen_cache(_j(x)), tenc.gen_cache(_t(x))
    assert len(tc) == 3
    jo, jc = jenc(_j(x), None, jc)
    to, tc = tenc(_t(x), None, tc)
    _close(to, jo)
    for a, b in zip(tc, jc):
        _close(a.k, b.k)
        _close(a.v, b.v)


# ---------------------------------------------------------------------------
# decoder and Transformer
# ---------------------------------------------------------------------------


def _decoder(pre, layers=2, seed=12):
    paddle.seed(seed)
    kw = dict(dropout=0.1, normalize_before=pre)
    norm = (jnn.LayerNorm(D), tnn.LayerNorm(D)) if pre else (None, None)
    jd = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
        D, HEADS, FF, **kw), layers, norm[0])
    td = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
        D, HEADS, FF, device="cpu", **kw), layers, norm[1])
    return _carry(jd, td, np.random.RandomState(seed))


@pytest.mark.parametrize("pre", [False, True])
def test_decoder_matches_the_reference(pre):
    jd, td = _decoder(pre)
    rng = np.random.RandomState(13)
    tgt = rng.randn(B, 6, D).astype(np.float32)
    mem = rng.randn(B, 9, D).astype(np.float32)
    _close(td(_t(tgt), _t(mem), _t(_causal(6))),
           jd(_j(tgt), _j(mem), _j(_causal(6))))
    _close(td.layers[0](_t(tgt), _t(mem)), jd.layers[0](_j(tgt), _j(mem)))


@pytest.mark.parametrize("pre", [False, True])
def test_decoder_caches_match_the_reference_and_the_full_pass(pre):
    """One token at a time through the incremental and static caches: the
    reference's steps and the causally masked full pass."""
    jd, td = _decoder(pre)
    rng = np.random.RandomState(14)
    tgt = rng.randn(B, 5, D).astype(np.float32)
    mem = rng.randn(B, 9, D).astype(np.float32)
    full = td(_t(tgt), _t(mem), _t(_causal(5))).detach().numpy()
    jc, tc = jd.gen_cache(_j(mem)), td.gen_cache(_t(mem))
    assert isinstance(tc[0][0], tnn.MultiHeadAttention.Cache)
    assert isinstance(tc[0][1], tnn.MultiHeadAttention.StaticCache)
    for i in range(5):
        jo, jc = jd(_j(tgt[:, i:i + 1]), _j(mem), None, None, jc)
        to, tc = td(_t(tgt[:, i:i + 1]), _t(mem), None, None, tc)
        _close(to, jo)
        np.testing.assert_allclose(to.detach().numpy()[:, 0], full[:, i],
                                   rtol=0, atol=ATOL)
    zipped = td.gen_cache(_t(mem), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2


@pytest.mark.parametrize("pre", [False, True])
def test_transformer_matches_the_reference(pre):
    paddle.seed(15)
    kw = dict(d_model=D, nhead=HEADS, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=FF,
              normalize_before=pre)
    jt, tt = _carry(jnn.Transformer(**kw),
                    tnn.Transformer(device="cpu", **kw),
                    np.random.RandomState(16))
    rng = np.random.RandomState(17)
    src = rng.randn(B, 7, D).astype(np.float32)
    tgt = rng.randn(B, 5, D).astype(np.float32)
    jm = jnn.Transformer.generate_square_subsequent_mask(5)
    tm = tnn.Transformer.generate_square_subsequent_mask(5, device="cpu")
    np.testing.assert_array_equal(tm.numpy(), _np(jm))
    assert tm.dtype == torch.float32
    _close(tt(_t(src), _t(tgt), tgt_mask=tm),
           jt(_j(src), _j(tgt), tgt_mask=jm))


def test_layers_draw_from_the_seeded_stream_and_refuse_attributes():
    ptt.seed(3)
    a = tnn.TransformerEncoderLayer(D, HEADS, FF, device="cpu")
    ptt.seed(3)
    b = tnn.TransformerEncoderLayer(D, HEADS, FF, device="cpu")
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    nobias = tnn.MultiHeadAttention(D, HEADS, bias_attr=False, device="cpu")
    assert nobias.q_proj.bias is None
    assert "q_proj.bias" not in nobias.state_dict()
    with pytest.raises(NotImplementedError):
        tnn.MultiHeadAttention(D, HEADS, weight_attr="w", device="cpu")
    # dropout in training repeats under one seed
    a.train()
    x = torch.from_numpy(np.random.RandomState(1).randn(B, 5, D)
                         .astype(np.float32))
    ptt.seed(4)
    y = a(x)
    ptt.seed(4)
    assert torch.equal(a(x), y)
