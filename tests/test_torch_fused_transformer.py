"""The port's incubate fused encoder layers and the functionals under them
against the JAX package, on the CPU in f32.

- `layer_norm`, `gelu` (exact and tanh) and `relu` against the JAX
  functionals: 1e-5 abs (the same f32 expressions in another order).
- `dropout`: out of training bit for bit with the reference (identity, or
  x * (1 - p) for "downscale_in_infer"); in training the two packages draw
  other bits, so the test holds the contract: kept values scaled per mode,
  the others 0, the mask shared along the axes `axis` leaves out, the keep
  share within 4 standard deviations of 1 - p, the same mask per
  `paddle_tpu_torch.seed`.
- `fused_multi_head_attention`, `fused_feedforward`,
  `FusedMultiHeadAttention`, `FusedFeedForward` and
  `FusedTransformerEncoderLayer`, pre-LN and post-LN, from the JAX layers'
  weights (`weights.fused_encoder_state_from_numpy`), at dropout 0 in
  training mode and in eval: outputs 2e-5 abs, every parameter's gradient
  1e-4 relative to its largest magnitude (measured ~2e-6).
- Attention dropout: with `FLAGS_flash_dropout_kernel` on, SDPA takes the
  flash dropout bodies (their plain versions on the CPU) with a seed from
  the global stream; off, `_sdpa_reference`.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.incubate import nn as jinc
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.incubate import nn as tinc
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.nn import Dropout, LayerNorm
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.weights import (fused_encoder_state_from_numpy,
                                      fused_encoder_state_to_numpy)

ATOL = 1e-5
OUT_ATOL = 2e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread, so that the file does not crowd
    the other test workers; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def dropout_flag():
    set_flags({"FLAGS_flash_dropout_kernel": True})
    yield
    set_flags({"FLAGS_flash_dropout_kernel": False})


def _np(t):
    return np.asarray(t._data)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# functionals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,norm", [((2, 7, 64), [64]),
                                        ((3, 5, 8, 16), [8, 16]),
                                        ((4, 32), 32)])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_the_reference(shape, norm, affine):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    ns = [norm] if isinstance(norm, int) else norm
    w = rng.randn(*ns).astype(np.float32) if affine else None
    b = rng.randn(*ns).astype(np.float32) if affine else None
    want = JF.layer_norm(paddle.to_tensor(x), norm,
                         None if w is None else paddle.to_tensor(w),
                         None if b is None else paddle.to_tensor(b), 1e-5)
    got = TF.layer_norm(torch.from_numpy(x), norm,
                        None if w is None else torch.from_numpy(w),
                        None if b is None else torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)
    layer = LayerNorm(norm, 1e-5)
    if affine:
        layer.load_state_dict({"weight": torch.from_numpy(w),
                               "bias": torch.from_numpy(b)})
        np.testing.assert_allclose(layer(torch.from_numpy(x)).detach()
                                   .numpy(), _np(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name,kw", [("gelu", {}),
                                     ("gelu", {"approximate": True}),
                                     ("relu", {})])
def test_activations_match_the_reference(name, kw):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = getattr(JF, name)(paddle.to_tensor(x), **kw)
    got = getattr(TF, name)(torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_out_of_training_equals_the_reference(mode):
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    want = JF.dropout(paddle.to_tensor(x), 0.3, training=False, mode=mode)
    got = TF.dropout(torch.from_numpy(x), 0.3, training=False, mode=mode)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert torch.equal(TF.dropout(torch.from_numpy(x), 0.0),
                       torch.from_numpy(x))


@pytest.mark.parametrize("mode,scale", [("upscale_in_train", 1 / 0.75),
                                        ("downscale_in_infer", 1.0)])
@pytest.mark.parametrize("axis", [None, 1, [0, 2]])
def test_dropout_in_training_contract(mode, scale, axis):
    p = 0.25
    x = torch.from_numpy(np.random.RandomState(1).rand(64, 48, 32)
                         .astype(np.float32) + 0.5)
    ptt.seed(3)
    y = TF.dropout(x, p, axis=axis, training=True, mode=mode)
    kept = y != 0
    torch.testing.assert_close(y[kept], (x * scale)[kept], rtol=1e-6,
                               atol=0)
    if axis is not None:  # one decision per index along `axis`
        axes = [axis] if isinstance(axis, int) else axis
        other = tuple(i for i in range(3) if i not in axes)
        assert torch.equal(kept.all(dim=other), kept.any(dim=other))
    share = kept.float().mean().item()
    draws = x.numel() if axis is None else int(np.prod(
        [x.shape[i] for i in ([axis] if isinstance(axis, int) else axis)]))
    assert abs(share - (1 - p)) <= 4 * (p * (1 - p) / draws) ** 0.5
    ptt.seed(3)
    assert torch.equal(TF.dropout(x, p, axis=axis, mode=mode), y)
    layer = Dropout(p, axis=axis, mode=mode)
    ptt.seed(3)
    assert torch.equal(layer(x), y)
    layer.eval()
    want = x * (1 - p) if mode == "downscale_in_infer" else x
    assert torch.equal(layer(x), want)


# ---------------------------------------------------------------------------
# the incubate layers
# ---------------------------------------------------------------------------

D, HEADS, FF, S, B = 256, 2, 512, 256, 2


def _layers(kind, pre):
    kw = dict(normalize_before=pre)
    if kind == "attn":
        return (jinc.FusedMultiHeadAttention(D, HEADS, dropout_rate=0.0,
                                             attn_dropout_rate=0.0, **kw),
                tinc.FusedMultiHeadAttention(D, HEADS, dropout_rate=0.0,
                                             attn_dropout_rate=0.0,
                                             device="cpu", **kw))
    if kind == "ffn":
        return (jinc.FusedFeedForward(D, FF, dropout_rate=0.0,
                                      activation="gelu", **kw),
                tinc.FusedFeedForward(D, FF, dropout_rate=0.0,
                                      activation="gelu", device="cpu", **kw))
    return (jinc.FusedTransformerEncoderLayer(D, HEADS, FF, dropout_rate=0.0,
                                              activation="gelu", **kw),
            tinc.FusedTransformerEncoderLayer(D, HEADS, FF, dropout_rate=0.0,
                                              activation="gelu",
                                              device="cpu", **kw))


def _jax_state(layer):
    return {n: _np(v) for n, v in layer.state_dict().items()}


@pytest.mark.parametrize("kind", ["attn", "ffn", "encoder"])
@pytest.mark.parametrize("pre", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_incubate_layers_match_the_reference(monkeypatch, kind, pre,
                                             training):
    # the reference's training attention at 256 tokens through its Pallas
    # flash passes, as the port's through their plain versions
    monkeypatch.setattr(jfa, "_PALLAS_BWD_MIN_SEQ", 128)
    paddle.seed(7)
    jl, tl = _layers(kind, pre)
    # random biases and norm scales, so that every parameter matters
    rng = np.random.RandomState(5)
    state = {n: (a if n.endswith("weight") else
                 a + 0.1 * rng.randn(*a.shape).astype(np.float32))
             for n, a in _jax_state(jl).items()}
    jl.set_state_dict({n: paddle.to_tensor(a) for n, a in state.items()})
    tl.load_state_dict(fused_encoder_state_from_numpy(state, tl))
    for n, a in fused_encoder_state_to_numpy(tl).items():
        np.testing.assert_array_equal(a, state[n])
    jl.train() if training else jl.eval()
    tl.train(training)
    x = rng.randn(B, S, D).astype(np.float32)
    g = rng.randn(B, S, D).astype(np.float32)
    jo = jl(paddle.to_tensor(x))
    (jo * paddle.to_tensor(g)).sum().backward()
    to = tl(torch.from_numpy(x))
    (to * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), _np(jo), rtol=0,
                               atol=OUT_ATOL)
    jgrads = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        jg = jgrads[name].grad
        if jg is None:  # a norm the other arrangement leaves out
            assert p.grad is None, name
            continue
        assert _rel_err(p.grad.numpy(), _np(jg)) <= GRAD_RTOL, name


@pytest.mark.parametrize("pre", [True, False])
def test_fused_functionals_match_the_reference(pre):
    rng = np.random.RandomState(2)
    x = rng.randn(B, 128, D).astype(np.float32)
    qkv_w = (rng.randn(3, HEADS, D // HEADS, D) * 0.05).astype(np.float32)
    qkv_b = (rng.randn(3, HEADS, D // HEADS) * 0.1).astype(np.float32)
    lin_w = (rng.randn(D, D) * 0.05).astype(np.float32)
    w1 = (rng.randn(D, FF) * 0.05).astype(np.float32)
    w2 = (rng.randn(FF, D) * 0.05).astype(np.float32)
    vecs = [rng.randn(D).astype(np.float32) for _ in range(4)]
    j, t = paddle.to_tensor, torch.from_numpy
    want = jinc.fused_multi_head_attention(
        j(x), j(qkv_w), j(lin_w), pre_layer_norm=pre,
        pre_ln_scale=j(vecs[0]), pre_ln_bias=j(vecs[1]),
        ln_scale=j(vecs[2]), ln_bias=j(vecs[3]), qkv_bias=j(qkv_b),
        dropout_rate=0.0, attn_dropout_rate=0.0, training=False)
    got = tinc.fused_multi_head_attention(
        t(x), t(qkv_w), t(lin_w), pre_layer_norm=pre,
        pre_ln_scale=t(vecs[0]), pre_ln_bias=t(vecs[1]),
        ln_scale=t(vecs[2]), ln_bias=t(vecs[3]), qkv_bias=t(qkv_b),
        dropout_rate=0.0, attn_dropout_rate=0.0, training=False)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=OUT_ATOL)
    want = jinc.fused_feedforward(
        j(x), j(w1), j(w2), ln1_scale=j(vecs[0]), ln1_bias=j(vecs[1]),
        ln2_scale=j(vecs[2]), ln2_bias=j(vecs[3]), dropout1_rate=0.0,
        dropout2_rate=0.0, activation="relu", pre_layer_norm=pre)
    got = tinc.fused_feedforward(
        t(x), t(w1), t(w2), ln1_scale=t(vecs[0]), ln1_bias=t(vecs[1]),
        ln2_scale=t(vecs[2]), ln2_bias=t(vecs[3]), dropout1_rate=0.0,
        dropout2_rate=0.0, activation="relu", pre_layer_norm=pre)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=OUT_ATOL)


def test_state_mapping_refuses_a_mismatch():
    _, tl = _layers("attn", True)
    state = fused_encoder_state_to_numpy(tl)
    with pytest.raises(KeyError, match="missing"):
        fused_encoder_state_from_numpy(
            {n: a for n, a in state.items() if n != "qkv_bias"}, tl)
    bad = dict(state, qkv_bias=np.zeros((3, 2), np.float32))
    with pytest.raises(ValueError, match="qkv_bias"):
        fused_encoder_state_from_numpy(bad, tl)


def test_layers_draw_their_weights_from_the_seeded_stream():
    ptt.seed(11)
    a = tinc.FusedTransformerEncoderLayer(D, HEADS, FF, device="cpu")
    ptt.seed(11)
    b = tinc.FusedTransformerEncoderLayer(D, HEADS, FF, device="cpu")
    c = tinc.FusedTransformerEncoderLayer(D, HEADS, FF, device="cpu")
    for (n, p), q, r in zip(a.named_parameters(), b.parameters(),
                            c.parameters()):
        assert torch.equal(p, q), n
        if n.endswith("weight"):
            assert not torch.equal(p, r), n
            fan = sum(p.shape[:2]) if p.dim() == 2 else None
            if fan:  # Xavier normal: std sqrt(2 / (fan_in + fan_out))
                assert abs(p.std().item() / (2 / fan) ** 0.5 - 1) < 0.05


# ---------------------------------------------------------------------------
# attention dropout routing
# ---------------------------------------------------------------------------


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((name, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def test_sdpa_dropout_takes_the_flash_drop_bodies_with_the_flag(
        monkeypatch, dropout_flag):
    calls = []
    _spy(monkeypatch, tfa, "flash_attention_bshd", calls)
    _spy(monkeypatch, tattn, "_sdpa_reference", calls)
    _spy(monkeypatch, tfa, "flash_fwd_ref", calls)
    q = torch.from_numpy(np.random.RandomState(4).randn(2, 128, 2, 128)
                         .astype(np.float32))
    ptt.seed(21)
    out = TF.scaled_dot_product_attention(q, q, q, dropout_p=0.2,
                                          is_causal=True)
    ptt.seed(21)
    seed = trandom.next_seed()
    names = [c[0] for c in calls]
    assert names == ["flash_attention_bshd", "flash_fwd_ref"]
    assert calls[0][1]["dropout"] == 0.2
    assert calls[0][1]["dropout_seed"] == seed
    want = tfa.flash_attention_bshd(q, q, q, causal=True, dropout=0.2,
                                    dropout_seed=seed)
    assert torch.equal(out, want)
    # a mask, or a shape the kernels do not take, goes to the reference
    calls.clear()
    TF.scaled_dot_product_attention(q[:, :100], q[:, :100], q[:, :100],
                                    dropout_p=0.2)
    assert [c[0] for c in calls] == ["_sdpa_reference"]


def test_sdpa_dropout_without_the_flag_takes_the_reference(monkeypatch):
    calls = []
    _spy(monkeypatch, tfa, "flash_attention_bshd", calls)
    _spy(monkeypatch, tattn, "_sdpa_reference", calls)
    q = torch.from_numpy(np.random.RandomState(4).randn(2, 128, 2, 128)
                         .astype(np.float32))
    ptt.seed(21)
    a = TF.scaled_dot_product_attention(q, q, q, dropout_p=0.2)
    assert [c[0] for c in calls] == ["_sdpa_reference"]
    assert calls[0][1]["dropout_p"] == 0.2
    ptt.seed(21)
    assert torch.equal(TF.scaled_dot_product_attention(q, q, q,
                                                       dropout_p=0.2), a)
    # the reference's inverted dropout: kept probabilities / (1 - p)
    full = tattn._sdpa_reference(q, q, q)
    assert not torch.equal(a, full)
    assert abs(a.mean().item() - full.mean().item()) < 0.05


def test_encoder_with_attention_dropout_is_seeded(dropout_flag):
    """attn_dropout_rate > 0, dropout_rate = 0: the attention's seeds come
    from the global stream, so a re-seeded layer repeats itself and one
    attention call is exactly the drop body with the first seed drawn."""
    ptt.seed(4)
    layer = tinc.FusedTransformerEncoderLayer(D, HEADS, FF, dropout_rate=0.0,
                                              attn_dropout_rate=0.1,
                                              normalize_before=True,
                                              device="cpu")
    x = torch.from_numpy(np.random.RandomState(6).randn(B, 128, D)
                         .astype(np.float32))
    ptt.seed(8)
    a = layer(x)
    ptt.seed(8)
    b = layer(x)
    assert torch.equal(a, b)
    layer.eval()
    assert not torch.equal(layer(x), a)


def test_layers_run_on_cuda_unless_asked(monkeypatch):
    """`device=None` resolves to the card; without one the layers raise
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tinc.FusedTransformerEncoderLayer(D, HEADS, FF),
                 lambda: tinc.FusedMultiHeadAttention(D, HEADS),
                 lambda: tinc.FusedFeedForward(D, FF)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
