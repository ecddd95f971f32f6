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
- The layers' `forward` takes the reference's parameters: a positional
  `attn(x, None, None, mask)` masks, `attn(x, mask)` binds the mask to the
  unused `key`, in both packages.
- `FusedMultiTransformer` (head_dim 128, so the causal context forward
  reaches the flash kernel's plain version): the context forward and the
  dense-cache decode at `time_step` against the reference at batch 3 with
  its zero qkv biases (the only batch at which the reference runs: its
  bias add broadcasts against the batch axis), 2e-5 abs; with random
  biases, against a stack of the reference's `fused_multi_head_attention`
  and `fused_feedforward` (pre-LN, an explicit causal mask), 2e-5 abs;
  each decode step's rows against the port's own context forward over the
  longer sequence, 2e-5 abs; bf16 weights over the f32 `gen_cache` raise
  the reference's TypeError in both packages.
- `FusedBiasDropoutResidualLayerNorm` and every function of
  `incubate/nn/functional.py` and `fused_linear.py` against the
  reference's, 1e-5 abs (the MoE's three products 2e-5); dropout in
  training by its contract, as `dropout` above.
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


# ---------------------------------------------------------------------------
# the layers' forward parameters
# ---------------------------------------------------------------------------


def test_positional_key_value_and_mask_bind_as_the_reference():
    paddle.seed(3)
    jl, tl = _layers("attn", True)
    tl.load_state_dict(fused_encoder_state_from_numpy(_jax_state(jl), tl))
    jl.eval()
    tl.eval()
    rng = np.random.RandomState(8)
    x = rng.randn(B, 128, D).astype(np.float32)
    mask = np.tril(np.ones((128, 128), bool))[None, None]
    j, t = paddle.to_tensor, torch.from_numpy
    want = _np(jl(j(x), None, None, j(mask)))
    got = tl(t(x), None, None, t(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL)
    # a mask in second place is the unused key: no mask, in both
    plain = tl(t(x)).detach().numpy()
    np.testing.assert_allclose(_np(jl(j(x), j(mask))), _np(jl(j(x))),
                               rtol=0, atol=0)
    assert np.array_equal(tl(t(x), t(mask)).detach().numpy(), plain)
    assert not np.allclose(got, plain, atol=1e-3)
    _, tf = _layers("ffn", True)
    _, te = _layers("encoder", True)
    tf.eval()
    te.eval()
    assert torch.equal(tf(t(x), cache="unused"), tf(t(x)))
    assert torch.equal(te(t(x), None, "unused"), te(t(x)))


# ---------------------------------------------------------------------------
# FusedMultiTransformer
# ---------------------------------------------------------------------------

MT_LAYERS = 2


def _mt_pair(biases, seed=9):
    """(JAX, port) FusedMultiTransformer (D, HEADS, FF, MT_LAYERS layers) on
    the same weights: the reference's zero biases, or random ones."""
    paddle.seed(seed)
    jm = jinc.FusedMultiTransformer(D, HEADS, FF, num_layers=MT_LAYERS)
    tm = tinc.FusedMultiTransformer(D, HEADS, FF, num_layers=MT_LAYERS,
                                    device="cpu")
    rng = np.random.RandomState(seed)
    state = _jax_state(jm)
    if biases:
        state = {n: (a + 0.1 * rng.randn(*a.shape).astype(np.float32)
                     if "bias" in n or "scale" in n else a)
                 for n, a in state.items()}
        jm.set_state_dict({n: paddle.to_tensor(a) for n, a in state.items()})
    tm.load_state_dict(fused_encoder_state_from_numpy(state, tm))
    for n, a in fused_encoder_state_to_numpy(tm).items():
        np.testing.assert_array_equal(a, state[n])
    jm.eval()
    tm.eval()
    return jm, tm, state


@pytest.mark.parametrize("masked", [False, True])
def test_multi_transformer_context_matches_the_reference(monkeypatch,
                                                         masked):
    """Batch 3, zero qkv biases: the reference's own forward. Without a
    mask each layer attends through the flash kernel's path."""
    calls = []
    _spy(monkeypatch, tfa, "flash_attention_bshd", calls)
    jm, tm, _ = _mt_pair(False)
    rng = np.random.RandomState(1)
    x = rng.randn(3, 128, D).astype(np.float32)
    mask = np.where(np.tril(np.ones((128, 128), bool)), 0.0,
                    -1e9).astype(np.float32)[None, None] if masked else None
    j, t = paddle.to_tensor, torch.from_numpy
    want = _np(jm(j(x), attn_mask=None if mask is None else j(mask)))
    got = tm(t(x), attn_mask=None if mask is None else t(mask))
    assert len(calls) == (0 if masked else MT_LAYERS)
    assert all(kw["causal"] for _, kw in calls)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=OUT_ATOL)


def test_multi_transformer_biases_add_per_q_k_v():
    """Random biases and norms: the port against the reference's fused
    attention and feed-forward functionals, layer by layer."""
    _, tm, st = _mt_pair(True)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 128, D).astype(np.float32)
    j = paddle.to_tensor
    causal = j(np.tril(np.ones((128, 128), bool))[None, None])
    h = j(x)
    for i in range(MT_LAYERS):
        h = jinc.fused_multi_head_attention(
            h, j(st[f"qkv_weights.{i}"]), j(st[f"linear_weights.{i}"]),
            pre_layer_norm=True, pre_ln_scale=j(st[f"ln_scales.{i}"]),
            pre_ln_bias=j(st[f"ln_biases.{i}"]),
            qkv_bias=j(st[f"qkv_biases.{i}"]),
            linear_bias=j(st[f"linear_biases.{i}"]), attn_mask=causal,
            dropout_rate=0.0, attn_dropout_rate=0.0, training=False)
        h = jinc.fused_feedforward(
            h, j(st[f"ffn1_weights.{i}"]), j(st[f"ffn2_weights.{i}"]),
            j(st[f"ffn1_biases.{i}"]), j(st[f"ffn2_biases.{i}"]),
            ln1_scale=j(st[f"ffn_ln_scales.{i}"]),
            ln1_bias=j(st[f"ffn_ln_biases.{i}"]), dropout1_rate=0.0,
            dropout2_rate=0.0, activation="gelu", pre_layer_norm=True,
            training=False)
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, _np(h), rtol=0, atol=OUT_ATOL)


def test_multi_transformer_decode_matches_the_reference_and_its_context():
    """A 100-token prompt into the caches at time_step 0, then 4 decode
    steps: each step equals the reference's and the rows of the port's own
    context forward over the 104 tokens."""
    jm, tm, _ = _mt_pair(False)
    rng = np.random.RandomState(3)
    x = rng.randn(3, 104, D).astype(np.float32)
    j, t = paddle.to_tensor, torch.from_numpy
    jc = jm.gen_cache(3, 128)
    tc = tm.gen_cache(3, 128)
    assert [tuple(c.shape) for c in tc] == [(2, 3, HEADS, 128,
                                             D // HEADS)] * MT_LAYERS
    assert all(c.dtype == torch.float32 for c in tc)
    full = tm(t(x)).detach().numpy()
    jo, jc = jm(j(x[:, :100]), caches=jc, time_step=0)
    to, tc = tm(t(x[:, :100]), caches=tc, time_step=0)
    np.testing.assert_allclose(to.detach().numpy(), _np(jo), rtol=0,
                               atol=OUT_ATOL)
    for step in range(100, 104):
        jo, jc = jm(j(x[:, step:step + 1]), caches=jc, time_step=step)
        to, tc = tm(t(x[:, step:step + 1]), caches=tc, time_step=step)
        got = to.detach().numpy()[:, 0]
        np.testing.assert_allclose(got, _np(jo)[:, 0], rtol=0,
                                   atol=OUT_ATOL)
        np.testing.assert_allclose(got, full[:, step], rtol=0,
                                   atol=OUT_ATOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.detach().numpy(), _np(b), rtol=0,
                                   atol=1e-5)


def test_multi_transformer_refuses_what_the_reference_refuses():
    jm, tm, _ = _mt_pair(False)
    jm.to(dtype="bfloat16")
    tm.to(torch.bfloat16)
    x = np.random.RandomState(4).randn(3, 4, D).astype(np.float32)
    with pytest.raises(TypeError, match="same dtypes"):
        jm(paddle.to_tensor(x).astype("bfloat16"), caches=jm.gen_cache(3, 8),
           time_step=0)
    with pytest.raises(TypeError, match="same dtypes"):
        tm(torch.from_numpy(x).bfloat16(), caches=tm.gen_cache(3, 8),
           time_step=0)
    out, caches = tm(torch.from_numpy(x).bfloat16(),
                     caches=[c.bfloat16() for c in tm.gen_cache(3, 8)],
                     time_step=0)
    assert out.dtype == caches[0].dtype == torch.bfloat16
    with pytest.raises(AssertionError, match="pre-norm"):
        tinc.FusedMultiTransformer(D, HEADS, FF, normalize_before=False,
                                   device="cpu")
    with pytest.raises(NotImplementedError):
        tinc.FusedMultiTransformer(D, HEADS, FF, nranks=2, device="cpu")
    counted = tinc.FusedMultiTransformer(D, HEADS, FF, device="cpu",
                                         qkv_weight_attrs=[None] * 3)
    assert counted.num_layers == 3 and len(counted.qkv_weights) == 3


# ---------------------------------------------------------------------------
# FusedBiasDropoutResidualLayerNorm, incubate/nn/functional.py and
# fused_linear.py
# ---------------------------------------------------------------------------


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("parts", ["all", "no_bias", "no_ln"])
def test_bias_dropout_residual_layer_norm_matches_the_reference(parts):
    x, r, b, sc, lb = _arrays(5, (2, 6, 32), (2, 6, 32), (32,), (32,), (32,))
    kw = dict(bias=None if parts == "no_bias" else b,
              ln_scale=None if parts == "no_ln" else sc,
              ln_bias=None if parts == "no_ln" else lb)
    jf = jinc.functional.fused_bias_dropout_residual_layer_norm
    tf = tinc.functional.fused_bias_dropout_residual_layer_norm
    want = jf(paddle.to_tensor(x), paddle.to_tensor(r),
              **{k: None if v is None else paddle.to_tensor(v)
                 for k, v in kw.items()}, dropout_rate=0.3, training=False)
    got = tf(torch.from_numpy(x), torch.from_numpy(r),
             **{k: None if v is None else torch.from_numpy(v)
                for k, v in kw.items()}, dropout_rate=0.3, training=False)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)


def test_bias_dropout_residual_layer_norm_layer_matches_the_reference():
    x, r = _arrays(6, (2, 6, 32), (2, 6, 32))
    jl = jinc.FusedBiasDropoutResidualLayerNorm(32, dropout_rate=0.0)
    tl = tinc.FusedBiasDropoutResidualLayerNorm(32, dropout_rate=0.0,
                                                device="cpu")
    state = {n: a + 0.1 * np.random.RandomState(1).randn(*a.shape)
             .astype(np.float32) for n, a in _jax_state(jl).items()}
    jl.set_state_dict({n: paddle.to_tensor(a) for n, a in state.items()})
    tl.load_state_dict(fused_encoder_state_from_numpy(state, tl))
    want = _np(jl(paddle.to_tensor(x), paddle.to_tensor(r)))
    got = tl(torch.from_numpy(x), torch.from_numpy(r))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)
    # in training at rate 0.5: the residual plus kept (x + bias) * 2 or 0
    tl.dropout_rate = 0.5
    ptt.seed(2)
    a = tl(torch.from_numpy(x), torch.from_numpy(r))
    ptt.seed(2)
    assert torch.equal(tl(torch.from_numpy(x), torch.from_numpy(r)), a)


@pytest.mark.parametrize("sq,sk", [(6, 6), (4, 7), (7, 4)])
def test_softmax_mask_fuse_upper_triangle_matches_the_reference(sq, sk):
    x, = _arrays(7, (2, 3, sq, sk))
    want = jinc.functional.softmax_mask_fuse_upper_triangle(
        paddle.to_tensor(x))
    got = tinc.functional.softmax_mask_fuse_upper_triangle(
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match=r"\[b, h, sq, sk\]"):
        tinc.functional.softmax_mask_fuse_upper_triangle(
            torch.from_numpy(x[0]))


def test_fused_dropout_add_matches_the_reference():
    x, y = _arrays(8, (4, 64), (4, 64))
    for mode in ("upscale_in_train", "downscale_in_infer"):
        want = jinc.functional.fused_dropout_add(
            paddle.to_tensor(x), paddle.to_tensor(y), p=0.25,
            training=False, mode=mode)
        got = tinc.functional.fused_dropout_add(
            torch.from_numpy(x), torch.from_numpy(y), p=0.25,
            training=False, mode=mode)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)
    layer = tinc.FusedDropoutAdd(p=0.25)
    ptt.seed(5)
    out = layer(torch.from_numpy(x), torch.from_numpy(y)).numpy() - y
    kept = out != 0
    # (x / 0.75 + y) - y: one f32 rounding of the sum
    np.testing.assert_allclose(out[kept], x[kept] / 0.75, rtol=0, atol=1e-6)
    assert abs(kept.mean() - 0.75) <= 4 * (0.25 * 0.75 / x.size) ** 0.5
    layer.eval()
    assert torch.equal(layer(torch.from_numpy(x), torch.from_numpy(y)),
                       torch.from_numpy(x) + torch.from_numpy(y))


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("extras", ["none", "bias_residual", "norm_bias"])
def test_fused_norms_match_the_reference(kind, axis, extras):
    x, b, r = _arrays(9, (2, 3, 16), (16,), (2, 3, 16))
    w, nb = _arrays(10, (3, 16) if axis == 1 else (16,),
                    (3, 16) if axis == 1 else (16,))
    kw = dict(begin_norm_axis=axis)
    if extras == "bias_residual":
        kw.update(bias=b, residual=r)
    if extras == "norm_bias":
        kw.update(norm_bias=nb)
    name = f"fused_{kind}_norm"
    want = getattr(jinc.functional, name)(
        paddle.to_tensor(x), paddle.to_tensor(w),
        **{k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    got = getattr(tinc.functional, name)(
        torch.from_numpy(x), torch.from_numpy(w),
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    assert len(got) == 2
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(wnt), rtol=0, atol=ATOL)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_ec_moe_matches_the_reference(act):
    e, d, f = 3, 16, 24
    x, g, w0, b0, w1, b1 = _arrays(11, (2, 5, d), (2, 5, e), (e, d, f),
                                   (e, 1, f), (e, f, d), (e, 1, d))
    j, t = paddle.to_tensor, torch.from_numpy
    want = jinc.functional.fused_ec_moe(j(x), j(g), j(w0), j(b0), j(w1),
                                        j(b1), act_type=act)
    got = tinc.functional.fused_ec_moe(t(x), t(g), t(w0), t(b0), t(w1),
                                       t(b1), act_type=act)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="gelu or relu"):
        tinc.functional.fused_ec_moe(t(x), t(g), t(w0), t(b0), t(w1), t(b1),
                                     act_type="silu")
    jl = jinc.FusedEcMoe(d, f, e, act_type=act)
    tl = tinc.FusedEcMoe(d, f, e, act_type=act, device="cpu")
    tl.load_state_dict(fused_encoder_state_from_numpy(_jax_state(jl), tl))
    np.testing.assert_allclose(tl(t(x), t(g)).detach().numpy(),
                               _np(jl(j(x), j(g))), rtol=0, atol=2e-5)


@pytest.mark.parametrize("tx,ty", [(False, False), (True, False),
                                   (False, True)])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_matmul_bias_and_linear_match_the_reference(tx, ty, bias):
    x, y, b = _arrays(12, (3, 8, 16) if tx else (3, 16, 8),
                      (24, 8) if ty else (8, 24), (24,))
    j, t = paddle.to_tensor, torch.from_numpy
    jb, tb = (j(b), t(b)) if bias else (None, None)
    want = jinc.functional.fused_matmul_bias(j(x), j(y), jb, tx, ty)
    got = tinc.functional.fused_matmul_bias(t(x), t(y), tb, tx, ty)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)
    if not tx:
        want = jinc.functional.fused_linear(j(x), j(y), jb,
                                            transpose_weight=ty)
        got = tinc.functional.fused_linear(t(x), t(y), tb,
                                           transpose_weight=ty)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                   atol=ATOL)
        from paddle_tpu.incubate.nn.fused_linear import \
            fused_linear_activation as jact
        from paddle_tpu_torch.incubate.nn.fused_linear import \
            fused_linear_activation as tact
        for act in ("gelu", "relu"):
            want = jact(j(x), j(y), jb, trans_y=ty, activation=act)
            got = tact(t(x), t(y), tb, trans_y=ty, activation=act)
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                       atol=ATOL)


def test_fused_linear_layer_matches_the_reference():
    x, = _arrays(13, (2, 5, 16))
    for bias_attr in (None, False):
        jl = jinc.FusedLinear(16, 24, bias_attr=bias_attr)
        tl = tinc.FusedLinear(16, 24, bias_attr=bias_attr, device="cpu")
        state = _jax_state(jl)
        assert sorted(state) == sorted(tl.state_dict())
        tl.load_state_dict(fused_encoder_state_from_numpy(state, tl))
        np.testing.assert_allclose(
            tl(torch.from_numpy(x)).detach().numpy(),
            _np(jl(paddle.to_tensor(x))), rtol=0, atol=ATOL)
