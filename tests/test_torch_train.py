"""The port's training path against the JAX package, on the CPU in f32.

The tiny LLaMA here (vocab 256, hidden 256, 2 heads of 128 over 1 KV head,
2 layers; batch 2 x seq 256) has the flash kernels' head_dim, so the port
trains through the flash and RMSNorm autograd functions (their plain
versions on the CPU). The reference takes its Pallas flash kernels in
training only from seq 4096 (`_PALLAS_BWD_MIN_SEQ`); the fixture lowers
that to 128, as the flag's documentation says tests do, so both packages
run the same algorithm.

Tolerances: logits 1e-4 abs (two layers of f32 matmuls summed in another
order); gradients 1e-4 relative to each tensor's largest magnitude; the loss
of each of 8 steps 1e-5 relative; three Adam or AdamW updates 1e-6 abs in
f32 and identical bits in bf16 (the same f32 arithmetic on the same
values).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.layers.mpu import \
    ParallelCrossEntropy as JaxParallelCrossEntropy
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.models import build_train_step as jax_build_train_step
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import Adam as JaxAdam
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import amp
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import rms_norm as trms
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     build_train_step)
from paddle_tpu_torch.nn import ParallelCrossEntropy
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.weights import llama_state_to_numpy, load_llama_state
from torch_parity import jax_state

TRAIN = dict(vocab=256, hidden=256, layers=2, heads=2, seq=256)
KV_HEADS = 1
BATCH, SEQ = 2, 256


@pytest.fixture
def flash_training(monkeypatch):
    monkeypatch.setattr(jfa, "_PALLAS_BWD_MIN_SEQ", 128)


def _pair(seed):
    paddle.seed(seed)
    jcfg = JaxLlamaConfig.tiny(**TRAIN)
    jcfg.num_key_value_heads = KV_HEADS
    jm = JaxLlama(jcfg)
    tcfg = LlamaConfig.tiny(**TRAIN)
    tcfg.num_key_value_heads = KV_HEADS
    tm = LlamaForCausalLM(tcfg, device="cpu")
    load_llama_state(tm, jax_state(jm))
    return jm, tm


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, TRAIN["vocab"], (BATCH, SEQ)),
            rng.randint(0, TRAIN["vocab"], (BATCH, SEQ)))


# ---------------------------------------------------------------------------
# optimizer, loss, amp, weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("decoupled,dtype,multi_precision", [
    (True, "float32", False), (True, "bfloat16", False),
    (True, "bfloat16", True), (False, "float32", False)])
def test_adam_updates_match_reference(decoupled, dtype, multi_precision):
    """Three updates (weight decay 0.1: decoupled for AdamW, L2 on the
    gradient for Adam; lr 0.01) of one parameter: parameter, f32 moments,
    beta pows and master weight as the reference's `_update_param` leaves
    them."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(64, 32).astype(np.float32)
    grads = [rng.randn(64, 32).astype(np.float32) for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jcls, tcls = (JaxAdamW, AdamW) if decoupled else (JaxAdam, Adam)
    jopt = jcls(learning_rate=0.01, parameters=[], weight_decay=0.1,
                multi_precision=multi_precision)
    jp = jnp.asarray(p0, jdt)
    state = jopt._init_state(types.SimpleNamespace(_data=jp))
    for g in grads:
        jp, state = jopt._update_param(jp, jnp.asarray(g, jdt), state, 0.01)
    tp = torch.nn.Parameter(torch.from_numpy(p0).to(tdt))
    opt = tcls(learning_rate=0.01, parameters=[tp], weight_decay=0.1,
               multi_precision=multi_precision)
    for g in grads:
        tp.grad = torch.from_numpy(g).to(tdt)
        opt.step()
    assert tp.dtype == tdt
    st = opt.state_dict()
    assert st["step"] == 3
    atol = 1e-6 if dtype == "float32" else 0.0
    np.testing.assert_allclose(tp.detach().float().numpy(),
                               np.asarray(jp, np.float32), rtol=0, atol=atol)
    for name in ("moment1", "moment2") + (("master_weight",)
                                           if multi_precision else ()):
        assert st[f"0_{name}"].dtype == torch.float32
        np.testing.assert_allclose(st[f"0_{name}"].numpy(),
                                   np.asarray(state[name]), rtol=0,
                                   atol=1e-6)
    for name in ("beta1_pow", "beta2_pow"):
        assert st[f"0_{name}"] == np.float32(state[name])


@pytest.mark.parametrize("multi_precision", [False, True])
def test_adamw_resumes_from_the_reference_state_dict(multi_precision):
    """The reference's AdamW state after 3 steps on a Linear's (unnamed)
    parameters, as numpy arrays, into the port's `set_state_dict`; then 2
    more steps on each side from the same parameters and gradients agree
    within the update tolerance above (1e-6 abs in f32)."""
    rng = np.random.RandomState(3)
    w0 = rng.randn(16, 8).astype(np.float32)
    b0 = rng.randn(8).astype(np.float32)
    grads = [(rng.randn(16, 8).astype(np.float32),
              rng.randn(8).astype(np.float32)) for _ in range(5)]
    lin = paddle.nn.Linear(16, 8)
    jps = lin.parameters()
    assert [p.name for p in jps] == ["", ""]  # keyed by position
    jps[0].set_value(w0)
    jps[1].set_value(b0)
    jopt = JaxAdamW(learning_rate=0.01, parameters=jps, weight_decay=0.1,
                    multi_precision=multi_precision)

    def jax_step(gs):
        for p, g in zip(jps, gs):
            p.grad = paddle.to_tensor(g)
        jopt.step()

    for gs in grads[:3]:
        jax_step(gs)
    state = {k: v if isinstance(v, int) else np.asarray(v._data)
             for k, v in jopt.state_dict().items()}
    assert state["step"] == 3 and "1_moment2" in state
    tps = [torch.nn.Parameter(torch.from_numpy(p.numpy().copy()))
           for p in jps]
    opt = AdamW(learning_rate=0.01, parameters=tps, weight_decay=0.1,
                multi_precision=multi_precision)
    opt.set_state_dict(state)
    st = opt.state_dict()
    assert st["step"] == 3
    assert st["0_moment1"].dtype == torch.float32
    assert st["1_beta2_pow"] == np.float32(state["1_beta2_pow"])
    for gs in grads[3:]:
        jax_step(gs)
        for p, g in zip(tps, gs):
            p.grad = torch.from_numpy(g)
        opt.step()
    assert opt.state_dict()["step"] == jopt.state_dict()["step"] == 5
    for tp, jp in zip(tps, jps):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), rtol=0,
                                   atol=1e-6)
    want = jopt.state_dict()
    for key, got in opt.state_dict().items():
        if key != "step":
            np.testing.assert_allclose(np.asarray(got, np.float32),
                                       np.asarray(want[key]._data), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_with_ignore_index_matches_reference(reduction):
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 7, 11).astype(np.float32) * 3
    labels = rng.randint(0, 11, (2, 7))
    labels[0, :3] = -100
    want = JF.cross_entropy(paddle.to_tensor(logits),
                            paddle.to_tensor(labels), reduction=reduction)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-6, atol=1e-6)
    if reduction == "none":
        assert not got[0, :3].any()
    with pytest.raises(ValueError):
        TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                         reduction="avg")


def test_parallel_cross_entropy_keeps_a_class_axis():
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 5, 9).astype(np.float32)
    labels = rng.randint(0, 9, (2, 5))
    want = JaxParallelCrossEntropy()(paddle.to_tensor(logits),
                                     paddle.to_tensor(labels))
    got = ParallelCrossEntropy()(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    assert got.shape == (2, 5, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-6, atol=1e-6)


def test_state_to_numpy_round_trips_f32():
    jm, tm = _pair(3)
    state = jax_state(jm)
    back = llama_state_to_numpy(tm)
    assert sorted(back) == sorted(state)
    for name, arr in state.items():
        np.testing.assert_array_equal(back[name], arr)


def test_amp_decorate_o2_casts_parameters_to_bf16():
    cfg = LlamaConfig.tiny(vocab=64, hidden=128, layers=1, heads=1, seq=128)
    model = LlamaForCausalLM(cfg, device="cpu")
    assert amp.decorate(model, level="O2", dtype="bfloat16") is model
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert all(p.requires_grad for p in model.parameters())
    # O1 leaves the parameters as they are and returns the model, as the
    # reference's decorate does
    assert amp.decorate(model, level="O1") is model
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


def test_bf16_train_step_keeps_f32_moments():
    """O2 bf16 parameters, one step through the flash and RMSNorm autograd
    functions: finite loss, parameters stay bf16, moments are f32."""
    cfg = LlamaConfig.tiny(vocab=64, hidden=128, layers=1, heads=1, seq=128)
    model = amp.decorate(LlamaForCausalLM(cfg, device="cpu", seed=1))
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = build_train_step(model, opt)
    ids = torch.randint(0, 64, (1, 128), generator=torch.Generator()
                        .manual_seed(0))
    loss = step(ids, ids)
    assert loss.dtype == torch.bfloat16 and torch.isfinite(loss)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert all(p.grad is None for p in model.parameters())
    assert opt.state_dict()["0_moment1"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the tiny LLaMA
# ---------------------------------------------------------------------------


def test_training_logits_match_reference(flash_training):
    jm, tm = _pair(4)
    x, _ = _batch(4)
    jm.train()
    want = np.asarray(jm(paddle.to_tensor(x))._data)
    counts = (tfa.fwd_launches, trms.launches)
    got = tm(torch.from_numpy(x))
    assert (tfa.fwd_launches, trms.launches) == counts  # the CPU: no kernel
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)


def test_parameter_gradients_match_reference(flash_training):
    jm, tm = _pair(5)
    x, y = _batch(5)
    jm.train()
    jloss = jm.compute_loss(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
    jloss.backward()
    want = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    loss = tm.compute_loss(tm(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        err = np.abs(got[name] - g).max()
        assert err <= 1e-4 * np.abs(g).max(), (name, err)


def test_train_step_loss_curve_matches_reference(flash_training):
    """8 AdamW steps (lr 1e-3) on one repeated batch through each package's
    build_train_step."""
    jm, tm = _pair(6)
    x, y = _batch(6)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    jstep = jax_build_train_step(jm, jopt, mesh=None)
    step = build_train_step(tm, AdamW(learning_rate=1e-3,
                                      parameters=tm.parameters()))
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = [float(jstep(jx, jy)) for _ in range(8)]
    got = [step(tx, ty).item() for _ in range(8)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] < got[0]
    assert all(p.grad is None for p in tm.parameters())
