"""The port's schedulers, optimizers, gradient clipping and GradScaler
against the JAX package's, on the CPU.

Tolerances: learning-rate sequences exact (the same Python arithmetic);
Adam and AdamW bit for bit in bf16 and within 1e-6 abs in f32 (the same f32
operations; XLA may contract a multiply-add on the CPU); every other
optimizer within 1e-6 abs in f32 and bit for bit in bf16 (each operation
rounded to bf16, Python scalars first rounded to bf16, as JAX's weak
typing rounds them); clipped gradients within 1e-6 relative (sums in
another order).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.amp import GradScaler as JaxGradScaler
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30


def _schedulers(mod):
    return {
        "Noam": lambda: mod.NoamDecay(64, 10, learning_rate=2.0),
        "Piecewise": lambda: mod.PiecewiseDecay([5, 12, 20],
                                                [1.0, 0.5, 0.1, 0.01]),
        "NaturalExp": lambda: mod.NaturalExpDecay(0.5, 0.1),
        "InverseTime": lambda: mod.InverseTimeDecay(0.5, 0.2),
        "Polynomial": lambda: mod.PolynomialDecay(0.5, 12, 0.01, 2.0),
        "PolynomialCycle": lambda: mod.PolynomialDecay(0.5, 7, 0.01, 1.0,
                                                       cycle=True),
        "LinearWarmup": lambda: mod.LinearWarmup(0.3, 8, 0.0, 0.3),
        "WarmupCosine": lambda: mod.LinearWarmup(
            mod.CosineAnnealingDecay(0.3, 20, eta_min=0.01), 6, 0.0, 0.3),
        "Exponential": lambda: mod.ExponentialDecay(0.5, 0.9),
        "MultiStep": lambda: mod.MultiStepDecay(0.5, [4, 9, 17], 0.3),
        "Step": lambda: mod.StepDecay(0.5, 7, 0.5),
        "Lambda": lambda: mod.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "Multiplicative": lambda: mod.MultiplicativeDecay(
            0.5, lambda e: 0.9),
        "Cosine": lambda: mod.CosineAnnealingDecay(0.5, 11, eta_min=0.05),
        "CosineRestarts": lambda: mod.CosineAnnealingWarmRestarts(
            0.5, 5, T_mult=2, eta_min=0.01),
        "OneCycle": lambda: mod.OneCycleLR(0.5, 30),
        "OneCycleThree": lambda: mod.OneCycleLR(0.5, 30, three_phase=True,
                                                anneal_strategy="linear"),
        "Cyclic": lambda: mod.CyclicLR(0.01, 0.5, 4, mode="triangular2"),
        "CyclicExp": lambda: mod.CyclicLR(0.01, 0.5, 3, 5, mode="exp_range",
                                          exp_gamma=0.9),
        "Linear": lambda: mod.LinearLR(0.5, 20, start_factor=0.2,
                                       end_factor=1.0),
    }


def _lr_sequence(sched):
    out = [sched()]
    for _ in range(STEPS):
        sched.step()
        out.append(sched())
    return out


@pytest.mark.parametrize("name", sorted(_schedulers(tlr)))
def test_scheduler_sequence_matches_reference(name):
    want = _lr_sequence(_schedulers(jlr)[name]())
    got = _lr_sequence(_schedulers(tlr)[name]())
    assert got == want


def test_reduce_on_plateau_matches_reference():
    metrics = [1.0, 0.9, 0.9, 0.95, 0.91, 0.92, 0.93, 0.5, 0.6, 0.61, 0.62,
               0.7, 0.7, 0.7, 0.7]
    seqs = []
    for mod in (jlr, tlr):
        s = mod.ReduceOnPlateau(0.5, factor=0.5, patience=2, cooldown=1)
        seq = []
        for m in metrics:
            s.step(m)
            seq.append(s())
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert min(seqs[1]) < 0.5


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTS = {
    "SGD": {}, "Momentum": {"momentum": 0.8},
    "MomentumNesterov": {"momentum": 0.8, "use_nesterov": True},
    "Adagrad": {"epsilon": 1e-6, "initial_accumulator_value": 0.1},
    "Adam": {}, "AdamW": {}, "Adamax": {}, "RMSProp": {"momentum": 0.5},
    "RMSPropCentered": {"centered": True}, "Adadelta": {"epsilon": 1e-6},
    "RAdam": {}, "NAdam": {}, "ASGD": {"batch_num": 2}, "Lamb": {},
    "Rprop": {},
}
NO_DECAY = ("Lamb", "Rprop")
ADAM = ("Adam", "AdamW")


def _decay(mod, kind):
    return {"float": 0.01, "L2": mod.L2Decay(0.01),
            "L1": mod.L1Decay(0.01), None: None}[kind]


def _make(mod, name, params, decay, **extra):
    kw = dict(OPTS[name])
    kw.update(extra)
    cls = name.replace("Nesterov", "").replace("Centered", "")
    if decay is not None:
        kw["weight_decay"] = _decay(mod, decay)
    return getattr(mod, cls)(learning_rate=0.01, parameters=params, **kw)


def _cases():
    out = []
    for name in OPTS:
        decays = (None,) if name in NO_DECAY else ("float", "L2", "L1")
        out += [(name, d, dt, False) for d in decays
                for dt in ("float32", "bfloat16")]
        if name in ADAM:
            out.append((name, "float", "bfloat16", True))
    return out


def _jax_params(values, dtype):
    lin = jnn.Linear(*values[0].shape)
    ps = lin.parameters()
    for p, v in zip(ps, values):
        p._rebind(jnp.asarray(v, dtype))
    assert all(p._data.dtype == dtype for p in ps)
    return ps


@pytest.mark.parametrize("name,decay,dtype,multi_precision", _cases())
def test_optimizer_steps_match_reference(name, decay, dtype,
                                         multi_precision):
    """5 steps of eager `step()` on a weight and a bias from the same
    values and gradients."""
    rng = np.random.RandomState(7)
    values = [rng.randn(16, 8).astype(np.float32),
              rng.randn(8).astype(np.float32)]
    grads = [[rng.randn(*v.shape).astype(np.float32) for v in values]
             for _ in range(5)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    extra = {"multi_precision": True} if multi_precision else {}
    jps = _jax_params(values, jdt)
    jopt = _make(paddle.optimizer, name, jps, decay, **extra)
    tps = [torch.nn.Parameter(torch.from_numpy(v).to(tdt)) for v in values]
    opt = _make(topt, name, tps, decay, **extra)
    for gs in grads:
        for jp, tp, g in zip(jps, tps, gs):
            jp.grad = paddle.to_tensor(jnp.asarray(g, jdt))
            tp.grad = torch.from_numpy(g).to(tdt)
        jopt.step()
        opt.step()
    exact = dtype == "bfloat16"
    for jp, tp in zip(jps, tps):
        assert tp.dtype == tdt
        want = np.asarray(jp._data.astype(jnp.float32))
        got = tp.detach().float().numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert opt.state_dict()["step"] == jopt.state_dict()["step"] == 5


def test_lazy_mode_has_no_dense_meaning():
    p = torch.nn.Parameter(torch.zeros(3))
    topt.Adam(parameters=[p], lazy_mode=False, use_multi_tensor=True,
              name="adam")
    with pytest.raises(NotImplementedError):
        topt.Adam(parameters=[p], lazy_mode=True)
    with pytest.raises(NotImplementedError):
        topt.AdamW(parameters=[p], lazy_mode=True)


def test_adamw_decay_fun_and_lr_ratio_as_the_reference():
    """Eager `step()` hands `p.name` to apply_decay_param_fun ('' for an
    unnamed parameter) in both packages; `lr_ratio` is accepted and
    unused."""
    rng = np.random.RandomState(1)
    values = [rng.randn(4, 3).astype(np.float32),
              rng.randn(3).astype(np.float32)]
    seen = {"jax": [], "torch": []}

    def fun(tag):
        def f(name):
            seen[tag].append(name)
            return name != ""
        return f

    jps = _jax_params(values, jnp.float32)
    jopt = paddle.optimizer.AdamW(learning_rate=0.1, parameters=jps,
                                  weight_decay=0.5, lr_ratio=lambda p: 0.1,
                                  apply_decay_param_fun=fun("jax"))
    tps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    opt = topt.AdamW(learning_rate=0.1, parameters=tps, weight_decay=0.5,
                     lr_ratio=lambda p: 0.1,
                     apply_decay_param_fun=fun("torch"))
    for jp, tp, v in zip(jps, tps, values):
        jp.grad = paddle.to_tensor(v * 0.3)
        tp.grad = torch.from_numpy(v * 0.3)
    jopt.step()
    opt.step()
    assert seen["jax"] == seen["torch"] == ["", ""]
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), rtol=0,
                                   atol=1e-6)


def test_optimize_attr_scales_the_learning_rate():
    rng = np.random.RandomState(2)
    values = [rng.randn(4, 3).astype(np.float32),
              rng.randn(3).astype(np.float32)]
    jps = _jax_params(values, jnp.float32)
    tps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    for p in (jps[0], tps[0]):
        p.optimize_attr = {"learning_rate": 0.25}
    jopt = paddle.optimizer.SGD(learning_rate=0.1, parameters=jps)
    opt = topt.SGD(learning_rate=0.1, parameters=tps)
    for jp, tp, v in zip(jps, tps, values):
        jp.grad = paddle.to_tensor(v)
        tp.grad = torch.from_numpy(v.copy())
    jopt.step()
    opt.step()
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), rtol=0,
                                   atol=1e-7)
    np.testing.assert_allclose(tps[0].detach().numpy(),
                               values[0] * (1 - 0.025), rtol=1e-6)


def test_step_skips_frozen_parameters():
    a = torch.nn.Parameter(torch.ones(3))
    b = torch.nn.Parameter(torch.ones(3), requires_grad=False)
    opt = topt.SGD(learning_rate=0.5, parameters=[a, b])
    a.grad = torch.ones(3)
    b.grad = torch.ones(3)
    opt.step()
    assert torch.equal(a, torch.full((3,), 0.5))
    assert torch.equal(b, torch.ones(3))


def test_set_lr_and_the_scheduler_state_round_trip():
    """set_lr sets a float rate and raises under a scheduler; the
    reference's state_dict (its LR_Scheduler entry too) loads into the
    port's optimizer, and the two then step the same rates."""
    p = torch.nn.Parameter(torch.zeros(2))
    opt = topt.SGD(learning_rate=0.1, parameters=[p])
    opt.set_lr(0.3)
    assert opt.get_lr() == 0.3 and "LR_Scheduler" not in opt.state_dict()
    jsched = jlr.LinearWarmup(jlr.CosineAnnealingDecay(0.3, 20), 5, 0.0,
                              0.3)
    jp = _jax_params([np.zeros((2, 2), np.float32),
                      np.zeros(2, np.float32)], jnp.float32)
    jopt = paddle.optimizer.AdamW(learning_rate=jsched, parameters=jp)
    for _ in range(7):
        jsched.step()
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(0.3, 20), 5, 0.0, 0.3)
    opt = topt.AdamW(learning_rate=sched,
                     parameters=[torch.nn.Parameter(torch.zeros(2, 2)),
                                 torch.nn.Parameter(torch.zeros(2))])
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)
    state = jopt.state_dict()
    assert "LR_Scheduler" in state
    opt.set_state_dict(state)
    assert opt.state_dict()["LR_Scheduler"] == state["LR_Scheduler"]
    assert opt.get_lr() == jopt.get_lr()
    for _ in range(5):
        jsched.step()
        sched.step()
        assert opt.get_lr() == jopt.get_lr()


# ---------------------------------------------------------------------------
# clipping
# ---------------------------------------------------------------------------


def _clip_pairs(rng):
    return [rng.randn(6, 5).astype(np.float32) * 3,
            rng.randn(5).astype(np.float32)]


@pytest.mark.parametrize("kind", ["value", "norm", "global", "global_small"])
def test_clip_classes_match_reference(kind):
    rng = np.random.RandomState(3)
    gs = _clip_pairs(rng)
    make = {"value": lambda m: m.ClipGradByValue(1.5, min=-0.5),
            "norm": lambda m: m.ClipGradByNorm(2.0),
            "global": lambda m: m.ClipGradByGlobalNorm(1.0),
            "global_small": lambda m: m.ClipGradByGlobalNorm(100.0)}[kind]
    want = make(jnn)([(None, paddle.to_tensor(g)) for g in gs])
    got = make(tnn)([(None, torch.from_numpy(g)) for g in gs])
    for (_, w), (_, g) in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._data),
                                   rtol=1e-6, atol=1e-7)
    if kind == "global_small":  # scale 1: the gradients unchanged
        for (_, g), g0 in zip(got, gs):
            np.testing.assert_array_equal(g.numpy(), g0)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_and_value_match_reference(norm_type):
    from paddle_tpu.nn.clip import clip_grad_norm_ as jnorm
    from paddle_tpu.nn.clip import clip_grad_value_ as jvalue

    rng = np.random.RandomState(4)
    gs = _clip_pairs(rng)
    jps = _jax_params([np.zeros_like(g) for g in gs], jnp.float32)
    tps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for jp, tp, g in zip(jps, tps, gs):
        jp.grad = paddle.to_tensor(g)
        tp.grad = torch.from_numpy(g.copy())
    want = jnorm(jps, 1.0, norm_type)
    got = tnn.clip_grad_norm_(tps, 1.0, norm_type)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(),
                                   rtol=1e-6, atol=1e-7)
    jvalue(jps, 0.05)
    tnn.clip_grad_value_(tps, 0.05)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_grad_clip_runs_before_the_update():
    """Momentum with ClipGradByGlobalNorm(0.5) through step(), 3 steps."""
    rng = np.random.RandomState(5)
    values = [rng.randn(6, 5).astype(np.float32),
              rng.randn(5).astype(np.float32)]
    jps = _jax_params(values, jnp.float32)
    tps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    jopt = paddle.optimizer.Momentum(
        learning_rate=0.1, parameters=jps,
        grad_clip=jnn.ClipGradByGlobalNorm(0.5))
    opt = topt.Momentum(learning_rate=0.1, parameters=tps,
                        grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    for _ in range(3):
        gs = [rng.randn(*v.shape).astype(np.float32) * 4 for v in values]
        for jp, tp, g in zip(jps, tps, gs):
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g)
        jopt.step()
        opt.step()
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_scaler_sequence_matches_reference(dtype):
    """10 steps of scaler.step, an inf planted in a gradient at steps 2, 3
    and 7: the scale sequence, the skipped updates and the parameters
    (bit for bit) equal the reference's; the state dict round-trips."""
    rng = np.random.RandomState(6)
    values = [rng.randn(4, 3).astype(np.float32),
              rng.randn(3).astype(np.float32)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jps = _jax_params(values, jdt)
    tps = [torch.nn.Parameter(torch.from_numpy(v).to(tdt)) for v in values]
    jopt = paddle.optimizer.SGD(learning_rate=0.1, parameters=jps)
    opt = topt.SGD(learning_rate=0.1, parameters=tps)
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    jsc, sc = JaxGradScaler(**kw), GradScaler(**kw)
    scales = []
    for step in range(10):
        gs = [rng.randn(*v.shape).astype(np.float32) * sc.get_loss_scaling()
              for v in values]
        if step in (2, 3, 7):
            gs[1][0] = np.inf
        before = [tp.detach().clone() for tp in tps]
        for jp, tp, g in zip(jps, tps, gs):
            jp.grad = paddle.to_tensor(jnp.asarray(g, jdt))
            tp.grad = torch.from_numpy(g).to(tdt)
        jsc.step(jopt)
        sc.step(opt)
        scales.append((jsc.get_loss_scaling(), sc.get_loss_scaling()))
        if step in (2, 3, 7):
            assert all(torch.equal(b, tp.detach())
                       for b, tp in zip(before, tps))
        for jp, tp in zip(jps, tps):
            np.testing.assert_array_equal(
                tp.detach().float().numpy(),
                np.asarray(jp._data.astype(jnp.float32)))
    assert [a for a, _ in scales] == [b for _, b in scales]
    assert len({a for a, _ in scales}) > 2
    state = sc.state_dict()
    assert state == jsc.state_dict()
    fresh = GradScaler()
    fresh.load_state_dict(state)
    assert fresh.state_dict() == state
    assert math.isfinite(sc.get_loss_scaling())
