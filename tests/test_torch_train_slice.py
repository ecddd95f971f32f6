"""The rest of the single-card training step against the JAX package, on the
CPU in f32: recompute, the padding mask, the chunked LM-head loss,
gradient merge, the compiled step's update rules, auto_cast at O1, and a
tiny LLaMA's loss curve through `build_train_step` with all of them on.

The tiny LLaMA is `torch_parity.tiny_pair`'s (2 layers, hidden 128, 4
heads of 32 over 2 KV heads, vocab 256); the port's attention takes its
dense reference path at head_dim 32, the reference its XLA path.

Tolerances: logits 1e-4 abs and losses 1e-5 relative (f32 matmuls summed
in another order); gradients 1e-4 of each tensor's largest magnitude;
each tensor's AdamW updates within 1e-3 of their norm (Adam's step is
about lr * g / |g|, so an element whose gradient is at rounding level may
move by another fraction of lr: elementwise bars do not hold); with and
without recompute the
same operations run, so gradients are bit for bit equal; at O1, bf16
products: 3e-2 of the largest logit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.distributed.fleet.utils import recompute as jrecompute
from paddle_tpu.jit import train_step as jax_train_step
from paddle_tpu.models import build_train_step as jax_build_train_step
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import lr as jlr
import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.fleet.utils import (recompute,
                                                      recompute_sequential)
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.models import build_train_step
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import lr as tlr
from torch_parity import TINY, tiny_pair

B, S = 2, TINY["seq"]


def _batch(seed, b=B, ignore=True):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, TINY["vocab"], (b, S))
    y = rng.randint(0, TINY["vocab"], (b, S))
    if ignore:
        y[0, :5] = -100
    return x, y


def _jgrads(jm):
    return {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}


def _close_params(tm, want, before, tol=1e-3):
    """tm's parameters against {name: array}: each tensor's update (from
    `before`) within `tol` of the wanted update's norm."""
    for n, p in tm.named_parameters():
        d_got = p.detach().numpy() - before[n]
        d_want = want[n] - before[n]
        err = np.linalg.norm(d_got - d_want)
        assert err <= tol * max(np.linalg.norm(d_want), 1e-12), (n, err)


def _close_grads(got, want):
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        err = np.abs(got[name] - g).max()
        assert err <= 1e-4 * max(np.abs(g).max(), 1e-12), (name, err)


# ---------------------------------------------------------------------------
# recompute
# ---------------------------------------------------------------------------


def test_recompute_gradients_equal_without_it():
    _, tm, cfg = tiny_pair(1)
    x, y = (torch.from_numpy(a) for a in _batch(1))
    grads = []
    for on in (False, True):
        for layer in tm.llama.layers:
            layer.use_recompute = on
        tm.zero_grad(set_to_none=True)
        tm.compute_loss(tm(x), y).backward()
        grads.append({n: p.grad.clone() for n, p in tm.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


def _dropout_body(w):
    def body(x):
        h = TF.dropout(torch.tanh(x @ w), p=0.5, training=True)
        return TF.dropout(h @ w, p=0.3, training=True)
    return body


@pytest.mark.parametrize("via", ["recompute", "recompute_sequential"])
def test_recompute_replays_the_same_dropout_masks(via):
    """The replay draws the first run's masks from the port's own stream:
    gradients equal the plain run's bit for bit, and the stream ends where
    the plain run leaves it. `torch.utils.checkpoint` alone (which saves
    torch's generators, not the port's) replays other masks."""
    rng = np.random.RandomState(2)
    x0 = torch.from_numpy(rng.randn(8, 16).astype(np.float32))
    w0 = torch.from_numpy(rng.randn(16, 16).astype(np.float32) * 0.3)

    def grads(mode):
        ptt.seed(11)
        w = w0.clone().requires_grad_()
        x = x0.clone().requires_grad_()
        body = _dropout_body(w)
        if mode == "plain":
            out = body(x)
        elif mode == "recompute":
            out = recompute(body, x)
        elif mode == "recompute_sequential":
            out = recompute_sequential({"segments": 1}, [body], x)
        else:
            out = torch.utils.checkpoint.checkpoint(body, x,
                                                    use_reentrant=False)
        (out * torch.arange(16.0)).sum().backward()
        return w.grad, x.grad, ptt.get_rng_state()[0]

    want = grads("plain")
    got = grads(via)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    naive = grads("checkpoint")
    assert not torch.equal(naive[0], want[0])


def test_recompute_matches_the_reference_function():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 8).astype(np.float32)
    w = rng.randn(8, 8).astype(np.float32)
    jw = paddle.to_tensor(w, stop_gradient=False)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jrecompute(lambda a, b: paddle.tanh(paddle.matmul(a, b)), jx,
                      jw)
    jout.sum().backward()
    tw = torch.from_numpy(w).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    tout = recompute(lambda a, b: torch.tanh(a @ b), tx, tw)
    tout.sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), jw.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the padding mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_padding_mask_logits_match_reference(kind):
    jm, tm, _ = tiny_pair(4)
    x, _ = _batch(4)
    keep = np.ones((B, 1, 1, S), bool)
    keep[1, ..., S - 20:] = False  # row 1: the last 20 tokens are padding
    mask = keep if kind == "bool" else np.where(keep, 0.0, -1e4).astype(
        np.float32)
    want = np.asarray(jm(paddle.to_tensor(x), paddle.to_tensor(mask))._data)
    got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)
    plain = tm(torch.from_numpy(x)).detach().numpy()
    # row 0 has no padding: the causal mask alone; row 1 differs
    np.testing.assert_allclose(got[0].detach().numpy(), plain[0], atol=1e-5)
    assert np.abs(got[1].detach().numpy() - plain[1]).max() > 1e-3


# ---------------------------------------------------------------------------
# the chunked LM-head cross entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunks,tie", [(4, False), (5, False), (3, True)])
def test_compute_loss_hidden_matches_reference(chunks, tie):
    """chunks 5 and 3 do not divide the 128 tokens: both fall to 4 and 2.
    Loss and parameter gradients against the reference's fused loss, and
    against the port's dense loss (ignored rows in the denominator)."""
    jm, tm, _ = tiny_pair(5, tie=tie)
    x, y = _batch(5)
    jloss = jm.compute_loss_hidden(jm.forward_hidden(paddle.to_tensor(x)),
                                   paddle.to_tensor(y), chunks=chunks)
    jloss.backward()
    loss = tm.compute_loss_hidden(tm.forward_hidden(torch.from_numpy(x)),
                                  torch.from_numpy(y), chunks=chunks)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = {n: p.grad.numpy().copy() for n, p in tm.named_parameters()}
    _close_grads(got, _jgrads(jm))
    tm.zero_grad(set_to_none=True)
    dense = tm.compute_loss(tm(torch.from_numpy(x)), torch.from_numpy(y))
    dense.backward()
    np.testing.assert_allclose(loss.item(), dense.item(), rtol=1e-5)
    _close_grads(got, {n: p.grad.numpy() for n, p in tm.named_parameters()})


# ---------------------------------------------------------------------------
# the compiled step: gradient merge and its update rules
# ---------------------------------------------------------------------------


def _adamw(mod, params, **kw):
    return mod.AdamW(learning_rate=1e-2, parameters=params,
                     weight_decay=0.1, **kw)


def test_gradient_merge_matches_one_large_batch_and_the_reference():
    """2 merged calls on batches of 2 rows equal one call on their 4 rows
    (averaged merge: the mean loss's gradient), and the reference's merged
    step; the step count rises every call, the beta powers on apply."""
    jm, tm, _ = tiny_pair(6)
    _, big, _ = tiny_pair(6)
    x, y = _batch(6, b=2 * B, ignore=False)
    halves = [(x[:B], y[:B]), (x[B:], y[B:])]
    jopt = _adamw(paddle.optimizer, jm.parameters())
    jstep = jax_train_step(jm, jm.compute_loss, jopt,
                           gradient_merge_steps=2)
    opt = _adamw(topt, tm.parameters())
    step = train_step(tm, tm.compute_loss, opt, gradient_merge_steps=2)
    bopt = _adamw(topt, big.parameters())
    bstep = train_step(big, big.compute_loss, bopt)
    for hx, hy in halves:
        jloss = jstep(paddle.to_tensor(hx), paddle.to_tensor(hy))
        loss = step(torch.from_numpy(hx), torch.from_numpy(hy))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    bstep(torch.from_numpy(x), torch.from_numpy(y))
    assert opt._step_count == jopt._step_count == 2
    assert bopt._step_count == 1
    assert opt.state_dict()["0_beta1_pow"] == np.float32(0.9)
    jstate = jstep._opt_state_holder["state"]
    assert float(jstate["llama.norm.weight"]["beta1_pow"]) == np.float32(0.9)
    before = {n: p.detach().numpy() for n, p in
              tiny_pair(6)[1].named_parameters()}
    _close_params(tm, {n: np.asarray(p._data)
                       for n, p in jm.named_parameters()}, before)
    _close_params(tm, {n: p.detach().numpy()
                       for n, p in big.named_parameters()}, before)
    # a third call accumulates again: the count rises, the pows do not
    step(torch.from_numpy(halves[0][0]), torch.from_numpy(halves[0][1]))
    assert opt._step_count == 3
    assert opt.state_dict()["0_beta1_pow"] == np.float32(0.9)
    assert all(p.grad is None for p in tm.parameters())


def test_compiled_step_ignores_grad_clip_and_optimize_attr():
    """train_step updates through apply_gradients: a clip that would zero
    nearly every gradient and a learning-rate scale of 0 change nothing,
    as in the reference's compiled step; the eager step() applies both."""
    x, y = _batch(7)
    results = []
    for tag in ("plain", "clip"):
        jm, tm, _ = tiny_pair(7)
        kw = {}
        jkw = {}
        if tag == "clip":
            kw["grad_clip"] = ptt.nn.ClipGradByGlobalNorm(1e-9)
            jkw["grad_clip"] = paddle.nn.ClipGradByGlobalNorm(1e-9)
            tm.llama.norm.weight.optimize_attr = {"learning_rate": 0.0}
            jm.llama.norm.weight.optimize_attr = {"learning_rate": 0.0}
        opt = _adamw(topt, tm.parameters(), **kw)
        jopt = _adamw(paddle.optimizer, jm.parameters(), **jkw)
        step = train_step(tm, tm.compute_loss, opt)
        jstep = jax_train_step(jm, jm.compute_loss, jopt)
        for _ in range(2):
            step(torch.from_numpy(x), torch.from_numpy(y))
            jstep(paddle.to_tensor(x), paddle.to_tensor(y))
        results.append(({n: p.detach().clone()
                         for n, p in tm.named_parameters()},
                        {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()}))
    (plain, jplain), (clip, jclip) = results
    for n, p in plain.items():
        assert torch.equal(p, clip[n]), n
    before = {n: p.detach().numpy() for n, p in
              tiny_pair(7)[1].named_parameters()}
    tm.load_state_dict(clip)
    _close_params(tm, jclip, before)
    # the eager step applies them: the norm weight stays, others move less
    jm, tm, _ = tiny_pair(7)
    tm.llama.norm.weight.optimize_attr = {"learning_rate": 0.0}
    opt = _adamw(topt, tm.parameters(),
                 grad_clip=ptt.nn.ClipGradByGlobalNorm(1e-9))
    before = tm.llama.norm.weight.detach().clone()
    tm.compute_loss(tm(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    opt.step()
    assert torch.equal(tm.llama.norm.weight.detach(), before)


def test_compiled_step_hands_structured_names_to_the_decay_fun():
    """The reference's compiled step calls apply_decay_param_fun with each
    parameter's structured name; its eager step() with '' (unnamed layer
    parameters). The port's train_step and step() do the same."""
    x, y = _batch(8)
    seen = {"jax": set(), "torch": set()}

    def fun(tag):
        def f(name):
            seen[tag].add(name)
            return "norm" not in name
        return f

    jm, tm, _ = tiny_pair(8)
    jopt = _adamw(paddle.optimizer, jm.parameters(),
                  apply_decay_param_fun=fun("jax"))
    opt = _adamw(topt, tm.parameters(), apply_decay_param_fun=fun("torch"))
    jax_train_step(jm, jm.compute_loss, jopt)(paddle.to_tensor(x),
                                              paddle.to_tensor(y))
    train_step(tm, tm.compute_loss, opt)(torch.from_numpy(x),
                                         torch.from_numpy(y))
    names = {n for n, _ in tm.named_parameters()}
    assert seen["torch"] == seen["jax"] == names
    assert "llama.layers.0.input_layernorm.weight" in names
    _close_params(tm, {n: np.asarray(p._data)
                       for n, p in jm.named_parameters()},
                  {n: p.detach().numpy() for n, p in
                   tiny_pair(8)[1].named_parameters()})
    seen["torch"].clear()
    tm.compute_loss(tm(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    opt.step()
    assert seen["torch"] == {""}


def test_train_step_refuses_what_it_does_not_port():
    _, tm, _ = tiny_pair(9)
    opt = _adamw(topt, tm.parameters())
    with pytest.raises(ValueError):
        train_step(tm, tm.compute_loss, opt, sharding_stage=4)
    with pytest.raises(NotImplementedError):
        build_train_step(tm, opt, mesh=object())
    # without a "pp" axis the pipeline arguments are ignored, as in the
    # reference (`models/trainer.py:626-652`): the plain step
    step = build_train_step(tm, opt, pipeline_schedule="1f1b",
                            num_microbatches=4, virtual_pp_degree=2)
    assert not hasattr(step, "_link") and step._merge["count"] == 0
    step = build_train_step(tm, opt, donate=False)
    assert not hasattr(step, "_data_put")  # the CPU: no staging


# ---------------------------------------------------------------------------
# auto_cast O1
# ---------------------------------------------------------------------------


def test_auto_cast_o1_casts_by_the_reference_lists():
    rng = np.random.RandomState(10)
    x = rng.randn(3, 8, 16).astype(np.float32)
    w = rng.randn(16, 16).astype(np.float32) * 0.2
    lab = rng.randint(0, 16, (3, 8))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jx, jw = paddle.to_tensor(x), paddle.to_tensor(w)
    with amp.auto_cast(level="O1", dtype="bfloat16"), \
            jamp.auto_cast(level="O1", dtype="bfloat16"):
        # white list: f32 in, bf16 out
        lin, jlin = TF.linear(tx, tw), JF.linear(jx, jw)
        assert lin.dtype == torch.bfloat16 and jlin._data.dtype == jnp.bfloat16
        np.testing.assert_allclose(lin.float().numpy(),
                                   np.asarray(jlin._data, np.float32),
                                   rtol=2e-2, atol=2e-2)
        # black list: bf16 in, f32 out
        xb, jxb = lin, jlin
        rms = TF.rms_norm(xb, torch.ones(16))
        jrms = JF.rms_norm(jxb, paddle.ones([16]))
        assert rms.dtype == torch.float32 and jrms._data.dtype == jnp.float32
        np.testing.assert_allclose(rms.numpy(), np.asarray(jrms._data),
                                   rtol=1e-5, atol=1e-5)
        ce = TF.cross_entropy(xb, torch.from_numpy(lab))
        jce = JF.cross_entropy(jxb, paddle.to_tensor(lab))
        assert ce.dtype == torch.float32
        np.testing.assert_allclose(ce.item(), float(jce), rtol=1e-5)
        # on neither list: the input's dtype
        assert TF.relu(xb).dtype == torch.bfloat16
        assert TF.relu(tx).dtype == torch.float32
        assert TF.gelu(tx).dtype == torch.float32
        q = tx.reshape(3, 8, 1, 16)
        assert TF.scaled_dot_product_attention(q, q, q).dtype \
            == torch.bfloat16
    # off again: no cast
    assert TF.linear(tx, tw).dtype == torch.float32
    with amp.auto_cast(enable=False):
        assert TF.linear(tx, tw).dtype == torch.float32
    # a custom white list entry (the white list is consulted first)
    with amp.auto_cast(custom_white_list={"cross_entropy"}):
        assert TF.cross_entropy(tx, torch.from_numpy(lab),
                                reduction="none").dtype == torch.bfloat16


def test_auto_cast_o1_logits_match_reference():
    jm, tm, _ = tiny_pair(12)
    x, _ = _batch(12)
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        want = np.asarray(jm(paddle.to_tensor(x))._data, np.float32)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= 3e-2 * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------


def test_build_train_step_loss_curve_with_the_whole_surface():
    """20 calls through each package's build_train_step on a tiny LLaMA
    with recompute, the chunked loss (4 chunks), LinearWarmup over cosine
    (stepped each call), AdamW without decay on the norm weights, and
    gradient merge over 2 calls; losses 1e-5 relative, then parameters."""
    jm, tm, _ = tiny_pair(13)
    for cfg in (jm.config, tm.config):
        cfg.use_recompute = True
        cfg.fused_ce_chunks = 4
    for layer in list(jm.llama.layers) + list(tm.llama.layers):
        layer.use_recompute = True

    def make(mod, lrmod, params):
        sched = lrmod.LinearWarmup(lrmod.CosineAnnealingDecay(3e-3, 20), 4,
                                   0.0, 3e-3)
        return sched, mod.AdamW(learning_rate=sched, parameters=params,
                                weight_decay=0.05,
                                apply_decay_param_fun=lambda n: "norm"
                                not in n)

    jsched, jopt = make(paddle.optimizer, jlr, jm.parameters())
    sched, opt = make(topt, tlr, tm.parameters())
    jstep = jax_build_train_step(jm, jopt, mesh=None, gradient_merge_steps=2)
    step = build_train_step(tm, opt, gradient_merge_steps=2)
    rng = np.random.RandomState(13)
    pool = [rng.randint(0, TINY["vocab"], (B, S)) for _ in range(2)]
    want, got = [], []
    for i in range(20):
        x = pool[i % 2]
        y = np.roll(x, -1, axis=1)
        y[:, -1] = -100
        want.append(float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))))
        got.append(step(torch.from_numpy(x), torch.from_numpy(y)).item())
        jsched.step()
        sched.step()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert np.mean(got[-4:]) < np.mean(got[:4])
    _close_params(tm, {n: np.asarray(p._data)
                       for n, p in jm.named_parameters()},
                  {n: p.detach().numpy() for n, p in
                   tiny_pair(13)[1].named_parameters()})
