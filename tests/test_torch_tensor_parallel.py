"""Tiny LLaMA and GPT trained through the port's fleet path against the
JAX package's tp-mesh step, on the CPU.

The port: gloo ranks (`torch_tp_workers.train_runs_main`) run `fleet.init`
(mp_degree 2, LLaMA also with `sequence_parallel`, and dp_degree 2 x
mp_degree 2 on four ranks),
`fleet.distributed_model`, `fleet.distributed_optimizer` and
`build_train_step`, each from the reference model's full numpy state
sliced to the rank's shards; a rank steps on its dp shard of the batch.
The reference: the same model in the JAX package, `build_train_step(mesh=
...)` over a tp = 2 (or dp = 2 x tp = 2) mesh of the 8-device CPU mesh, on
the whole batch: the geometry of its own `test_gpt.py::
test_tp_mesh_loss_parity` (tiny widths, batch 4 x 16, AdamW lr 1e-3).

Held: two steps' losses equal on every rank, bit for bit, and within the
reference test's own bar (rtol 2e-4, atol 2e-5) of the reference's; the
parameters after step 2, the tp ranks' shards joined (`weights.gather_*`)
and equal on both dp ranks, within 1e-5 of the reference's, each tensor's
difference over its norm (the key part of GPT's QKV bias, whose gradient
is zero in exact arithmetic, moves at most lr a step in both); the
chunked LM-head cross entropy at tp 2 (4 chunks, a loss with no update)
within 1e-5 of the reference's, the bar of
`test_fused_ce.py:166-175`; greedy `generate` at tp 2 (the logits
gathered before sampling) equal on both ranks and to the reference's
tokens, scores within 1e-4.
"""
import jax
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as jmesh
from paddle_tpu.models import build_train_step as jax_build_train_step
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import weights as W
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.models.llama import LlamaConfig
from torch_dist_workers import run_group
from torch_parity import jax_state
from torch_tp_workers import TINY_GPT, TINY_LLAMA, train_runs_main

STEPS, LR, SEED = 2, 1e-3, 7
PROMPT = np.random.RandomState(3).randint(0, 128, (2, 6))
N_NEW = 5
# dp, tp, sequence parallelism (LLaMA's alone)
GEOMETRY = {"tp2": (1, 2, False), "dp2tp2": (2, 2, False),
            "tp2sp": (1, 2, True)}
RUNS = [("llama", "tp2"), ("llama", "dp2tp2"), ("llama", "tp2sp"),
        ("gpt", "tp2"), ("gpt", "dp2tp2")]


def _batch():
    rng = np.random.RandomState(0)
    return rng.randint(0, 128, (4, 16)), rng.randint(0, 128, (4, 16))


def _jax_model(family, chunks=0):
    paddle.seed(SEED)
    if family == "llama":
        cfg = JaxLlamaConfig.tiny(**TINY_LLAMA)
        cfg.fused_ce_chunks = chunks
        return JaxLlama(cfg)
    cfg = JaxGPTConfig.tiny(**TINY_GPT)
    cfg.fused_ce_chunks = chunks
    return JaxGPT(cfg)


def _jax_steps(family, dp, tp, chunks=0, lr=LR, steps=STEPS):
    """The reference's losses and parameters after `steps` steps over a
    dp x tp mesh."""
    model = _jax_model(family, chunks)
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=model.parameters()) if lr \
        else paddle.optimizer.SGD(learning_rate=0.0,
                                  parameters=model.parameters())
    x, y = _batch()
    jmesh.set_mesh(None)
    mesh = jmesh.set_mesh(jmesh.build_mesh(
        dp=dp, tp=tp, devices=np.asarray(jax.devices("cpu")[:dp * tp])))
    try:
        step = jax_build_train_step(model, opt, mesh=mesh)
        losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
                  for _ in range(steps)]
    finally:
        jmesh.set_mesh(None)
    return losses, jax_state(model)


def _state(family, chunks=0):
    return {k: v.copy() for k, v in jax_state(_jax_model(family,
                                                         chunks)).items()}


def _runs(world):
    x, y = _batch()
    runs = []
    for family, geo in RUNS:
        dp, tp, sp = GEOMETRY[geo]
        if dp * tp == world:
            runs.append((f"{family}_{geo}", "train", (
                family, dp, tp, _state(family), x, y, STEPS, 0, LR, sp)))
    if world == 2:
        runs.append(("llama_ce", "train", ("llama", 1, 2,
                                           _state("llama", 4), x, y, 1, 4,
                                           0.0)))
        for family in ("llama", "gpt"):
            runs.append((f"{family}_generate", "generate", (
                family, 2, _state(family), PROMPT, N_NEW)))
    return runs


@pytest.fixture(scope="module")
def ranks():
    """{world: [rank results]} for the group of 2 and the group of 4."""
    return {w: run_group(train_runs_main, w, _runs(w)) for w in (2, 4)}


def _config(family):
    return LlamaConfig.tiny(**TINY_LLAMA) if family == "llama" \
        else GPTConfig.tiny(**TINY_GPT)


@pytest.mark.parametrize("family,geo", RUNS)
def test_train_steps_match_the_reference_mesh_step(ranks, family, geo):
    dp, tp, sp = GEOMETRY[geo]
    res = [r[f"{family}_{geo}"] for r in ranks[dp * tp]]
    # sequence parallelism marks the three norms' weights (2 layers + the
    # final norm: 5), whose gradients the step's hooks sum over "tp"
    assert all(len(r["sequence_parallel"]) == (5 if sp else 0) for r in res)
    assert {r["wrapper"] for r in res} == {"TensorParallel"}
    assert {r["optimizer"] for r in res} == {"HybridParallelOptimizer"}
    losses = res[0]["losses"]
    for r in res[1:]:
        assert r["losses"] == losses  # bit for bit on every rank
    want_losses, want_state = _jax_steps(family, dp, tp)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4, atol=2e-5)
    assert losses[-1] < losses[0]
    per_dp = {}
    for r in res:
        per_dp.setdefault(r["dp_rank"], []).append(r)
    gather = W.gather_llama_state if family == "llama" \
        else W.gather_gpt_state
    gathered = []
    for d, rs in sorted(per_dp.items()):
        rs.sort(key=lambda r: r["tp_rank"])
        gathered.append(gather([r["state"] for r in rs], _config(family)))
    for g in gathered[1:]:
        for n in g:
            np.testing.assert_array_equal(g[n], gathered[0][n], err_msg=n)
    worst = {}
    for n, want in want_state.items():
        got = gathered[0][n]
        if n.endswith("qkv_proj.bias"):
            # the key part of GPT's fused QKV bias has a zero gradient in
            # exact arithmetic (it shifts a query's every logit alike), so
            # Adam moves each element by the sign of rounding noise, at
            # most lr a step (tests/test_torch_gpt.py holds it so too)
            h, d = TINY_GPT["hidden"], TINY_GPT["hidden"] // TINY_GPT["heads"]
            key = (np.arange(3 * h) % (3 * d)) // d == 1
            for a in (got, want):
                assert np.abs(a[key]).max() <= STEPS * LR * 1.001, n
            got, want = got[~key], want[~key]
        worst[n] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert max(worst.values()) <= 1e-5, sorted(
        worst.items(), key=lambda kv: -kv[1])[:4]


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_eager_step_averages_over_dp_in_hybrid_mode(ranks, family):
    """At dp 2 x tp 2 an eager loop's `step` (the wrapper's) averages each
    gradient over "dp" once: after it, both dp ranks of a tp rank hold the
    mean of their own gradients, replicated and split parameters alike."""
    res = [r[f"{family}_dp2tp2"] for r in ranks[4]]
    for t in (0, 1):
        pair = [r["eager_grads"] for r in res if r["tp_rank"] == t]
        assert len(pair) == 2
        for n in pair[0]:
            mean = (pair[0][n][0] + pair[1][n][0]) / 2
            assert not np.array_equal(pair[0][n][0], pair[1][n][0]), n
            for got in pair:
                np.testing.assert_allclose(got[n][1], mean, rtol=1e-6,
                                           atol=1e-9, err_msg=n)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_generate_at_tp2_gathers_logits_and_matches_the_reference(
        ranks, family):
    """Greedy `generate` at tp 2: the same tokens on both ranks (the
    gathered logits are equal), and the reference's tokens; scores within
    1e-4."""
    got = [r[f"{family}_generate"] for r in ranks[2]]
    np.testing.assert_array_equal(got[0]["tokens"], got[1]["tokens"])
    np.testing.assert_array_equal(got[0]["scores"], got[1]["scores"])
    model = _jax_model(family)
    model.eval()
    tokens, scores = model.generate(paddle.to_tensor(PROMPT),
                                    max_new_tokens=N_NEW)
    np.testing.assert_array_equal(got[0]["tokens"], np.asarray(tokens._data))
    np.testing.assert_allclose(got[0]["scores"], np.asarray(scores._data),
                               rtol=0, atol=1e-4)


def test_chunked_cross_entropy_at_tp2_matches_the_reference(ranks):
    got = [r["llama_ce"]["losses"][0] for r in ranks[2]]
    assert got[0] == got[1]
    want, _ = _jax_steps("llama", 1, 2, chunks=4, lr=0.0, steps=1)
    assert abs(got[0] - want[0]) < 1e-5, (got, want)
