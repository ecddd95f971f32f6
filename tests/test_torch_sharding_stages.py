"""ZeRO stages 1-3 in the port against the JAX package's sharded step, on
the CPU.

The port: gloo ranks (`torch_zero_workers.zero_runs_main`) run
`fleet.init` over dp, sharding and tp, then `build_train_step` with
`sharding_stage` 0-3 on a plain AdamW, with `group_sharded_parallel`, or
with `fleet.distributed_optimizer` at sharding_degree 2; each rank steps on
its shard of the batch (over dp x sharding). The reference: the same
model in the JAX package, `build_train_step(..., sharding_stage=s)` over
the same axes of the 8-device CPU mesh, on the whole batch: the geometry
of its own `tests/test_sharding_stages.py:17-31` (tiny widths, AdamW lr
1e-3, f32), loaded from one numpy state.

Held: 3 steps' losses equal on every rank and within rtol 2e-4, atol 2e-5
of the reference's; the parameters after the last step (the ranks' stage-3
pieces and tp shards joined by `weights.gather_llama_state`) within 1e-5
of the reference's, each tensor's difference over its norm; at world 2,
stages 1-3 equal the port's stage 0 bit for bit (a sum of two terms does
not depend on order); each stage's per-rank bytes (optimizer state,
gradients after the backward, parameters between steps) as the stages
differ; the update launched once a piece of the rank's slice; a global
norm clip at stage 2 scaling by stage 0's norm; an inf in one rank's
gradient slice skipping the step on every rank under a GradScaler; the
optimizer's state_dict holding the rank's slices and reloading.
"""
import jax
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as jmesh
from paddle_tpu.distributed.fleet.meta_parallel.sharding.sharding_optimizer \
    import group_sharded_parallel as jax_group_sharded_parallel
from paddle_tpu.models import build_train_step as jax_build_train_step
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import weights as W
from paddle_tpu_torch.models.llama import LlamaConfig
from torch_dist_workers import run_group
from torch_parity import jax_state
from torch_zero_workers import LR, TINY, zero_runs_main

STEPS, SEED = 3, 0
# tag -> (degrees, stage, gradient merge steps, how the port builds it)
RUNS = {
    "dp2_s1": (dict(dp=2), 1, 1, "step"),
    "dp2_s2": (dict(dp=2), 2, 1, "step"),
    "dp2_s3": (dict(dp=2), 3, 1, "step"),
    "sharding2_s2": (dict(sharding=2), 2, 1, "step"),
    "dp2_s2_merge2": (dict(dp=2), 2, 2, "step"),
    "gsp_p_g_os": (dict(dp=2), 3, 1, "gsp"),
    "fleet_sharding2": (dict(sharding=2), 1, 1, "fleet"),
    "sharding2_tp2_s3": (dict(sharding=2, tp=2), 3, 1, "step"),
    "dp2_sharding2_s2": (dict(dp=2, sharding=2), 2, 1, "step"),
}
# the port's stage-0 runs each bit-equality check holds against
BASE = {"dp2_s1": "dp2_s0", "dp2_s2": "dp2_s0", "dp2_s3": "dp2_s0",
        "gsp_p_g_os": "dp2_s0", "dp2_s2_merge2": "dp2_s0_merge2"}


def _batch():
    rng = np.random.RandomState(7)
    return rng.randint(0, 128, (8, 16)), rng.randint(0, 128, (8, 16))


def _jax_model():
    paddle.seed(SEED)
    return JaxLlama(JaxLlamaConfig.tiny(**TINY))


@pytest.fixture(scope="module")
def state():
    return {k: v.copy() for k, v in jax_state(_jax_model()).items()}


def _world(deg):
    return int(np.prod(list(deg.values())))


def _port_runs(world, state):
    x, y = _batch()
    runs = []
    for tag, (deg, stage, merge, how) in RUNS.items():
        if _world(deg) == world:
            runs.append((tag, "train", dict(
                state=state, x=x, y=y, steps=STEPS, stage=stage, merge=merge,
                how=how, **deg)))
    if world == 2:
        for tag, merge in (("dp2_s0", 1), ("dp2_s0_merge2", 2)):
            runs.append((tag, "train", dict(state=state, x=x, y=y,
                                            steps=STEPS, dp=2, merge=merge)))
        for stage in (0, 1, 2, 3):
            runs.append((f"bytes{stage}", "bytes",
                         dict(state=state, x=x, y=y, stage=stage)))
        for stage in (0, 2):
            runs.append((f"clip{stage}", "clip",
                         dict(state=state, x=x, y=y, stage=stage)))
        runs.append(("inf", "inf", dict(state=state, x=x, y=y)))
        runs.append(("state_dict", "state_dict", dict(state=state, x=x,
                                                      y=y)))
    # runs of one geometry together: the ranks build each mesh once
    return sorted(runs, key=lambda r: (r[2].get("sharding", 1),
                                       r[2].get("tp", 1)))


@pytest.fixture(scope="module")
def ranks(state):
    """{world: [rank results]}: one group of 2 ranks and one of 4."""
    return {w: run_group(zero_runs_main, w, _port_runs(w, state))
            for w in (2, 4)}


def _jax_run(tag):
    deg, stage, merge, how = RUNS[tag]
    model = _jax_model()
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters())
    x, y = _batch()
    jmesh.set_mesh(None)
    mesh = jmesh.set_mesh(jmesh.build_mesh(
        devices=np.asarray(jax.devices("cpu")[:_world(deg)]), **deg))
    try:
        if how == "gsp":
            model, opt, _ = jax_group_sharded_parallel(model, opt,
                                                       level="p_g_os")
            step = jax_build_train_step(model, opt, mesh=mesh)
            assert step._inner._sharding_stage == 3
        else:
            step = jax_build_train_step(model, opt, mesh=mesh,
                                        sharding_stage=stage,
                                        gradient_merge_steps=merge)
        losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
                  for _ in range(STEPS)]
    finally:
        jmesh.set_mesh(None)
    return losses, jax_state(model)


@pytest.fixture(scope="module")
def reference():
    return {tag: _jax_run(tag) for tag in RUNS}


def _results(ranks, tag):
    return [r[tag] for r in ranks[_world(RUNS[tag][0]) if tag in RUNS else 2]]


def _gathered(res):
    """The full state from every rank's (each tp rank's stage-3 pieces
    joined, then the tp shards)."""
    cfg = LlamaConfig.tiny(**TINY)
    if W.ZERO_KEY in res[0]["state"]:
        return W.gather_llama_state([r["state"] for r in res], cfg)
    tp = {r.get("tp_rank", 0): r["state"] for r in res}
    return W.gather_llama_state([tp[t] for t in sorted(tp)], cfg)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_stage_matches_the_reference_sharded_step(ranks, reference, tag):
    deg, stage, _, how = RUNS[tag]
    res = _results(ranks, tag)
    want = {"step": "AdamW", "gsp": "DygraphShardingOptimizer",
            "fleet": "DygraphShardingOptimizer"}[how]
    assert {r["optimizer"] for r in res} == {want}
    assert {r["stage"] for r in res} == {stage}
    assert {r["axis"] for r in res} == \
        {"sharding" if "sharding" in deg else "dp"}
    losses = res[0]["losses"]
    for r in res[1:]:
        assert r["losses"] == losses  # bit for bit on every rank
    want_losses, want_state = reference[tag]
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4, atol=2e-5)
    assert losses[-1] < losses[0]
    got = _gathered(res)
    worst = {n: float(np.linalg.norm(got[n] - w) / np.linalg.norm(w))
             for n, w in want_state.items()}
    assert max(worst.values()) <= 1e-5, sorted(
        worst.items(), key=lambda kv: -kv[1])[:4]


@pytest.mark.parametrize("tag", sorted(BASE))
def test_stages_equal_the_data_parallel_step_bit_for_bit(ranks, tag):
    res, base = _results(ranks, tag), _results(ranks, BASE[tag])
    assert [r["losses"] for r in res] == [r["losses"] for r in base]
    got, want = _gathered(res), _gathered(base)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_update_runs_once_a_piece_with_a_collective_a_bucket(ranks, tag):
    """Each step updates each rank's pieces once (on the card: one Adam
    launch a piece), the pieces of all ranks cover every parameter; each
    applying step reduce_scatters and (stages 1-2) all_gathers each bucket
    once; stage 3 gathers each block before its forward and its backward
    (the embedding's before its forward only)."""
    deg, stage, merge, _ = RUNS[tag]
    res = _results(ranks, tag)
    for r in res:
        applied = [n for i, n in enumerate(r["updates"]) if (i + 1) % merge
                   == 0]
        assert applied == [r["pieces"]] * len(applied)
        assert all(n == 0 for i, n in enumerate(r["updates"])
                   if (i + 1) % merge)
    layers = TINY["layers"]
    zero_n = deg["sharding"] if "sharding" in deg else deg["dp"]
    # over the ZeRO axis the ranks' pieces cover every parameter (21 a
    # tp rank), a parameter cut by a slice boundary counting twice
    assert sum(r["pieces"] for r in res) >= 21 * len(res) // zero_n
    for r in res:
        t = r["traffic"]
        buckets = t["reduce_scatter"] // STEPS
        assert t["reduce_scatter"] == buckets * STEPS
        if stage < 3:
            assert t["all_gather"] == buckets * (STEPS // merge)
        else:
            # root and the layers twice a step, the embedding once
            assert t["all_gather"] == (2 * layers + 3) * STEPS
        if deg.get("dp", 1) > 1 and "sharding" in deg:
            assert t["all_reduce"] == t["reduce_scatter"]
        else:
            assert "all_reduce" not in t


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_per_rank_bytes_differ_by_stage(ranks, stage):
    """The reference's `test_layouts_differ_by_stage` (:105-126) as bytes
    a rank holds: moments 1/N from stage 1, gradients after the backward
    1/N from stage 2, parameters between steps 1/N at stage 3 (N = 2,
    each up to the padding of the rank's slices)."""
    base = [r["bytes0"] for r in ranks[2]]
    res = [r[f"bytes{stage}"] for r in ranks[2]]
    assert res[0]["loss"] != res[1]["loss"]  # each rank its own batch
    whole = {k: base[0][k] for k in ("state", "grads", "params")}
    assert all(b[k] == whole[k] for b in base for k in whole)
    sliced = {"state": stage >= 1, "grads": stage >= 2, "params": stage >= 3}
    for k, half in sliced.items():
        for r in res:
            if half:
                assert 0.4 * whole[k] < r[k] < 0.6 * whole[k], (k, r[k])
            else:
                assert r[k] == whole[k], (k, r[k])
    if stage >= 1:
        # the pieces partition the parameters: their state adds up
        assert res[0]["state"] + res[1]["state"] == whole["state"]


def test_global_norm_clip_at_stage2_scales_by_stage0s_norm(ranks):
    got = [r["clip2"] for r in ranks[2]]
    want = [r["clip0"] for r in ranks[2]]
    assert all(len(r["norms"]) == 1 for r in got + want)
    n0 = want[0]["norms"][0]
    assert n0 > 1.0  # the clip acts
    for r in got + want:
        assert abs(r["norms"][0] - n0) <= 1e-6 * n0
    a, b = _gathered(got), _gathered([want[0]])
    for n in b:
        assert np.linalg.norm(a[n] - b[n]) <= 1e-6 * np.linalg.norm(b[n]), n


def test_an_inf_in_one_ranks_slice_skips_the_step_on_every_rank(ranks):
    res = [r["inf"] for r in ranks[2]]
    for r in res:
        assert all(r["slices_after_backward"])
        assert r["skipped"] and r["moved"]
        assert r["scale"] == 512.0


def test_state_dict_holds_the_ranks_slices_and_reloads(ranks):
    res = [r["state_dict"] for r in ranks[2]]
    assert all(r["equal"] for r in res)
    assert sum(r["moment1_elements"] for r in res) == res[0]["params"]
    assert all(r["moment1_elements"] < res[0]["params"] for r in res)
