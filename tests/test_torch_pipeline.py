"""Pipeline parallelism in the port against the JAX package's pipelined
step, on the CPU.

The port: gloo ranks (`torch_pp_workers.pp_runs_main`) run `fleet.init`
over pp (x dp, x tp), build LLaMA at its stage from the reference's full
numpy state and step through `build_train_step` with the "1f1b", "gpipe"
and "vpp" schedules; each rank passes its dp shard of the batch. The
reference: the same model in the JAX package, `build_train_step(...,
pipeline_schedule=..., virtual_pp_degree=...)` over the same axes of the
8-device CPU mesh (`conftest.py`), on the whole batch: the geometry of its
own `tests/test_pipeline.py` and `tests/test_vpp.py` (tiny widths, AdamW
lr 1e-3, f32, M = 4 microbatches).

Held: 3 steps' losses equal on every rank and within the reference's
rtol 2e-4, atol 2e-5 (`tests/test_pipeline.py:51`); the parameters after
the last step (the stages joined by `weights.gather_llama_state`) and
Adam's first moments within 3e-5 and 1e-4 of the reference's, each
tensor's difference over its norm (the reference's own pipelined step
differs from its serial step by up to 1.5e-5 so after 3 steps, at pp 2 x
dp 2); 1F1B's gradients equal GPipe's at
rtol 1e-4 (`tests/test_pipeline.py:140`), with at most S - stage
microbatches in flight against GPipe's M; the generic forward
`spmd_pipeline` equal to the serial layers and the reference's; the
interleaved entry `spmd_pipeline_vpp` equal to the reference's; the VPP op
order equal to the reference's `_vpp_schedule` tables; the refusals the
reference raises (and ZeRO stage 2 at pp 2 x dp 2, once refused, stepping).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as jmesh
from paddle_tpu.distributed import pipeline as JP
from paddle_tpu.models import build_train_step as jax_build_train_step
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import weights as W
from paddle_tpu_torch.distributed import pipeline as TP
from paddle_tpu_torch.models.llama import LlamaConfig
from torch_parity import jax_state
from torch_pp_workers import LR, TINY, pp_runs_main, start_groups

STEPS, SEED, M = 3, 7, 4
# tag -> (degrees, schedule, virtual_pp_degree, layers)
RUNS = {
    "pp2_1f1b": (dict(pp=2), "1f1b", 1, 4),
    "pp2_gpipe": (dict(pp=2), "gpipe", 1, 4),
    "pp2_vpp2": (dict(pp=2), "vpp", 2, 4),
    "pp2_dp2": (dict(pp=2, dp=2), "1f1b", 1, 4),
    "pp2_tp2": (dict(pp=2, tp=2), "1f1b", 1, 4),
    "pp4_vpp2": (dict(pp=4), "vpp", 2, 8),
}
# the generic entries' geometry: the reference's tests/test_pipeline.py:79
# (8 tanh layers of 16 over pp 4) and tests/test_vpp.py:51 (pp 4 x v 2)
FWD_L, FWD_D = 8, 16
VPP_S, VPP_V, VPP_M, VPP_D = 4, 2, 8, 16


def _world(deg):
    return int(np.prod(list(deg.values())))


def _batch():
    rng = np.random.RandomState(0)
    return rng.randint(0, 64, (8, 16)), rng.randint(0, 64, (8, 16))


def _jax_model(layers):
    paddle.seed(SEED)
    return JaxLlama(JaxLlamaConfig.tiny(layers=layers, **TINY))


@pytest.fixture(scope="module")
def states():
    return {L: {k: v.copy() for k, v in jax_state(_jax_model(L)).items()}
            for L in (4, 8)}


def _generic_inputs():
    rng = np.random.RandomState(1)
    ws = (rng.randn(FWD_L, FWD_D, FWD_D) * 0.2).astype(np.float32)
    x = rng.randn(8, FWD_D).astype(np.float32)
    rng = np.random.RandomState(0)
    L = VPP_S * VPP_V
    vws = (rng.randn(L, VPP_D, VPP_D) * 0.3).astype(np.float32)
    head = (rng.randn(VPP_D, 10) * 0.3).astype(np.float32)
    xs = rng.randn(VPP_M, 3, VPP_D).astype(np.float32)
    ys = rng.randint(0, 10, (VPP_M, 3))
    return dict(x=x, ws=ws, vws=vws, head=head, xs=xs, ys=ys)


def _port_runs(world, states):
    x, y = _batch()
    runs = []
    for tag, (deg, sched, v, layers) in RUNS.items():
        if _world(deg) == world:
            runs.append((tag, "train", dict(
                state=states[layers], x=x, y=y, steps=STEPS, schedule=sched,
                v=v, M=M, layers=layers, **deg)))
    g = _generic_inputs()
    if world == 2:
        runs += [("grads", "grads", dict(state=states[4], x=x, y=y)),
                 ("refusals", "refusals", dict(state=states[4], x=x, y=y)),
                 ("info_pp2", "info", dict(pp=2))]
    else:
        runs += [("zero", "zero", dict(state=states[4], x=x, y=y)),
                 ("info_pp2_dp2", "info", dict(pp=2, dp=2)),
                 ("info_pp2_tp2", "info", dict(pp=2, tp=2)),
                 ("fwd", "fwd", dict(x=g["x"], ws=g["ws"], pp=4)),
                 ("vpp", "vpp", dict(ws=g["vws"], head_w=g["head"],
                                     xs=g["xs"], ys=g["ys"], v=VPP_V)),
                 ("1f1b", "1f1b", dict(ws=g["vws"], head_w=g["head"],
                                       xs=g["xs"], ys=g["ys"]))]

    def key(r):
        kw = r[2]
        return (kw.get("pp", 2), kw.get("dp", 1), kw.get("tp", 1))
    # runs of one geometry together: the ranks build each mesh once
    return sorted(runs, key=key)


@pytest.fixture(scope="module")
def started(states):
    """One group of 2 ranks and one of 4, started in the background: the
    reference runs meanwhile."""
    return start_groups(pp_runs_main, {w: _port_runs(w, states)
                                       for w in (2, 4)})


@pytest.fixture(scope="module")
def ranks(started, reference):
    """{world: [rank results]}."""
    return started()


def _unstack(opt_state, sched, S, v, layers):
    """The reference's per-name first moments from its step's stacked
    optimizer state ([L, ...], or [S, v, Lc, ...] for "vpp")."""
    out = {}
    for key, st in opt_state.items():
        m = np.asarray(st["moment1"])
        if not key.startswith("pp_stacked::"):
            out[key] = m
            continue
        suffix = key.split("::", 1)[1].split(".", 3)[3]
        if sched == "vpp":
            lc = layers // (S * v)
            for r in range(S):
                for j in range(v):
                    for i in range(lc):
                        out[f"llama.layers.{(j * S + r) * lc + i}.{suffix}"] \
                            = m[r, j, i]
        else:
            for i in range(layers):
                out[f"llama.layers.{i}.{suffix}"] = m[i]
    return out


def _jax_run(tag):
    deg, sched, v, layers = RUNS[tag]
    model = _jax_model(layers)
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters())
    x, y = _batch()
    jmesh.set_mesh(None)
    mesh = jmesh.set_mesh(jmesh.build_mesh(
        devices=np.asarray(jax.devices("cpu")[:_world(deg)]), **deg))
    try:
        step = jax_build_train_step(model, opt, mesh=mesh,
                                    num_microbatches=M,
                                    pipeline_schedule=sched,
                                    virtual_pp_degree=v)
        losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
                  for _ in range(STEPS)]
        step.sync_to_model()
        moments = _unstack(step._holder["opt_state"], sched, deg["pp"], v,
                           layers)
    finally:
        jmesh.set_mesh(None)
    return losses, jax_state(model), moments


@pytest.fixture(scope="module")
def reference(started):
    return {tag: _jax_run(tag) for tag in RUNS}


def _results(ranks, tag):
    return ranks[_world(RUNS[tag][0])] if tag in RUNS else None


def _rel(got, want):
    return {n: float(np.linalg.norm(got[n] - w) / np.linalg.norm(w))
            for n, w in want.items()}


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_schedule_matches_the_reference_pipelined_step(ranks, reference,
                                                       tag):
    deg, sched, v, layers = RUNS[tag]
    res = [r[tag] for r in _results(ranks, tag)]
    losses = res[0]["losses"]
    for r in res[1:]:
        assert r["losses"] == losses  # bit for bit on every rank
    want_losses, want_state, want_moments = reference[tag]
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4, atol=2e-5)
    assert losses[-1] < losses[0]
    cfg = LlamaConfig.tiny(layers=layers, **TINY)
    got = W.gather_llama_state([r["state"] for r in res], cfg)
    worst = _rel(got, want_state)
    assert max(worst.values()) <= 3e-5, sorted(
        worst.items(), key=lambda kv: -kv[1])[:4]
    moments = W.gather_llama_state([dict(r["moments"], **{
        W.PP_KEY: r["state"][W.PP_KEY]}) for r in res], cfg)
    assert set(moments) == set(want_moments)
    worst = _rel(moments, want_moments)
    assert max(worst.values()) <= 1e-4, sorted(
        worst.items(), key=lambda kv: -kv[1])[:4]
    # each rank ran the asked schedule and moved activations point to point
    for r in res:
        assert r["kind"][0] == sched
        assert r["kind"][1]["sends"] > 0 and r["kind"][1]["staged_bytes"] == 0


def test_1f1b_gradients_equal_gpipe(ranks):
    """The reference's `test_1f1b_grads_match_gpipe_autodiff` (M = 8 at pp
    2, SGD lr 1: the update is the gradient)."""
    for r in ranks[2]:
        g = r["grads"]
        for n, want in g["gpipe"]["grads"].items():
            np.testing.assert_allclose(g["1f1b"]["grads"][n], want,
                                       rtol=1e-4, atol=1e-6, err_msg=n)


def test_1f1b_holds_at_most_s_minus_stage_microbatches(ranks):
    """GPipe keeps all M microbatches' activations alive on a stage; 1F1B
    at most S - stage (the reference's memory contract)."""
    for r in ranks[2]:
        g = r["grads"]
        assert g["gpipe"]["in_flight"] == 8
        assert g["1f1b"]["in_flight"] == 2 - g["stage"]
        assert r["pp2_1f1b"]["in_flight"] == 2 - r["pp2_1f1b"]["stage"]


@pytest.mark.parametrize("S,v,Mb", [(2, 2, 4), (4, 2, 8), (4, 4, 8),
                                     (2, 3, 6)])
def test_vpp_op_order_is_the_reference_schedule(S, v, Mb):
    """Each rank's program runs the forwards and the backwards in the
    order of the reference's `_vpp_schedule` tables, and its ticks never go
    back along the program."""
    tab = JP._vpp_schedule(S, v, Mb)
    for r in range(S):
        ops = TP.schedule_program("vpp", S, r, Mb, v)
        tick = {}
        for t in range(tab["T"]):
            for kind in ("f", "b"):
                if tab[f"{kind}_valid"][t, r]:
                    tick[(kind, int(tab[f"{kind}_chunk"][t, r]),
                          int(tab[f"{kind}_mb"][t, r]))] = t
        for kind in ("f", "b"):
            want = sorted((t, k) for k, t in tick.items() if k[0] == kind)
            assert [op for op in ops if op[0] == kind] == \
                [k for _, k in want]
        ticks = [tick[op] for op in ops]
        assert ticks == sorted(ticks)
        assert len(ops) == 2 * Mb * v


@pytest.mark.parametrize("sched", ["1f1b", "gpipe"])
def test_1f1b_and_gpipe_programs(sched):
    """Every (microbatch) forward and backward once, a backward after its
    forward; 1F1B warms up with S - 1 - stage forwards."""
    S, Mb = 4, 8
    for r in range(S):
        ops = TP.schedule_program(sched, S, r, Mb)
        assert sorted(ops) == sorted([("f", 0, m) for m in range(Mb)]
                                     + [("b", 0, m) for m in range(Mb)])
        for m in range(Mb):
            assert ops.index(("f", 0, m)) < ops.index(("b", 0, m))
        first_b = next(i for i, op in enumerate(ops) if op[0] == "b")
        assert first_b == (Mb if sched == "gpipe" else S - r)


def test_generic_forward_equals_serial_and_the_reference(ranks):
    """The reference's `test_spmd_pipeline_generic_fwd`: 8 tanh layers over
    pp 4, 4 microbatches, the outputs on every rank."""
    g = _generic_inputs()
    ref = g["x"]
    for i in range(FWD_L):
        ref = np.tanh(ref @ g["ws"][i])
    mesh = jmesh.build_mesh(pp=4, devices=np.asarray(jax.devices("cpu"))[:4])
    jmesh.set_mesh(mesh)
    try:
        def stage_fn(stage_ws, h):
            def body(carry, w):
                return jnp.tanh(carry @ w), None

            return jax.lax.scan(body, h, stage_ws)[0]

        want = np.asarray(JP.spmd_pipeline(
            stage_fn, jnp.asarray(g["ws"]),
            JP.microbatch(jnp.asarray(g["x"]), 4), mesh=mesh))
    finally:
        jmesh.set_mesh(None)
    for r in ranks[4]:
        got = r["fwd"]
        assert got.shape == (4, 2, FWD_D)
        np.testing.assert_allclose(got.reshape(8, FWD_D), ref, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_generic_vpp_matches_the_reference(ranks):
    """`spmd_pipeline_vpp` at pp 4 x v 2 on the reference's
    `test_loss_and_grads_match_serial` inputs: the loss, each rank's chunk
    gradients, the head's and the inputs' against the reference's."""
    g = _generic_inputs()
    S, v = VPP_S, VPP_V
    stacked = np.zeros((S, v, 1, VPP_D, VPP_D), np.float32)
    for r in range(S):
        for j in range(v):
            stacked[r, j, 0] = g["vws"][j * S + r]

    def stage_fn(params, x):
        def body(h, w):
            return jnp.tanh(h @ w), None

        return jax.lax.scan(body, x, params["W"])[0]

    def head_fn(hp, yact, tgt):
        lp = jax.nn.log_softmax(yact @ hp["W"])
        return -jnp.mean(jnp.take_along_axis(lp, tgt[:, None], axis=-1))

    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices("cpu")[:S]), ("pp",))
    with mesh:
        loss, d_sp, d_hp, d_x = JP.spmd_pipeline_vpp(
            stage_fn, {"W": jnp.asarray(stacked)}, jnp.asarray(g["xs"]),
            head_fn, {"W": jnp.asarray(g["head"])}, jnp.asarray(g["ys"]),
            num_chunks=v, mesh=mesh)
    for r in ranks[4]:
        got = r["vpp"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["d_sp"],
                                   np.asarray(d_sp["W"])[got["stage"]],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["d_hp"], np.asarray(d_hp["W"]),
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["d_x"], np.asarray(d_x), rtol=2e-4,
                                   atol=1e-6)


def test_generic_1f1b_matches_the_reference(ranks):
    """`spmd_pipeline_1f1b` at pp 4 (two tanh layers a stage) on the same
    inputs: the loss, each rank's gradients, the head's and the inputs'
    against the reference's."""
    g = _generic_inputs()
    S = VPP_S

    def stage_fn(params, x):
        def body(h, w):
            return jnp.tanh(h @ w), None

        return jax.lax.scan(body, x, params)[0]

    def head_fn(hp, yact, tgt):
        lp = jax.nn.log_softmax(yact @ hp)
        return -jnp.mean(jnp.take_along_axis(lp, tgt[:, None], axis=-1))

    mesh = jmesh.build_mesh(pp=S, devices=np.asarray(jax.devices("cpu"))[:S])
    jmesh.set_mesh(mesh)
    try:
        loss, d_sp, d_hp, d_x = JP.spmd_pipeline_1f1b(
            stage_fn, jnp.asarray(g["vws"]), jnp.asarray(g["xs"]), head_fn,
            jnp.asarray(g["head"]), jnp.asarray(g["ys"]), mesh=mesh)
    finally:
        jmesh.set_mesh(None)
    per = g["vws"].shape[0] // S
    for r in ranks[4]:
        got = r["1f1b"]
        s = got["stage"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["d_sp"],
                                   np.asarray(d_sp)[s * per:(s + 1) * per],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["d_hp"], np.asarray(d_hp), rtol=2e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["d_x"], np.asarray(d_x), rtol=2e-4,
                                   atol=1e-6)


def test_refusals_are_the_reference_s(ranks):
    for r in ranks[2]:
        got = r["refusals"]
        assert got["merge"].startswith("NotImplementedError: gradient_merge "
                                       "with the pipeline schedule")
        assert got["layout"].startswith("ValueError") and \
            "virtual_pp_degree" in got["layout"]
        assert got["unknown"] == ("ValueError: unknown pipeline schedule "
                                  "'zb'; use '1f1b', 'gpipe' or 'vpp'")
        assert got["vpp_no_m"].startswith(
            "ValueError: schedule='vpp' needs num_microbatches to be a "
            "multiple of pp=2")
        assert got["vpp_m"] == \
            "ValueError: VPP requires microbatches (3) % pp (2) == 0"
        assert got["layers"] == \
            "ValueError: 3 layers not divisible by pp*vpp=2*1"
        for k in ("forward", "generate"):
            assert got[k].startswith("NotImplementedError") and \
                "pipeline stage" in got[k], got[k]
    # ZeRO stage 2 at pp 2 x dp 2, once refused, now steps (the ZeRO axis
    # is "dp"; tests/test_torch_pp_sharding.py holds it to the reference)
    for r in ranks[4]:
        got = r["zero"]
        assert isinstance(got, dict), got
        assert (got["stage"], got["axis"]) == (2, "dp")
        assert np.isfinite(got["loss"])
    assert len({r["zero"]["loss"] for r in ranks[4]}) == 1
    with pytest.raises(ValueError) as port:
        TP.schedule_program("vpp", 4, 0, 6, 2)
    with pytest.raises(ValueError) as ref:
        JP._vpp_schedule(4, 2, 6)
    assert str(port.value) == str(ref.value)


def test_hybrid_communicate_group_knows_its_neighbours(ranks):
    """The stage, first / last, the previous and next stages' global ranks
    (Paddle's `_get_p2p_prev_rank` / `_get_p2p_next_rank`) and the pp
    group of each coordinate, on the mesh's layout ("pp" outermost)."""
    for r in ranks[2]:
        i = r["info_pp2"]
        assert (i["stage"], i["first"], i["last"], i["ranks"]) == \
            (i["rank"], i["rank"] == 0, i["rank"] == 1, [0, 1])
        assert i["next"] == i["prev"] == 1 - i["rank"]
    for tag, other in (("info_pp2_dp2", "dp_rank"), ("info_pp2_tp2",
                                                     "tp_rank")):
        for r in ranks[4]:
            i = r[tag]
            stage, c = divmod(i["rank"], 2)
            assert (i["stage"], i[other]) == (stage, c)
            assert i["ranks"] == [c, 2 + c]
            assert i["next"] == i["prev"] == i["ranks"][1 - stage]
            assert (i["first"], i["last"]) == (stage == 0, stage == 1)


def test_microbatch_and_stage_layout_are_the_reference_s():
    x = np.arange(48).reshape(8, 6)
    np.testing.assert_array_equal(
        TP.microbatch(__import__("torch").from_numpy(x), 4).numpy(),
        np.asarray(JP.microbatch(jnp.asarray(x), 4)))

    class _Layer:
        def __init__(self, i):
            self._i = i

        def named_parameters(self):
            class _P:
                _data = jnp.asarray([self._i])
            return [("w", _P)]

    for S, v, L in ((2, 1, 4), (2, 2, 4), (4, 2, 8), (2, 2, 8)):
        layers = [_Layer(i) for i in range(L)]
        if v == 1:
            want = np.asarray(JP.stack_layer_params(layers)["w"])[:, 0]
            want = want.reshape(S, -1)
        else:
            want = np.asarray(JP.vpp_stack_layer_params(layers, S, v)["w"])
            want = want.reshape(S, -1)
        for r in range(S):
            assert TP.stage_layer_ids(L, r, S, v) == want[r].tolist()
