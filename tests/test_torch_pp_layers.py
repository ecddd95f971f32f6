"""`PipelineLayer`, `PipelineParallel` and the pipelined models in the port
against the JAX package, on the CPU.

Single process: `PipelineLayer._partition` (the stage of each entry)
equal to the reference's for the "uniform" and "layer:<Name>" methods;
`LayerDesc`'s refusal. On gloo ranks (`torch_pp_workers.pp_runs_main`):
- `fleet.distributed_model` at pp_degree 2 over a LLaMA built under the
  mesh gives `PipelineParallel`; its `train_batch` (AdamW through
  `fleet.distributed_optimizer`, 4 accumulate steps) against the
  reference's `PipelineParallel.train_batch` on the whole LLaMA;
- a `PipelineLayer` with a `SharedLayerDesc` (a linear tied to the last
  entry, transposed) at pp 2 through `train_batch` (SGD) against the
  reference's `PipelineLayer` under its `PipelineParallel`, the shared
  weight equal on both stages, `eval_batch`'s loss and outputs;
- GPT with its tied embedding at pp 2 and pp 4 (the tie then spans the
  first and last of four stages) through `build_train_step` against the
  reference's pipelined step;
- models built from their own seed at pp 2 (and pp 2 x tp 2, and the
  interleaved layout) equal to the slice of the pp = 1 model of the seed;
- `paddle_tpu_torch.save` of a stage's state: one file a rank.
Losses at the reference's rtol 2e-4, atol 2e-5 (`tests/test_pipeline.py:
51`), parameters joined over the stages within 3e-5 of the reference's,
each tensor's difference over its norm (`tests/test_torch_pipeline.py`
says where that bar comes from).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as jmesh
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet import meta_parallel as JMP
from paddle_tpu.models import build_train_step as jax_build_train_step
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import weights as W
from paddle_tpu_torch.distributed.fleet import meta_parallel as TMP
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from torch_parity import jax_state
from torch_pp_workers import (GPT_TINY, LR, TINY, layer_descs, pp_runs_main,
                              start_groups)

SEED, M = 5, 4
PARAM_BAR = 3e-5


def _batch():
    rng = np.random.RandomState(3)
    return rng.randint(0, 64, (8, 16)), rng.randint(0, 64, (8, 16))


def _layer_data():
    rng = np.random.RandomState(4)
    weights = {i: (rng.randn(8, 8) * 0.4).astype(np.float32)
               for i in (0, 2, 4)}
    return weights, rng.randn(8, 8).astype(np.float32), \
        rng.randint(0, 8, (8,))


def _jax_llama():
    paddle.seed(SEED)
    return JaxLlama(JaxLlamaConfig.tiny(layers=4, **TINY))


def _jax_gpt(layers):
    paddle.seed(SEED)
    return JaxGPT(JaxGPTConfig.tiny(layers=layers, **GPT_TINY))


def _state(model):
    return {k: v.copy() for k, v in jax_state(model).items()}


def _port_runs(world):
    x, y = _batch()
    if world == 2:
        w, lx, ly = _layer_data()
        return [
            ("fleet", "train", dict(state=_state(_jax_llama()), x=x, y=y,
                                    steps=2, M=M, how="fleet")),
            ("gpt_pp2", "train", dict(state=_state(_jax_gpt(4)), x=x, y=y,
                                      steps=3, M=M, family="gpt")),
            ("layer", "layer", dict(weights=w, x=lx, y=ly, M=M)),
            ("scaler_clip", "scaler_clip", dict(weights=w, x=lx, y=ly,
                                                M=M)),
            ("seed_llama", "seeded", dict(family="llama", layers=4,
                                          seed=11)),
            ("seed_llama_tied", "seeded", dict(family="llama", layers=4,
                                               seed=11, tie=True)),
            ("seed_llama_vpp", "seeded", dict(family="llama", layers=4,
                                              seed=11, v=2)),
            ("seed_gpt", "seeded", dict(family="gpt", layers=4, seed=11)),
            ("save", "save", dict(state=_state(_jax_llama())))]
    return [
        ("gpt_pp4", "train", dict(state=_state(_jax_gpt(4)), x=x, y=y,
                                  steps=3, M=M, family="gpt", pp=4)),
        ("seed_gpt_pp4", "seeded", dict(family="gpt", layers=4, seed=11,
                                        pp=4)),
        ("seed_llama_tp2", "seeded", dict(family="llama", layers=4,
                                          seed=11, tp=2))]


@pytest.fixture(scope="module")
def started():
    """The rank groups, started in the background: the reference runs
    meanwhile."""
    return start_groups(pp_runs_main, {w: _port_runs(w) for w in (2, 4)})


def _jax_fleet():
    """The reference's PipelineParallel.train_batch on the whole LLaMA (its
    loss the model's `compute_loss`), 4 accumulate steps, eager AdamW."""
    model = _jax_llama()
    model._loss_fn = model.compute_loss
    s = jfleet.DistributedStrategy()
    s.pipeline_configs = dict(s.pipeline_configs, accumulate_steps=M)
    pp = JMP.PipelineParallel(model, None, s)
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters())
    x, y = _batch()
    losses = [float(pp.train_batch((paddle.to_tensor(x),
                                    paddle.to_tensor(y)), opt))
              for _ in range(2)]
    return losses, jax_state(model)


def _jax_gpt_run(pp):
    model = _jax_gpt(4)
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters())
    x, y = _batch()
    jmesh.set_mesh(None)
    mesh = jmesh.set_mesh(jmesh.build_mesh(
        pp=pp, devices=np.asarray(jax.devices("cpu")[:pp])))
    try:
        step = jax_build_train_step(model, opt, mesh=mesh,
                                    num_microbatches=M)
        losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
                  for _ in range(3)]
        step.sync_to_model()
    finally:
        jmesh.set_mesh(None)
    return losses, jax_state(model)


def _jax_layer():
    """The reference's PipelineLayer (the same entries, its classes) under
    its PipelineParallel.train_batch, SGD 0.1."""
    w, x, y = _layer_data()
    tied = lambda layer, h: paddle.matmul(  # noqa: E731
        h, layer.weight, transpose_y=True)
    descs = [JMP.SharedLayerDesc("tie", paddle.nn.Linear, None, "weight", 8,
                                 8, bias_attr=False),
             paddle.tanh, JMP.LayerDesc(paddle.nn.Linear, 8, 8,
                                        bias_attr=False), paddle.tanh,
             JMP.LayerDesc(paddle.nn.Linear, 8, 8, bias_attr=False),
             paddle.tanh,
             JMP.SharedLayerDesc("tie", paddle.nn.Linear, tied, "weight", 8,
                                 8, bias_attr=False)]
    layer = JMP.PipelineLayer(descs, num_stages=2,
                              loss_fn=paddle.nn.functional.cross_entropy)
    for i, arr in w.items():
        layer.run_function[i][0].weight.set_value(arr)
    s = jfleet.DistributedStrategy()
    s.pipeline_configs = dict(s.pipeline_configs, accumulate_steps=M)
    pp = JMP.PipelineParallel(layer, None, s)
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=layer.parameters())
    data = (paddle.to_tensor(x), paddle.to_tensor(y))
    losses = [float(pp.train_batch(data, opt)) for _ in range(2)]
    held = {i: np.asarray(layer.run_function[i][0].weight._data)
            for i in w}
    out = np.asarray(layer(data[0])._data)
    return dict(losses=losses, held=held, segments=layer._segments,
                eval=float(paddle.nn.functional.cross_entropy(
                    layer(data[0]), data[1])), outs=out)


@pytest.fixture(scope="module")
def reference(started):
    return dict(fleet=_jax_fleet(), gpt_pp2=_jax_gpt_run(2),
                gpt_pp4=_jax_gpt_run(4), layer=_jax_layer())


@pytest.fixture(scope="module")
def ranks(started, reference):
    return started()


def _worst(got, want):
    worst = {n: float(np.linalg.norm(got[n] - w) / np.linalg.norm(w))
             for n, w in want.items()}
    return max(worst.values()), sorted(worst.items(), key=lambda kv: -kv[1])


# ---------------------------------------------------------------------------
# single process: the stage assignment


def _classes(base, init):
    return {n: type(n, (base,), {"__init__": init})
            for n in ("Embed", "Block", "Norm", "Head")}


def _descs(pkg_desc, classes, names):
    return [pkg_desc(classes[n]) for n in names]


@pytest.mark.parametrize("seg", ["uniform", "layer:Block", "layer:Norm"])
@pytest.mark.parametrize("blocks", [2, 3, 5, 8])
@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_partition_is_the_reference_s(seg, blocks, stages):
    names = ["Embed"] + ["Block"] * blocks + ["Norm", "Head"]
    jc = _classes(paddle.nn.Layer, lambda self: paddle.nn.Layer.__init__(
        self))
    tc = _classes(torch.nn.Module, lambda self: torch.nn.Module.__init__(
        self))
    want = JMP.PipelineLayer(_descs(JMP.LayerDesc, jc, names),
                             num_stages=stages, seg_method=seg)
    got = TMP.PipelineLayer(_descs(TMP.LayerDesc, tc, names),
                            num_stages=stages, seg_method=seg)
    assert got._segments == want._segments
    for s in range(stages):
        assert [type(l).__name__ for l, _ in got.get_stage_layers(s)] == \
            [type(l).__name__ for l, _ in want.get_stage_layers(s)]


def test_layer_desc_refuses_a_non_layer_as_the_reference():
    for desc in (JMP.LayerDesc, TMP.LayerDesc):
        with pytest.raises(TypeError, match="nn.Layer subclass"):
            desc(int)


# ---------------------------------------------------------------------------
# gloo ranks


def test_fleet_train_batch_matches_the_reference(ranks, reference):
    res = [r["fleet"] for r in ranks[2]]
    assert {r["kind"] for r in res} == {("PipelineParallel",
                                         "HybridParallelOptimizer")}
    want_losses, want_state = reference["fleet"]
    assert res[0]["losses"] == res[1]["losses"]
    np.testing.assert_allclose(res[0]["losses"], want_losses, rtol=2e-4,
                               atol=2e-5)
    got = W.gather_llama_state([r["state"] for r in res],
                               LlamaConfig.tiny(layers=4, **TINY))
    worst, top = _worst(got, want_state)
    assert worst <= PARAM_BAR, top[:4]


@pytest.mark.parametrize("tag", ["gpt_pp2", "gpt_pp4"])
def test_gpt_with_its_tied_embedding_matches_the_reference(ranks, reference,
                                                           tag):
    res = [r[tag] for r in ranks[2 if tag == "gpt_pp2" else 4]]
    want_losses, want_state = reference[tag]
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
    np.testing.assert_allclose(res[0]["losses"], want_losses, rtol=2e-4,
                               atol=2e-5)
    # the tied embedding: on the first and the last stage, equal
    holders = [r for r in res if "gpt.embed_tokens.weight" in r["state"]]
    assert sorted(r["stage"] for r in holders) == [0, len(res) - 1]
    got = W.gather_gpt_state([r["state"] for r in res],
                             GPTConfig.tiny(layers=4, **GPT_TINY))
    want_state = dict(want_state)
    # the key part of GPT's fused QKV bias has a zero gradient in exact
    # arithmetic (it shifts a query's every logit alike), so Adam moves
    # each element by the sign of rounding noise, at most lr a step
    # (tests/test_torch_tensor_parallel.py holds it so too)
    h, d = GPT_TINY["hidden"], GPT_TINY["hidden"] // GPT_TINY["heads"]
    key = (np.arange(3 * h) % (3 * d)) // d == 1
    for n in [n for n in want_state if n.endswith("qkv_proj.bias")]:
        for a in (got[n], want_state[n]):
            assert np.abs(a[key]).max() <= 3 * LR * 1.001, n
        got[n], want_state[n] = got[n][~key], want_state[n][~key]
    worst, top = _worst(got, want_state)
    assert worst <= PARAM_BAR, top[:4]


def test_pipeline_layer_train_batch_matches_the_reference(ranks, reference):
    want = reference["layer"]
    res = sorted((r["layer"] for r in ranks[2]), key=lambda r: r["stage"])
    assert [r["model"] for r in res] == ["PipelineParallel"] * 2
    assert res[0]["segments"] == want["segments"]
    assert [r["by_stage"] for r in res] == [[0], [1]]
    for r in res:
        assert r["losses"] == res[0]["losses"]
        np.testing.assert_allclose(r["eval"], want["eval"], rtol=1e-5)
    np.testing.assert_allclose(res[0]["losses"], want["losses"], rtol=2e-4,
                               atol=2e-5)
    # stage 0 holds entries 0 (the shared linear) and 2, stage 1 entry 4
    # and the shared linear again: equal on both after the updates
    assert sorted(res[0]["held"]) == [0, 2] and sorted(res[1]["held"]) == \
        [0, 4]
    np.testing.assert_array_equal(res[0]["held"][0], res[1]["held"][0])
    for i, arr in want["held"].items():
        got = res[0]["held"].get(i, res[1]["held"].get(i))
        np.testing.assert_allclose(got, arr, rtol=1e-5, atol=1e-6)
    assert res[0]["outs"] is None
    np.testing.assert_allclose(res[1]["outs"], want["outs"], rtol=1e-5,
                               atol=1e-6)


def test_clip_and_scaler_span_the_stages(ranks):
    """The hybrid clip's norm over both stages equals the norm of the
    whole layer's gradients in one process (the shared linear counted
    once), on both ranks; an inf in stage 1's gradient makes both stages
    skip the update and halve the scale."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.nn import Linear

    w, x, y = _layer_data()
    torch.manual_seed(0)
    layer = TMP.PipelineLayer(layer_descs(TMP.LayerDesc, TMP.SharedLayerDesc,
                                          Linear), num_stages=2)
    with torch.no_grad():
        for i, arr in w.items():
            layer.run_function[i][0].weight.copy_(torch.from_numpy(arr))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    loss = sum(TF.cross_entropy(layer(xt[m * 2:(m + 1) * 2]),
                                yt[m * 2:(m + 1) * 2]) / M for m in range(M))
    loss.backward()
    want = float(torch.sqrt(sum(p.grad.double().square().sum()
                                for p in layer.parameters())))
    for r in ranks[2]:
        got = r["scaler_clip"]
        np.testing.assert_allclose(got["norm"], want, rtol=1e-5)
        assert got["skipped"] and got["scale"] == 512.0


def _pp1(family, seed, tie=None, layers=4):
    if family == "llama":
        cfg = LlamaConfig.tiny(layers=layers, **TINY)
        cls, to_numpy = LlamaForCausalLM, W.llama_state_to_numpy
    else:
        cfg = GPTConfig.tiny(layers=layers, **GPT_TINY)
        cls, to_numpy = GPTForCausalLM, W.gpt_state_to_numpy
    if tie is not None:
        cfg.tie_word_embeddings = tie
    return to_numpy(cls(cfg, device="cpu", seed=seed))


@pytest.mark.parametrize("tag,family,tie,world", [
    ("seed_llama", "llama", None, 2), ("seed_llama_tied", "llama", True, 2),
    ("seed_llama_vpp", "llama", None, 2), ("seed_gpt", "gpt", None, 2),
    ("seed_gpt_pp4", "gpt", None, 4), ("seed_llama_tp2", "llama", None, 4)])
def test_model_built_from_a_seed_at_pp_is_the_pp1_model(ranks, tag, family,
                                                        tie, world):
    want = _pp1(family, 11, tie)
    states = [r[tag] for r in ranks[world]]
    cfg = (LlamaConfig if family == "llama" else GPTConfig).tiny(
        layers=4, **(TINY if family == "llama" else GPT_TINY))
    if tie is not None:
        cfg.tie_word_embeddings = tie
    gather = W.gather_llama_state if family == "llama" else \
        W.gather_gpt_state
    got = gather(states, cfg)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    if tag == "seed_llama_vpp":  # rank r holds logical stages r and 2 + r
        held = {r[W.PP_KEY]["stage"]: sorted(
            {int(n.split(".")[2]) for n in r if ".layers." in n})
            for r in states}
        assert held == {0: [0, 2], 1: [1, 3]}


def test_save_writes_one_file_a_stage(ranks):
    res = [r["save"] for r in ranks[2]]
    assert all(r["equal"] for r in res)
    names = [set(r["names"]) for r in res]
    assert not names[0] & names[1]
    full = set(W.llama_param_shapes(LlamaConfig.tiny(layers=4, **TINY)))
    assert names[0] | names[1] == full
    assert "llama.embed_tokens.weight" in names[0] and \
        "lm_head.weight" in names[1]
