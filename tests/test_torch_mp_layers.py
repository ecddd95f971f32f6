"""The port's tensor-parallel layers against the JAX package's, on the CPU.

Two gloo ranks (`torch_tp_workers.mp_layers_main`, one group for the
module, started by `fleet.init` with mp_degree 2) hold their shards of the
same numpy weights as the reference's full-size layers, which run under a
tp = 2 mesh of the 8-device CPU mesh (`tests/conftest.py`). Each layer's
outputs and gradients, the ranks' shards joined, match the reference's
within 1e-5 and the port's own single-card layer (no mesh) within 1e-6,
f32: `ColumnParallelLinear` (both `gather_output`), `RowParallelLinear`
(both `input_is_parallel`), `VocabParallelEmbedding` (ids on both ranks'
rows) and `ParallelCrossEntropy` (rows labelled `ignore_index` included).
Also: the RNG tracker's streams, `HybridParallelClipGrad`'s norm of a tiny
GPT at tp 2 against the reference's `ClipGradByGlobalNorm` on the full
model (1e-6 relative; summing every square over tp, which counts the
replicated gradients twice, is caught), a model built from a seed at tp 2
(its shards joined are the tp = 1 model of that seed, bit for bit), and
`weights.py`'s shard and gather, bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as jmesh
from paddle_tpu.distributed.fleet.layers.mpu import mp_layers as JM
from paddle_tpu.framework import random as jrandom
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import ClipGradByGlobalNorm as JaxClip
from paddle_tpu_torch import weights as W
from paddle_tpu_torch.distributed.fleet.layers import mpu as TM
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.models.llama import LlamaConfig
from torch_dist_workers import run_group
from torch_parity import jax_state
from torch_tp_workers import (HID, IGNORE, IN, IN2, OUT, OUT2, SEEDED,
                              TOKENS, VOCAB, mp_layers_main, seeded_model)

SEED = 11
LAYERS = ["column_gather_True", "column_gather_False", "row_parallel_True",
          "row_parallel_False", "embedding", "cross_entropy"]
# how each result joins over the ranks: the axis of its shards, or None
# for a result every rank holds whole
JOIN = {
    "column_gather_True": dict(y=None, dx=None, dw=1, db=0),
    "column_gather_False": dict(y=-1, dx=None, dw=1, db=0),
    "row_parallel_True": dict(y=None, dx=-1, dw=0, db=None),
    "row_parallel_False": dict(y=None, dx=None, dw=0, db=None),
    "embedding": dict(y=None, dw=0),
    "cross_entropy": dict(loss=None, dlogits=-1),
}


def _case():
    rng = np.random.RandomState(SEED)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    labels = rng.randint(0, VOCAB, TOKENS)
    labels[0, 1] = labels[1, 3] = IGNORE
    return dict(w=f(IN, OUT), b=f(OUT), x=f(*TOKENS, IN), g=f(*TOKENS, OUT),
                w2=f(IN2, OUT2), b2=f(OUT2), x2=f(*TOKENS, IN2),
                g2=f(*TOKENS, OUT2), e=f(VOCAB, HID),
                ids=rng.randint(0, VOCAB, TOKENS), ge=f(*TOKENS, HID),
                logits=f(*TOKENS, VOCAB) * 3, labels=labels,
                gl=f(*TOKENS, 1))


def _gpt_state():
    paddle.seed(SEED)
    return jax_state(JaxGPT(JaxGPTConfig.tiny()))


def _batch():
    return np.random.RandomState(SEED + 1).randint(0, 128, (2, 16))


@pytest.fixture(scope="module")
def ranks():
    return run_group(mp_layers_main, 2, _case(), _gpt_state(), _batch(),
                     SEED)


def _joined(ranks, layer):
    out = {}
    for key, axis in JOIN[layer].items():
        parts = [r["layers"][layer][key] for r in ranks]
        if axis is None:
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0], err_msg=key)
            out[key] = parts[0]
        else:
            out[key] = np.concatenate(parts, axis=axis)
    return out


def _jax_results():
    c = _case()
    t = paddle.to_tensor
    jmesh.set_mesh(jmesh.build_mesh(
        tp=2, devices=np.asarray(jax.devices("cpu")[:2])))
    try:
        res = {}
        for gather in (True, False):
            lin = JM.ColumnParallelLinear(IN, OUT, has_bias=True,
                                          gather_output=gather)
            lin.set_state_dict({"weight": t(c["w"]), "bias": t(c["b"])})
            x = paddle.to_tensor(c["x"], stop_gradient=False)
            y = lin(x)
            (y * t(c["g"])).sum().backward()
            res[f"column_gather_{gather}"] = dict(
                y=y, dx=x.grad, dw=lin.weight.grad, db=lin.bias.grad)
        for parallel in (True, False):
            lin = JM.RowParallelLinear(IN2, OUT2, has_bias=True,
                                       input_is_parallel=parallel)
            lin.set_state_dict({"weight": t(c["w2"]), "bias": t(c["b2"])})
            x = paddle.to_tensor(c["x2"], stop_gradient=False)
            y = lin(x)
            (y * t(c["g2"])).sum().backward()
            res[f"row_parallel_{parallel}"] = dict(
                y=y, dx=x.grad, dw=lin.weight.grad, db=lin.bias.grad)
        emb = JM.VocabParallelEmbedding(VOCAB, HID)
        emb.set_state_dict({"weight": t(c["e"])})
        y = emb(t(c["ids"]))
        (y * t(c["ge"])).sum().backward()
        res["embedding"] = dict(y=y, dw=emb.weight.grad)
        logits = paddle.to_tensor(c["logits"], stop_gradient=False)
        loss = JM.ParallelCrossEntropy(ignore_index=IGNORE)(
            logits, t(c["labels"]))
        (loss * t(c["gl"])).sum().backward()
        res["cross_entropy"] = dict(loss=loss, dlogits=logits.grad)
    finally:
        jmesh.set_mesh(None)
    return {k: {n: np.asarray(v._data) for n, v in d.items()}
            for k, d in res.items()}


def _port_single_card():
    """The same cases through the port's layers with no mesh (degree 1)."""
    c = _case()
    res = {}

    def run(lin, x, g, **w):
        with torch.no_grad():
            for n, a in w.items():
                getattr(lin, n).copy_(torch.from_numpy(a))
        x = torch.tensor(x, requires_grad=True)
        y = lin(x)
        (y * torch.from_numpy(g)).sum().backward()
        return dict(y=y.detach().numpy(), dx=x.grad.numpy(),
                    dw=lin.weight.grad.numpy(), db=lin.bias.grad.numpy())

    for gather in (True, False):
        res[f"column_gather_{gather}"] = run(
            TM.ColumnParallelLinear(IN, OUT, has_bias=True,
                                    gather_output=gather, device="cpu"),
            c["x"], c["g"], weight=c["w"], bias=c["b"])
    for parallel in (True, False):
        res[f"row_parallel_{parallel}"] = run(
            TM.RowParallelLinear(IN2, OUT2, has_bias=True,
                                 input_is_parallel=parallel, device="cpu"),
            c["x2"], c["g2"], weight=c["w2"], bias=c["b2"])
    emb = TM.VocabParallelEmbedding(VOCAB, HID, device="cpu")
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(c["e"]))
    y = emb(torch.from_numpy(c["ids"]))
    (y * torch.from_numpy(c["ge"])).sum().backward()
    res["embedding"] = dict(y=y.detach().numpy(), dw=emb.weight.grad.numpy())
    logits = torch.tensor(c["logits"], requires_grad=True)
    loss = TM.ParallelCrossEntropy(ignore_index=IGNORE)(
        logits, torch.from_numpy(c["labels"]))
    (loss * torch.from_numpy(c["gl"])).sum().backward()
    res["cross_entropy"] = dict(loss=loss.detach().numpy(),
                                dlogits=logits.grad.numpy())
    return res


@pytest.fixture(scope="module")
def references():
    return _jax_results(), _port_single_card()


@pytest.mark.parametrize("layer", LAYERS)
def test_layer_at_tp2_matches_the_reference_and_tp1(ranks, references,
                                                    layer):
    got = _joined(ranks, layer)
    want, single = references[0][layer], references[1][layer]
    for key, g in got.items():
        np.testing.assert_allclose(g, want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=f"{layer}.{key} vs reference")
        np.testing.assert_allclose(g, single[key], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{layer}.{key} vs tp 1")
    if layer == "cross_entropy":
        ignored = _case()["labels"] == IGNORE
        assert (got["loss"][ignored] == 0).all()
        assert (got["dlogits"][ignored] == 0).all()


def test_sharded_parameters_are_distributed(ranks):
    for r in ranks:
        lay = r["layers"]
        assert lay["column_gather_True"]["distributed"] == (True, True)
        assert lay["row_parallel_False"]["distributed"] == (True, False)


def test_rng_tracker_streams_and_seeds(ranks):
    """global_seed equal on both ranks, local_seed different, each seeded
    as the reference's `model_parallel_random_seed` seeds its streams; the
    tracker's states replay."""
    a, b = (r["rng"] for r in sorted(ranks, key=lambda r: r["tp_rank"]))
    assert a["global_seed"] == b["global_seed"]
    np.testing.assert_array_equal(a["global_seed_mask"],
                                  b["global_seed_mask"])
    assert a["local_seed"] != b["local_seed"]
    assert not np.array_equal(a["local_seed_mask"], b["local_seed_mask"])
    for r, got in enumerate((a, b)):
        jrandom.model_parallel_random_seed(SEED, r)
        want = {n: s._seed for n, s in
                jrandom.get_rng_state_tracker().states_.items()}
        assert got["seeds"] == want
        assert got["replayed"][0] == got["replayed"][1]
    jrandom.get_rng_state_tracker().reset()


def test_clip_norm_is_the_whole_models(ranks):
    """HybridParallelClipGrad at tp 2 against the reference's
    ClipGradByGlobalNorm over the full model's gradients (1e-6
    relative); a norm that sums every square over tp is off."""
    paddle.seed(SEED)
    jm = JaxGPT(JaxGPTConfig.tiny())
    x = paddle.to_tensor(_batch())
    jm.compute_loss(jm(x), x).backward()
    want = float(JaxClip(1.0).global_norm([p.grad for p in jm.parameters()]))
    for r in ranks:
        assert abs(r["clip"]["norm"] - want) <= 1e-6 * want
        assert abs(r["clip"]["all_summed"] - want) > 1e-3 * want


@pytest.mark.parametrize("family,tie", SEEDED)
def test_model_built_from_a_seed_at_tp2_is_the_tp1_model(ranks, family,
                                                          tie):
    """A model's own seeded init at tp 2: the two ranks' shards joined are
    the tp = 1 model of the same seed, bit for bit (each rank holds its
    slice of the full draw, not a copy of one block)."""
    one = seeded_model(family, tie, SEED)
    to_numpy, gather = ((W.llama_state_to_numpy, W.gather_llama_state)
                        if family == "llama" else
                        (W.gpt_state_to_numpy, W.gather_gpt_state))
    want = to_numpy(one)
    shards = [r["seeded"][f"{family}_{tie}"]
              for r in sorted(ranks, key=lambda r: r["tp_rank"])]
    got = gather(shards, one.config)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    split = [n for n in want if W.tp_split_axis(n) is not None
             and want[n].ndim == 2]
    assert split and all(not np.array_equal(shards[0][n], shards[1][n])
                         for n in split)


def _llama_state(tie):
    paddle.seed(SEED)
    cfg = JaxLlamaConfig.tiny(vocab=128, hidden=64, layers=2, heads=4)
    cfg.tie_word_embeddings = tie
    return jax_state(JaxLlama(cfg))


@pytest.mark.parametrize("family,tie,tp", [
    ("llama", False, 2), ("llama", True, 4), ("gpt", True, 2),
    ("gpt", False, 4)])
def test_weights_shard_then_gather_is_the_full_state(family, tie, tp):
    if family == "llama":
        cfg = LlamaConfig.tiny(vocab=128, hidden=64, layers=2, heads=4)
        cfg.tie_word_embeddings = tie
        state = _llama_state(tie)
        shard, gather = W.llama_state_from_numpy, W.gather_llama_state
    else:
        cfg = GPTConfig.tiny()
        cfg.tie_word_embeddings = tie
        paddle.seed(SEED)
        jcfg = JaxGPTConfig.tiny()
        jcfg.tie_word_embeddings = tie
        state = jax_state(JaxGPT(jcfg))
        shard, gather = W.gpt_state_from_numpy, W.gather_gpt_state
    parts = [{n: t.numpy() for n, t in shard(
        state, cfg, device="cpu", tp_rank=r, tp_degree=tp).items()}
        for r in range(tp)]
    for n, a in parts[0].items():
        ax = W.tp_split_axis(n)
        if ax is not None:
            assert a.shape[ax] * tp == state[n].shape[ax], n
    back = gather(parts, cfg)
    assert sorted(back) == sorted(state)
    for n, a in state.items():
        np.testing.assert_array_equal(back[n], a, err_msg=n)
    parts[1][next(n for n in state if W.tp_split_axis(n) is None)] += 1.0
    with pytest.raises(ValueError, match="replicated"):
        gather(parts, cfg)
