"""Weight-only quantized tensor-parallel linears of the port against the
JAX package, on the CPU.

The port: two gloo ranks (`torch_tp_workers.quant_main`) quantize their
shards of a ColumnParallelLinear (no gather) into a RowParallelLinear
(`input_is_parallel`), both with biases, through `quantize_for_inference`
(int8 per channel, int8 in groups of 64, int4 in groups of 128), and a
tiny LLaMA built at tp 2 (int8 per channel, lm_head kept). The reference:
`weight_quantize` of the whole weights (the tp-1 quantization), and the
same layers under a tp-2 mesh of `conftest.py`'s CPU devices quantized by
its `quantize_for_inference` (`tests/test_quantization.py:436-478`).

Held: each rank's int8 / int4 weights and scales equal the slices of the
tp-1 quantization bit for bit (a column shard's columns; a row shard's
rows, its per-channel scales the whole column's, all_reduced MAX); the
tp-2 forward within 1e-6 of the reference's; a row shard whose rows split
a group, or an odd int4 shard, raising; a column shard with
`gather_output` returning every column.
"""
import jax
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as jmesh
from paddle_tpu.distributed.fleet.layers.mpu.mp_layers import \
    ColumnParallelLinear as JaxColumn
from paddle_tpu.distributed.fleet.layers.mpu.mp_layers import \
    RowParallelLinear as JaxRow
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn.quant import quantize_for_inference as jax_quantize
from paddle_tpu.nn.quant import weight_quantize as jax_weight_quantize
from paddle_tpu_torch.weights import tp_split_axis
from torch_dist_workers import run_group
from torch_parity import jax_state
from torch_tp_workers import quant_main

TP = 2
# a column linear 128 -> 256 into a row linear 256 -> 128: a row shard
# holds 128 rows, whole groups of 64 and 128
K1, N1, N2 = 128, 256, 128
SCHEMES = [("weight_only_int8", -1), ("weight_only_int8", 64),
           ("weight_only_int4", 128)]
# row linears whose shards split a group or an int4 byte: (in_features,
# algo, group_size)
STRADDLE = {"g64_of_192": (192, "weight_only_int8", 64),
            "g128_of_128": (128, "weight_only_int4", 128),
            "int4_of_6": (6, "weight_only_int4", -1)}
LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, max_position_embeddings=64)


def _case():
    rng = np.random.RandomState(13)

    def w(*shape, scale=0.05):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return dict(w=w(K1, N1), b=w(N1), w2=w(N1, N2), b2=w(N2),
                x=w(2, 4, K1, scale=1.0), schemes=SCHEMES, straddle=STRADDLE)


CASE = _case()


def _llama_state():
    paddle.seed(5)
    cfg = JaxLlamaConfig.tiny(vocab=128, hidden=64, layers=2, heads=4,
                              seq=64)
    return {k: v.copy() for k, v in jax_state(JaxLlama(cfg)).items()}


@pytest.fixture(scope="module")
def ranks():
    return sorted(run_group(quant_main, TP, CASE, _llama_state(), LLAMA),
                  key=lambda r: r["tp_rank"])


def _tp1(w, algo, gs):
    """The reference's quantization of the whole weight (numpy)."""
    import paddle_tpu as p

    q, s = jax_weight_quantize(p.to_tensor(w), algo=algo, group_size=gs)
    return np.asarray(q._data), np.asarray(s._data)


def _slice(a, r, axis):
    return np.split(a, TP, axis=axis)[r]


def _want(kind, w, algo, gs, r):
    """Rank r's slice of the tp-1 quantization of `w`: a column shard's
    columns, a row shard's rows (int4: packed rows; per-channel scales
    whole)."""
    q, s = _tp1(w, algo, gs)
    if kind == "column":
        return _slice(q, r, 1), _slice(s, r, s.ndim - 1)
    return _slice(q, r, 0), s if gs == -1 else _slice(s, r, 0)


@pytest.mark.parametrize("algo,gs", SCHEMES)
def test_shards_equal_slices_of_the_tp1_quantization(ranks, algo, gs):
    for r, res in enumerate(ranks):
        got = res["layers"][f"{algo}_{gs}"]
        assert got["types"] == ["WeightOnlyLinear", "WeightOnlyLinear"]
        for kind, w in (("col", CASE["w"]), ("row", CASE["w2"])):
            want = _want("column" if kind == "col" else "row", w, algo, gs,
                         r)
            for g, x in zip(got[kind], want):
                assert g.dtype == x.dtype and g.shape == x.shape
                np.testing.assert_array_equal(g, x, err_msg=(kind, r))


def _reference_forward(algo, gs):
    """The layers under a tp-2 mesh, quantized by the reference."""
    jmesh.set_mesh(None)
    jmesh.set_mesh(jmesh.build_mesh(
        tp=TP, devices=np.asarray(jax.devices("cpu")[:TP])))
    try:
        col = JaxColumn(K1, N1, has_bias=True, gather_output=False)
        row = JaxRow(N1, N2, has_bias=True, input_is_parallel=True)
        m = paddle.nn.Sequential(col, row)
        m.set_state_dict({"0.weight": CASE["w"], "0.bias": CASE["b"],
                          "1.weight": CASE["w2"], "1.bias": CASE["b2"]})
        jax_quantize(m, algo=algo, group_size=gs)
        return np.asarray(m(paddle.to_tensor(CASE["x"]))._data)
    finally:
        jmesh.set_mesh(None)


@pytest.mark.parametrize("algo,gs", SCHEMES)
def test_tp2_forward_matches_the_reference_mesh(ranks, algo, gs):
    """The pair's output (the row shard's partial products all_reduced,
    its bias added once) equal on both ranks and within 1e-6 of the
    reference's quantized layers under a tp-2 mesh."""
    want = _reference_forward(algo, gs)
    ys = [res["layers"][f"{algo}_{gs}"]["y"] for res in ranks]
    np.testing.assert_array_equal(ys[0], ys[1])
    np.testing.assert_allclose(ys[0], want, rtol=1e-6, atol=1e-6)


def test_quantize_for_inference_walks_the_mp_layers(ranks):
    """A tiny LLaMA built at tp 2: every linear but lm_head quantized into
    its shard, each equal to the slice of the tp-1 quantization."""
    state = _llama_state()
    for r, res in enumerate(ranks):
        got = res["model"]
        assert len(got) == 14 and "lm_head" not in got
        for name, (q, s, kind) in got.items():
            axis = tp_split_axis(name + ".weight")
            assert kind == ("column" if axis == 1 else "row"), name
            wq, ws = _want(kind, state[name + ".weight"],
                           "weight_only_int8", -1, r)
            np.testing.assert_array_equal(q, wq, err_msg=name)
            np.testing.assert_array_equal(s, ws, err_msg=name)


@pytest.mark.parametrize("name", sorted(STRADDLE))
def test_a_row_shard_that_splits_a_group_raises(ranks, name):
    k, algo, gs = STRADDLE[name]
    for res in ranks:
        msg = res["layers"]["straddle"][name]
        assert msg is not None and f"in_features {k // TP}" in msg
        assert f"of {k}" in msg


def test_a_gathered_column_shard_returns_every_column(ranks):
    q, s = _tp1(CASE["w"], "weight_only_int8", -1)
    want = CASE["x"] @ (q.astype(np.float32) * s) + CASE["b"]
    for res in ranks:
        assert res["layers"]["gathered"].shape == (2, 4, N1)
        np.testing.assert_allclose(res["layers"]["gathered"], want,
                                   rtol=1e-5, atol=1e-5)
