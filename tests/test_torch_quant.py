"""The port's weight-only quantization against the JAX package, on the CPU.

`nn.quant.weight_quantize` must give int8 values and f32 scales
bit-identical to the reference's numpy code; `unpack_int4` and `dequantize`
are exact; the plain dequant-matmul `quant_matmul_ref` agrees with the
reference's `quant_matmul_xla` and with its Pallas kernel in interpret mode
within 1e-5 of the output's norm (both dequantize to the same f32 weight;
only the summation order differs), well inside the reference's own
1e-2 / 3e-2 bars; and a quantized tiny LLaMA, with the JAX model's int8
buffers carried across by `weights.py`, gives the JAX model's logits within
1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import quant_matmul as jqm
from paddle_tpu.nn import quant as jquant
from paddle_tpu_torch.kernels import quant_matmul as tqm
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import quant as tquant
from paddle_tpu_torch.weights import (llama_state_from_numpy,
                                      llama_state_to_numpy, load_llama_state)
from torch_parity import jax_state, tiny_pair

_ALGOS = ("weight_only_int8", "weight_only_int4")
_WD = {"weight_only_int8": "int8", "weight_only_int4": "int4"}


def _weight(k, n, seed=0, bf16=False):
    w = np.random.RandomState(seed).randn(k, n).astype(np.float32) * 0.05
    if bf16:  # weights a bf16 model holds
        w = torch.from_numpy(w).bfloat16().float().numpy()
    return w


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("gs", [-1, 64, 128])
@pytest.mark.parametrize("algo", _ALGOS)
def test_weight_quantize_is_bit_identical(algo, gs, bf16):
    w = _weight(256, 384, seed=gs + 2, bf16=bf16)
    jq, js = jquant.weight_quantize(paddle.to_tensor(w), algo=algo,
                                    group_size=gs)
    tq, ts = tquant.weight_quantize(torch.from_numpy(w), algo, group_size=gs)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq.numpy())
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  js.numpy().view(np.uint32))


def test_weight_quantize_of_a_bf16_tensor_upcasts_first():
    w = _weight(128, 128, bf16=True)
    a = tquant.weight_quantize(torch.from_numpy(w).bfloat16(),
                               "weight_only_int4", group_size=64)
    b = tquant.weight_quantize(torch.from_numpy(w), "weight_only_int4",
                               group_size=64)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_unpack_int4_is_exact():
    rng = np.random.RandomState(3)
    q = rng.randint(-7, 8, (64, 128)).astype(np.int8)
    packed = ((q[0::2] & 0xF) | (q[1::2] << 4)).astype(np.int8)
    got = tqm.unpack_int4(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, q)
    np.testing.assert_array_equal(
        got, np.asarray(jqm.unpack_int4(jnp.asarray(packed))))
    # every byte value, including nibble -8
    every = np.arange(-128, 128, dtype=np.int8).reshape(128, 2)
    np.testing.assert_array_equal(
        tqm.unpack_int4(torch.from_numpy(every)).numpy(),
        np.asarray(jqm.unpack_int4(jnp.asarray(every))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gs", [-1, 64, 128])
@pytest.mark.parametrize("algo", _ALGOS)
def test_dequantize_is_exact(algo, gs, dtype):
    w = _weight(256, 128, seed=5)
    jq, js = jquant.weight_quantize(paddle.to_tensor(w), algo=algo,
                                    group_size=gs)
    want = np.asarray(jqm.dequantize(jnp.asarray(jq.numpy()),
                                     jnp.asarray(js.numpy()), _WD[algo],
                                     jnp.dtype(dtype))).astype(np.float32)
    got = tqm.dequantize(torch.tensor(jq.numpy()),
                         torch.tensor(js.numpy()), _WD[algo],
                         getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(got, want)
    deq = tquant.weight_dequantize(torch.tensor(jq.numpy()),
                                   torch.tensor(js.numpy()), algo, gs)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jquant.weight_dequantize(
            jq, js, algo=algo, group_size=gs).numpy()))


@pytest.mark.parametrize("m,k,n", [(8, 256, 384), (33, 128, 256)])
@pytest.mark.parametrize("gs", [-1, 64, 128])
@pytest.mark.parametrize("algo", _ALGOS)
def test_quant_matmul_ref_matches_xla_and_pallas(algo, gs, m, k, n):
    wd = _WD[algo]
    jq, js = jquant.weight_quantize(paddle.to_tensor(_weight(k, n, seed=m)),
                                    algo=algo, group_size=gs)
    qw, sc = jnp.asarray(jq.numpy()), jnp.asarray(js.numpy())
    x = np.random.RandomState(1).randn(m, k).astype(np.float32)
    got = tqm.quant_matmul_ref(torch.from_numpy(x),
                               torch.tensor(jq.numpy()),
                               torch.tensor(js.numpy()), wd).numpy()
    xla = np.asarray(jqm.quant_matmul_xla(jnp.asarray(x), qw, sc, wd))
    bn, bk = next((bn, bk) for bn in jqm.BLOCK_GRID_N
                  for bk in jqm.BLOCK_GRID_K
                  if jqm.supports(m, k, n, wd, gs, bn, bk))
    pallas = np.asarray(jqm.quant_matmul_fused(jnp.asarray(x), qw, sc, wd,
                                               gs, bn, bk))
    for want in (xla, pallas):
        assert _rel(got, want) <= 1e-5
        np.testing.assert_allclose(got, want, atol=1e-2 if wd == "int8"
                                   else 3e-2)
    # the public entry takes leading dims and the plain path on the CPU
    y = tqm.quant_matmul(torch.from_numpy(x).reshape(1, m, k),
                         torch.tensor(jq.numpy()),
                         torch.tensor(js.numpy()), wd, gs)
    np.testing.assert_array_equal(y.reshape(m, n).numpy(), got)


def _ref_parity(algo, gs, m, k, n, pallas):
    """quant_matmul_ref against the reference's quant_matmul_xla and, with
    `pallas`, its Pallas kernel in interpret mode."""
    wd = _WD[algo]
    jq, js = jquant.weight_quantize(paddle.to_tensor(_weight(k, n, seed=m)),
                                    algo=algo, group_size=gs)
    qw, sc = jnp.asarray(jq.numpy()), jnp.asarray(js.numpy())
    x = np.random.RandomState(2).randn(m, k).astype(np.float32)
    got = tqm.quant_matmul_ref(torch.from_numpy(x),
                               torch.tensor(jq.numpy()),
                               torch.tensor(js.numpy()), wd).numpy()
    wants = [np.asarray(jqm.quant_matmul_xla(jnp.asarray(x), qw, sc, wd))]
    if pallas:
        bn, bk = next((bn, bk) for bn in jqm.BLOCK_GRID_N
                      for bk in jqm.BLOCK_GRID_K
                      if jqm.supports(m, k, n, wd, gs, bn, bk))
        wants.append(np.asarray(jqm.quant_matmul_fused(
            jnp.asarray(x), qw, sc, wd, gs, bn, bk)))
    for want in wants:
        assert _rel(got, want) <= 1e-5
        np.testing.assert_allclose(got, want, atol=1e-2 if wd == "int8"
                                   else 3e-2)


@pytest.mark.parametrize("m", [129, 200])
@pytest.mark.parametrize("algo,gs", [("weight_only_int8", -1),
                                     ("weight_only_int4", 128)])
def test_quant_matmul_ref_matches_the_reference_at_prefill_m(algo, gs, m):
    """Row counts past one 128-row tile of the prefill kernel (a ragged
    last tile), against the XLA reference and the Pallas kernel."""
    _ref_parity(algo, gs, m, 256, 256, pallas=True)


@pytest.mark.parametrize("algo,gs", [("weight_only_int8", -1),
                                     ("weight_only_int4", 128)])
def test_quant_matmul_ref_matches_xla_above_the_reference_cap(algo, gs):
    """m = 1100 lies above the reference's single m block (`_MAX_M`): the
    reference gives it to XLA, the port's kernel takes it."""
    assert not jqm.supports(1100, 256, 256, _WD[algo], gs)
    assert tqm.supports(1100, 256, 256, _WD[algo], gs)
    _ref_parity(algo, gs, 1100, 256, 256, pallas=False)


@pytest.mark.parametrize("m,k,n,sms", [
    (2512, 5120, 5120, 132), (2512, 5120, 13824, 132),
    (2512, 13824, 5120, 132), (17, 512, 384, 132), (129, 13824, 128, 132),
    (1100, 1024, 5120, 20), (4096, 4096, 11008, 114)])
def test_prefill_schedule_walks_every_tile_once(m, k, n, sms):
    """The prefill kernel's persistent walk (`prefill_tile`, the kernel's
    `tile_of`) visits every 128 x 128 output tile exactly once, in bands
    of row tiles whose x rows fit the band budget, the band's row tiles
    fastest; the grid is one block per SM or per tile."""
    sch = tqm.prefill_schedule(m, k, n, sms)
    tm, tn = sch["tiles_m"], sch["tiles_n"]
    assert (tm, tn) == (-(-m // 128), n // 128)
    assert sch["grid"] == min(tm * tn, sms)
    assert sch["rounds"] == pytest.approx(tm * tn / sch["grid"])
    g = sch["group_m"]
    assert 1 <= g <= tm
    assert g == tm or g * 128 * k * 2 <= tqm._BAND_BYTES
    walk = [tqm.prefill_tile(t, tm, tn, g) for t in range(tm * tn)]
    assert sorted(walk) == [(i, j) for i in range(tm) for j in range(tn)]
    assert walk[:min(g, tm)] == [(i, 0) for i in range(min(g, tm))]
    # each block's tiles: blockIdx.x, + grid, ...; together all of them
    mine = [t for b in range(sch["grid"])
            for t in range(b, tm * tn, sch["grid"])]
    assert sorted(mine) == list(range(tm * tn))


def test_prefill_schedule_at_the_13b_shapes():
    """LLaMA-2-13B's projections at a 2500-token prefill on 132 SMs: 800
    tiles (6.06 rounds) at n = 5120, 2160 (16.36) at n = 13824."""
    for (k, n), tiles in (((5120, 5120), 800), ((5120, 13824), 2160),
                          ((13824, 5120), 800)):
        sch = tqm.prefill_schedule(2512, k, n, 132)
        assert sch["tiles_m"] * sch["tiles_n"] == tiles
        assert sch["grid"] == 132
        assert sch["rounds"] == pytest.approx(tiles / 132)


@pytest.mark.parametrize("k,n,units,grid", [
    (5120, 5120, 1600, 120), (5120, 13824, 4320, 108),
    (13824, 5120, 4320, 120)])
def test_decode_split_at_the_13b_shapes(k, n, units, grid):
    """The decode kernel (bf16 x, m <= 16) at LLaMA-2-13B's projections on
    132 SMs: 40 or 108 column tiles of 128 times stages of 128 k rows (40
    or 108), every tile cut into the same number of equal k ranges (3, 1
    and 3), so that the blocks of one range read the same weight rows at
    once; 120 or 108 of the 132 SMs each stream 13-40 stages of 16 KB of
    int8, and every column tile's stages are walked once, in k order
    (`matmul.decode_segments`)."""
    from paddle_tpu_torch.kernels import matmul as tmm

    sch = tmm.decode_schedule(k, n, 132)
    assert sch["units"] == units and sch["grid"] == grid
    segs = tmm.decode_segments(sch)
    for c in range(sch["tiles_n"]):
        ranges = [(s, e) for _, cc, s, e, _ in segs if cc == c]
        assert len(ranges) == grid // sch["tiles_n"]
        assert ranges[0][0] == 0 and ranges[-1][1] == sch["kt"]
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("algo,gs", [("weight_only_int8", -1),
                                     ("weight_only_int4", 64)])
def test_dx_backward_matches_reference_vjp(algo, gs):
    wd = _WD[algo]
    k, n, m = 256, 256, 8
    jq, js = jquant.weight_quantize(paddle.to_tensor(_weight(k, n, seed=7)),
                                    algo=algo, group_size=gs)
    rng = np.random.RandomState(2)
    x = rng.randn(m, k).astype(np.float32)
    g = rng.randn(m, n).astype(np.float32)
    qw, sc = jnp.asarray(jq.numpy()), jnp.asarray(js.numpy())
    _, vjp = jax.vjp(lambda a: jqm.quant_matmul_fused(a, qw, sc, wd, gs,
                                                      128, 128),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    y = tqm.quant_matmul(xt, torch.tensor(jq.numpy()),
                         torch.tensor(js.numpy()), wd, gs)
    y.backward(torch.from_numpy(g))
    assert _rel(xt.grad.numpy(), np.asarray(want)) <= 1e-5


@pytest.mark.parametrize("algo,gs", [("weight_only_int8", 128),
                                     ("weight_only_int4", -1)])
def test_weight_only_linear_matches_reference(algo, gs):
    w = _weight(128, 256, seed=9)
    bias = np.random.RandomState(4).randn(256).astype(np.float32)
    x = np.random.RandomState(8).randn(2, 5, 128).astype(np.float32)
    jlin = paddle.nn.Linear(128, 256)
    jlin.weight.set_value(paddle.to_tensor(w))
    jlin.bias.set_value(paddle.to_tensor(bias))
    want = jquant.WeightOnlyLinear.from_source(jlin, algo, gs)(
        paddle.to_tensor(x)).numpy()
    lin = Linear(128, 256, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    lin.bias = torch.nn.Parameter(torch.from_numpy(bias))
    wol = tquant.WeightOnlyLinear.from_source(lin, algo, gs)
    assert wol.quant_weight.dtype == torch.int8
    with torch.no_grad():
        got = wol(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= 1e-5
    fn = tquant.weight_only_linear(torch.from_numpy(x), wol.quant_weight,
                                   wol.bias, wol.weight_scale, _WD[algo],
                                   group_size=gs)
    np.testing.assert_array_equal(fn.detach().numpy(), got)


@pytest.mark.parametrize("algo,gs", [("weight_only_int8", -1),
                                     ("weight_only_int4", 64),
                                     ("weight_only_int8", 128)])
def test_quantized_llama_matches_reference(algo, gs):
    """Both models quantized with lm_head excluded: the port's own
    quantization gives the JAX model's buffers bit for bit, and the JAX
    state loaded through weights.py gives its logits within 1e-5."""
    jm, tm, _ = tiny_pair(seed=1)
    jquant.quantize_for_inference(jm, algo=algo, group_size=gs,
                                  exclude=("lm_head",))
    tquant.quantize_for_inference(tm, algo=algo, group_size=gs,
                                  exclude=("lm_head",))
    assert isinstance(tm.lm_head, Linear)
    assert isinstance(tm.llama.layers[1].mlp.down_proj,
                      tquant.WeightOnlyLinear)
    assert not any(isinstance(m, Linear) for n, m in tm.named_modules()
                   if n != "lm_head")
    jstate = jax_state(jm)
    own = llama_state_to_numpy(tm)
    assert sorted(own) == sorted(jstate)
    for name, arr in jstate.items():
        np.testing.assert_array_equal(own[name], arr)
    load_llama_state(tm, jstate)
    ids = np.random.RandomState(2).randint(0, 256, (2, 16))
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_quantized_logits_stay_near_the_float_model():
    """The reference's bar (tests/test_quantization.py): int8 weights
    move the logits by less than 0.05 of their largest magnitude."""
    _, tm, _ = tiny_pair(seed=2)
    ids = torch.from_numpy(np.random.RandomState(9).randint(0, 256, (2, 16)))
    with torch.no_grad():
        ref = tm(ids)
        tquant.quantize_for_inference(tm, exclude=("lm_head",))
        out = tm(ids)
    assert ((out - ref).abs().max() / ref.abs().max()).item() < 0.05


def test_weights_check_quantized_shapes():
    jm, tm, cfg = tiny_pair()
    jquant.quantize_for_inference(jm, algo="weight_only_int4",
                                  group_size=64, exclude=("lm_head",))
    state = jax_state(jm)
    out = llama_state_from_numpy(state, cfg, torch.float32, "cpu")
    name = "llama.layers.0.mlp.up_proj."
    assert out[name + "quant_weight"].dtype == torch.int8
    assert out[name + "weight_scale"].dtype == torch.float32
    bad = dict(state)
    bad[name + "weight_scale"] = bad[name + "weight_scale"][:, :-1]
    with pytest.raises(ValueError, match="up_proj"):
        llama_state_from_numpy(bad, cfg, torch.float32, "cpu")
    both = dict(state)
    both[name + "weight"] = np.zeros((128, 512), np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        llama_state_from_numpy(both, cfg, torch.float32, "cpu")
    # a float port model does not take a quantized state
    with pytest.raises(RuntimeError):
        load_llama_state(tm, state)


def test_supports_and_layout_checks():
    assert tqm.supports(1, 5120, 13824, "int4", 128)
    assert tqm.supports(2512, 13824, 5120, "int8", 64)
    assert not tqm.supports(8, 96, 128)          # k not a multiple of 64
    assert not tqm.supports(8, 256, 200)         # n not a multiple of 128
    assert not tqm.supports(8, 192, 128, "int8", 128)  # groups must divide k
    assert not tqm.supports(8, 256, 128, "int8", 32)
    assert not tqm.supports(0, 256, 128)
    assert not tqm.supports(8, 256, 128, "fp8")
    qw, sc = tquant.weight_quantize(torch.randn(256, 128), group_size=64)
    x = torch.randn(3, 256)
    with pytest.raises(ValueError, match="scales"):
        tqm.quant_matmul(x, qw, sc, "int8", -1)
    with pytest.raises(ValueError, match="int8"):
        tqm.quant_matmul(x, qw, sc, "int4", 64)
    with pytest.raises(ValueError):
        tqm.quant_matmul(torch.randn(3, 128), qw, sc, "int8", 64)


def test_llm_int8_is_not_ported():
    _, tm, _ = tiny_pair()
    with pytest.raises(NotImplementedError, match="llm.int8"):
        tquant.quantize_for_inference(tm, algo="llm.int8")
    with pytest.raises(NotImplementedError):
        tquant.WeightOnlyLinear(64, 64, algo="llm.int8")
    with pytest.raises(ValueError):
        tquant.quantize_for_inference(tm, algo="weight_only_fp8")
    with pytest.raises(ValueError, match="group_size"):
        tquant.weight_quantize(torch.randn(128, 8), group_size=32)
