"""The port's LBFGS and `amp.debugging` against the JAX package's, on the
CPU.

LBFGS: the same closure on the same numpy weights and data
(`tests/test_distribution_optim_r3.py::test_lbfgs_closure` is the model),
two steps each, with and without the line search and with a history
shorter than the iterations. The losses agree within 1e-6 relative and
the parameters within 5e-4 of their norm. Both run in f32 and sum their
products in other orders; near the minimum the loss is flat along some
directions, where the quasi-Newton steps magnify those roundings: the
first case's weights move 3.7e-5 (step 1) and 1.6e-4 (step 2) of their
norm apart while its losses agree to 1e-7; the other cases stay below
1e-6. `check_numerics` raises FloatingPointError with the
reference's message on the same tensors. The tensor checker raises (or
passes) on the same computations and names the op; a NaN planted in a
LLaMA layer's weight is named by both at a matrix product.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.optimizer import LBFGS


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 8).astype(np.float32) * 0.3,
            rng.randn(8).astype(np.float32) * 0.1,
            rng.randn(16, 8).astype(np.float32),
            rng.randn(16, 8).astype(np.float32))


@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.5, max_iter=10, line_search_fn="strong_wolfe"),
    dict(learning_rate=0.2, max_iter=6),
    dict(learning_rate=1.0, max_iter=8, history_size=2,
         line_search_fn="strong_wolfe"),
    dict(learning_rate=0.5, max_iter=20, max_eval=7,
         line_search_fn="strong_wolfe")])
def test_lbfgs_matches_reference(kw):
    w0, b0, x, y = _data()
    lin = paddle.nn.Linear(8, 8)
    lin.weight.set_value(w0)
    lin.bias.set_value(b0)
    jopt = paddle.optimizer.LBFGS(parameters=lin.parameters(), **kw)
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)

    def jclosure():
        jopt.clear_grad()
        loss = ((lin(jx) - jy) ** 2).mean()
        loss.backward()
        return loss

    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    b = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    topt = LBFGS(parameters=[w, b], **kw)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    def tclosure():
        topt.clear_grad()
        loss = ((tx @ w + b - ty) ** 2).mean()
        loss.backward()
        return loss

    l0 = float(((tx @ w + b - ty) ** 2).mean().detach())
    for _ in range(2):  # a second step starts from the kept history
        want = float(jopt.step(jclosure))
        got = float(topt.step(tclosure).detach())
        np.testing.assert_allclose(got, want, rtol=1e-6)
        for tp, jp in ((w, lin.weight), (b, lin.bias)):
            ref = np.asarray(jp._data)
            assert np.linalg.norm(tp.detach().numpy() - ref) <= \
                5e-4 * np.linalg.norm(ref)
    assert got < l0
    assert len(topt._s_hist) == len(jopt._s_hist) <= kw.get(
        "history_size", 100)
    with pytest.raises(ValueError):
        topt.step()


@pytest.mark.parametrize("values", [
    [1.0, 2.0], [np.nan, 1.0], [np.inf, -np.inf, 3.0], [np.nan, np.inf]])
def test_check_numerics_matches_reference(values):
    a = np.asarray(values, np.float32)
    outcomes = []
    for mod, t in ((jdbg, paddle.to_tensor(a)), (tdbg, torch.from_numpy(a))):
        try:
            out = mod.check_numerics(t, op_type="matmul", var_name="x")
            assert out is t
            outcomes.append(None)
        except FloatingPointError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] is None) == bool(np.isfinite(a).all())


@pytest.fixture
def checker_off():
    yield
    tdbg.disable_tensor_checker()
    jdbg.disable_tensor_checker()
    set_flags({"FLAGS_benchmark": False})
    assert tdbg._mode is None


@pytest.mark.parametrize("case", ["finite", "log0", "div0", "sqrt_neg",
                                  "disabled"])
def test_tensor_checker_raises_where_the_reference_does(checker_off, case):
    x = np.array([0.0, 1.0, 4.0], np.float32)
    fns = {"finite": lambda m, t: m.exp(t) + 1,
           "log0": lambda m, t: m.log(t),
           "div0": lambda m, t: 1.0 / t,
           "sqrt_neg": lambda m, t: m.sqrt(t - 2.0),
           "disabled": lambda m, t: m.log(t)}
    cfg = (jdbg.TensorCheckerConfig(enable=False),
           tdbg.TensorCheckerConfig(enable=False)) if case == "disabled" \
        else (None, None)
    raised = []
    for dbg, mod, t, c in ((jdbg, paddle, paddle.to_tensor(x), cfg[0]),
                           (tdbg, torch, torch.from_numpy(x), cfg[1])):
        dbg.enable_tensor_checker(c)
        try:
            fns[case](mod, t)
            raised.append(None)
        except RuntimeError as e:
            raised.append(str(e))
        finally:
            dbg.disable_tensor_checker()
    assert (raised[0] is None) == (raised[1] is None)
    assert (raised[1] is None) == (case in ("finite", "disabled"))
    if raised[1]:
        assert raised[1].startswith("NaN/Inf detected in output 0 of op "
                                    "'aten.")
        assert raised[1].endswith("set FLAGS_check_nan_inf=0 to disable "
                                  "this check")


def test_the_flag_alone_turns_the_checker_on_and_off(checker_off):
    t = torch.tensor([0.0])
    set_flags({"FLAGS_check_nan_inf": True})
    with pytest.raises(RuntimeError, match="aten.log"):
        torch.log(t)
    set_flags({"FLAGS_check_nan_inf": "0"})
    assert torch.isinf(torch.log(t)).all()
    assert tdbg._mode is None


def test_a_nan_planted_in_a_llama_layer_is_named(checker_off):
    """A NaN in layer 1's MLP down projection: both packages raise at the
    matrix product that reads it (the port names the ATen op), and with
    the checker off the logits are NaN in both."""
    from torch_parity import tiny_pair

    jm, tm, cfg = tiny_pair(seed=3)
    w = np.asarray(jm.llama.layers[1].mlp.down_proj.weight._data).copy()
    w[0, 0] = np.nan
    jm.llama.layers[1].mlp.down_proj.weight.set_value(w)
    with torch.no_grad():
        tm.llama.layers[1].mlp.down_proj.weight[0, 0] = float("nan")
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size, (1, 8))
    msgs = []
    for dbg, run in ((jdbg, lambda: jm(paddle.to_tensor(ids))),
                     (tdbg, lambda: tm(torch.from_numpy(ids)))):
        dbg.enable_tensor_checker()
        try:
            with pytest.raises(RuntimeError) as e:
                run()
            msgs.append(str(e.value))
        finally:
            dbg.disable_tensor_checker()
    assert all(m.startswith("NaN/Inf detected in output 0 of op '")
               for m in msgs)
    port_op = msgs[1].split("'")[1]
    assert port_op.split(".")[1] in ("mm", "matmul", "addmm", "bmm"), msgs
    assert "matmul" in msgs[0] or "linear" in msgs[0] or "dot" in msgs[0], \
        msgs
    assert torch.isnan(tm(torch.from_numpy(ids))).any()
    assert np.isnan(np.asarray(jm(paddle.to_tensor(ids))._data)).any()


def test_operator_stats_count_each_op(checker_off, capsys):
    tdbg.enable_operator_stats_collection()
    x = torch.ones(3)
    (x * 2 + 1).sum()
    x * 3
    stats = tdbg.disable_operator_stats_collection()
    assert stats["aten.mul.Tensor"] == 2 and stats["aten.add.Tensor"] == 1
    assert stats["aten.sum.default"] == 1
    assert "operator stats" in capsys.readouterr().out
    assert get_flags(["FLAGS_benchmark"])["FLAGS_benchmark"] is False
    x * 4  # off: not counted
    assert tdbg.disable_operator_stats_collection(False) == stats
    jdbg.enable_operator_stats_collection()
    (paddle.to_tensor(np.ones(3, np.float32)) * 2).sum()
    jstats = jdbg.disable_operator_stats_collection(print_summary=False)
    assert sum(jstats.values()) >= 2
