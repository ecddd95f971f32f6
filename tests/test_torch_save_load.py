"""`paddle_tpu_torch.save` / `load` against the JAX package's
`paddle.save` / `paddle.load`, on the CPU: files cross both ways, neither
package importing the other to read them (the port's reader maps the
reference's payload class; its writer names it). Arrays must be equal bit
for bit (f32, int64, bool, bfloat16), and `stop_gradient` must equal the
port's `not requires_grad`. An AdamW state resumes across the packages
within the optimizer tests' 1e-6 (f32), and a LLaMA state saved by the
reference drives the port's model to the reference's logits within 1e-5.
"""
import pickle
import pickletools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.optimizer import AdamW


def _port_state():
    g = torch.Generator().manual_seed(0)
    w = torch.nn.Parameter(torch.randn(3, 4, generator=g))
    return {"w": w, "b16": torch.randn(5, generator=g).bfloat16(),
            "ids": torch.arange(6).reshape(2, 3),
            "mask": torch.tensor([True, False]),
            "nested": [torch.ones(2), {"k": torch.zeros(1, 2)}, 7, "s"],
            "tup": (torch.full((2,), 2.5), 1.5), "step": 3}


def _as_np(t):
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.detach().numpy()


@pytest.mark.parametrize("protocol", [2, 4])
def test_a_port_file_loads_in_the_reference(tmp_path, protocol):
    st = _port_state()
    path = str(tmp_path / "port.pdparams")
    ptt.save(st, path, protocol=protocol)
    got = paddle.load(path)
    for key in ("w", "b16", "ids", "mask"):
        want = _as_np(st[key])
        arr = np.asarray(got[key]._data)
        assert arr.dtype == want.dtype and arr.shape == want.shape
        np.testing.assert_array_equal(arr.view(np.uint8), want.view(np.uint8))
        assert got[key].stop_gradient == (not st[key].requires_grad)
    assert not got["w"].stop_gradient and got["b16"].stop_gradient
    np.testing.assert_array_equal(np.asarray(got["nested"][1]["k"]._data),
                                  np.zeros((1, 2), np.float32))
    assert got["nested"][2:] == [7, "s"] and got["step"] == 3
    assert isinstance(got["tup"], tuple) and got["tup"][1] == 1.5


def test_a_port_file_names_the_reference_payload_and_imports_nothing(
        tmp_path):
    path = str(tmp_path / "p.pd")
    ptt.save({"x": torch.ones(2).bfloat16()}, path)
    with open(path, "rb") as f:
        ops = [(op.name, arg) for op, arg, _ in pickletools.genops(f)]
    strings = [a for _, a in ops if isinstance(a, str)]
    assert "paddle_tpu.framework.io" in strings and "_TensorPayload" in \
        strings and "ml_dtypes" in strings
    assert not any("paddle_tpu_torch" in s or s == "torch" for s in strings)


def test_a_reference_file_loads_in_the_port(tmp_path):
    rng = np.random.RandomState(1)
    w = paddle.to_tensor(rng.randn(4, 3).astype(np.float32))
    w.stop_gradient = False
    st = {"w": w,
          "b16": paddle.to_tensor(rng.randn(6).astype(np.float32)).astype(
              "bfloat16"),
          "ids": paddle.to_tensor(np.arange(5, dtype=np.int64)),
          "list": [paddle.to_tensor(np.ones(2, np.float32)), 3],
          "tup": (paddle.to_tensor(np.zeros(1, np.float32)),)}
    path = str(tmp_path / "ref.pdparams")
    paddle.save(st, path)
    got = ptt.load(path, device="cpu")
    for key in ("w", "b16", "ids"):
        want = np.asarray(st[key]._data)
        assert got[key].shape == want.shape
        np.testing.assert_array_equal(_as_np(got[key]).view(np.uint8),
                                      want.view(np.uint8))
        assert got[key].requires_grad == (not st[key].stop_gradient)
    assert got["b16"].dtype == torch.bfloat16
    assert got["ids"].dtype == torch.int64
    assert got["list"][1] == 3 and isinstance(got["tup"], tuple)
    npy = ptt.load(path, return_numpy=True)
    assert npy["b16"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(npy["w"], np.asarray(st["w"]._data))


def test_load_without_ml_dtypes_widens_bfloat16_exactly(tmp_path,
                                                        monkeypatch):
    import builtins

    path = str(tmp_path / "b.pd")
    x = torch.randn(7).bfloat16()
    ptt.save({"x": x}, path)
    real = builtins.__import__

    def no_ml_dtypes(name, *a, **k):
        if name == "ml_dtypes":
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_ml_dtypes)
    got = ptt.load(path, return_numpy=True)["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.float().numpy())


def test_round_trip_in_the_port(tmp_path):
    st = _port_state()
    path = str(tmp_path / "rt.pd")
    ptt.save(st, path)
    got = ptt.load(path, device="cpu")
    for key in ("w", "b16", "ids", "mask"):
        assert got[key].dtype == st[key].dtype
        assert torch.equal(got[key], st[key].detach())
    assert got["w"].requires_grad and not got["b16"].requires_grad
    assert torch.equal(got["nested"][1]["k"], torch.zeros(1, 2))


def test_load_runs_on_the_card_unless_asked_for_the_cpu(tmp_path,
                                                         monkeypatch):
    path = str(tmp_path / "d.pd")
    ptt.save({"x": torch.ones(1)}, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.load(path)
    assert ptt.load(path, device="cpu")["x"].device.type == "cpu"


def _adamw_pair(multi_precision=False):
    rng = np.random.RandomState(3)
    w0 = rng.randn(16, 8).astype(np.float32)
    b0 = rng.randn(8).astype(np.float32)
    grads = [(rng.randn(16, 8).astype(np.float32),
              rng.randn(8).astype(np.float32)) for _ in range(5)]
    lin = paddle.nn.Linear(16, 8)
    jps = lin.parameters()
    jps[0].set_value(w0)
    jps[1].set_value(b0)
    jopt = JaxAdamW(learning_rate=0.01, parameters=jps, weight_decay=0.1,
                    multi_precision=multi_precision)
    tps = [torch.nn.Parameter(torch.from_numpy(w0.copy())),
           torch.nn.Parameter(torch.from_numpy(b0.copy()))]
    topt = AdamW(learning_rate=0.01, parameters=tps, weight_decay=0.1,
                 multi_precision=multi_precision)
    return jps, jopt, tps, topt, grads


def _jstep(jps, jopt, gs):
    for p, g in zip(jps, gs):
        p.grad = paddle.to_tensor(g)
    jopt.step()


def _tstep(tps, topt, gs):
    for p, g in zip(tps, gs):
        p.grad = torch.from_numpy(g.copy())
    topt.step()


def _agree(jps, tps):
    for tp, jp in zip(tps, jps):
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp._data), rtol=0, atol=1e-6)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_adamw_resumes_across_the_packages(tmp_path, direction):
    """3 steps in one package, its optimizer state saved by its `save`,
    loaded by the other package's `load` into a fresh optimizer over the
    same parameters; 2 more steps on each side agree within 1e-6."""
    jps, jopt, tps, topt, grads = _adamw_pair()
    for gs in grads[:3]:
        _jstep(jps, jopt, gs)
        _tstep(tps, topt, gs)
    path = str(tmp_path / "opt.pdopt")
    if direction == "reference_to_port":
        paddle.save(jopt.state_dict(), path)
        state = ptt.load(path, device="cpu")
        fresh = AdamW(learning_rate=0.01, parameters=tps, weight_decay=0.1)
        fresh.set_state_dict(state)
        assert fresh.state_dict()["step"] == 3
        topt = fresh
    else:
        ptt.save(topt.state_dict(), path)
        state = paddle.load(path)
        fresh = JaxAdamW(learning_rate=0.01, parameters=jps,
                         weight_decay=0.1)
        fresh.set_state_dict(state)
        jopt = fresh
    for gs in grads[3:]:
        _jstep(jps, jopt, gs)
        _tstep(tps, topt, gs)
    _agree(jps, tps)


def test_a_reference_llama_checkpoint_drives_the_port_model(tmp_path):
    """The reference's `paddle.save(model.state_dict())` of a tiny LLaMA,
    loaded by the port (`return_numpy=True`) into its own model: the logits
    agree within 1e-5."""
    from paddle_tpu_torch.weights import load_llama_state
    from torch_parity import tiny_pair

    jm, tm, cfg = tiny_pair(seed=2)
    path = str(tmp_path / "llama.pdparams")
    paddle.save(jm.state_dict(), path)
    for p in tm.parameters():  # a model with other weights
        torch.nn.init.normal_(p)
    load_llama_state(tm, ptt.load(path, return_numpy=True))
    ids = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 16))
    want = np.asarray(jm(paddle.to_tensor(ids))._data)
    got = tm(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_the_reference_payload_slots_match():
    from paddle_tpu.framework import io as jio

    assert tio._TensorPayload.__slots__ == jio._TensorPayload.__slots__
    assert tio._REF_PAYLOAD == (jio.__name__, jio._TensorPayload.__qualname__)
    blob = pickle.dumps(jio._TensorPayload(paddle.to_tensor(
        np.arange(3, dtype=np.float32))), protocol=4)
    import io as _io

    got = tio._Unpickler(_io.BytesIO(blob)).load()
    assert isinstance(got, tio._TensorPayload)
    np.testing.assert_array_equal(got.to_numpy(), np.arange(3))
    assert jnp.asarray(got.array).dtype == jnp.float32
