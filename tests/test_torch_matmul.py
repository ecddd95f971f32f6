"""The port's dense matmul (`paddle_tpu_torch/kernels/matmul.py`) against the
JAX package's (`paddle_tpu/kernels/matmul.py`), on the CPU.

The plain version (`matmul_ref`, `torch.matmul`) is held against the
reference's XLA function `matmul_xla` and its Pallas kernel `matmul_fused`
in interpret mode, as the reference's own tests run it. Tolerances: f32
1e-5 relative (the same f32 products, summed in another order); bf16 2^-7
relative to the largest output (each side rounds its output to bf16 once,
and the Pallas kernel rounds its inputs the same way, so the outputs
differ by at most one bf16 ulp). Both are taken of the largest |output|,
elementwise: an output near 0 carries the rounding of its large terms.
The CUDA kernel is held against the plain version on the card in
`test_torch_cuda.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import matmul as jmm
from paddle_tpu_torch.framework import config as tconfig
from paddle_tpu_torch.kernels import autotune as at
from paddle_tpu_torch.kernels import matmul as tmm
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F

_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=_TOL[dtype],
                               atol=_TOL[dtype] * scale)


def _inputs(m, k, n, dtype, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jw = jnp.asarray(w).astype(dtype)
    # the same rounded values on both sides
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))) \
        .to(_TORCH[dtype])
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))) \
        .to(_TORCH[dtype])
    return jx, jw, tx, tw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(128, 128), (256, 384), (384, 256)])
@pytest.mark.parametrize("m", [1, 8, 33, 300])
def test_matmul_ref_matches_xla_and_pallas(m, k, n, dtype):
    jx, jw, tx, tw = _inputs(m, k, n, dtype, m * 7 + k + n)
    got = tmm.matmul_ref(tx, tw).float().numpy()
    assert tmm.matmul_fused(tx, tw).dtype == _TORCH[dtype]
    _assert_close(got, jmm.matmul_xla(jx, jw).astype(jnp.float32), dtype)
    pallas = jmm.matmul_fused(jx, jw, block_n=128, block_k=128)
    _assert_close(got, pallas.astype(jnp.float32), dtype)


@pytest.mark.parametrize("m", [8, 33])
def test_matmul_function_gradients_match_pallas_vjp(m):
    jx, jw, tx, tw = _inputs(m, 256, 128, "float32", m)
    rng = np.random.RandomState(m + 1)
    g = rng.randn(m, 128).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jmm.matmul_fused(a, b, 128, 128), jx, jw)
    jdx, jdw = vjp(jnp.asarray(g))
    xa, wa = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    y = tmm.matmul_fused(xa, wa)
    assert y.grad_fn is not None and "MatmulFunction" in \
        type(y.grad_fn).__name__
    y.backward(torch.from_numpy(g))
    _assert_close(xa.grad.numpy(), jdx, "float32")
    _assert_close(wa.grad.numpy(), jdw, "float32")


def test_matmul_function_takes_leading_dims():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 5, 128).astype(np.float32))
    w = torch.from_numpy(rng.randn(128, 256).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 5, 256).astype(np.float32))
    got, want = [], []
    for fn, out in ((tmm.matmul_fused, got), (torch.matmul, want)):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xa, wa)
        y.backward(g)
        out += [y.detach(), xa.grad, wa.grad]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_supports_takes_every_shape_the_reference_takes():
    sizes = (0, 1, 64, 100, 128, 192, 256, 384, 512, 640)
    for m in (0, 1, 8, 33, 300, 1025):
        for k in sizes:
            for n in sizes:
                ours = tmm.supports(m, k, n, torch.float32)
                assert ours == (m >= 1 and k > 0 and n > 0 and k % 64 == 0
                                and n % 128 == 0)
                if jmm.supports(m, k, n):
                    assert ours and tmm.supports(m, k, n, torch.bfloat16)
    assert not tmm.supports(8, 128, 128, torch.float16)


def test_tiles_and_default_tile():
    assert tmm.tiles(torch.bfloat16) == (16, 64, 128)
    assert tmm.tiles(torch.float32) == (16, 64)
    assert tmm.default_tile(8) == 16 and tmm.default_tile(17) == 128
    assert tmm.default_tile(300, torch.float32) == 64


def test_matmul_on_cpu_is_the_plain_version():
    x = torch.randn(33, 256)
    w = torch.randn(256, 128)
    n0 = tmm.launches
    assert torch.equal(tmm.matmul_fused(x, w, 64), torch.matmul(x, w))
    assert tmm.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        tmm._matmul_cuda(x, w)
    with pytest.raises(ValueError, match="weight"):
        tmm.matmul_fused(x, torch.randn(128, 128))


def test_linear_with_the_tuner_off_is_torch_matmul(monkeypatch):
    assert tconfig.get_flag("FLAGS_autotune") == "off"
    monkeypatch.setattr(at, "choose_matmul", lambda *a: pytest.fail(
        "the tuner was consulted with FLAGS_autotune off"))
    monkeypatch.setattr(tmm, "matmul_fused", lambda *a: pytest.fail(
        "the kernel's wrapper ran with FLAGS_autotune off"))
    rng = np.random.RandomState(4)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.randn(3, 7, 256).astype(np.float32)) \
            .to(dtype)
        lin = Linear(256, 384, dtype=dtype)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(
                rng.randn(256, 384).astype(np.float32)))
        assert torch.equal(F.linear(x, lin.weight),
                           torch.matmul(x, lin.weight))
        assert torch.equal(lin(x), torch.matmul(x, lin.weight))
