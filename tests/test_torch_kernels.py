"""The port's kernel modules against the JAX package.

On the CPU: each kernel's plain PyTorch version against the JAX Pallas
kernel (interpret mode off the TPU, as the JAX tests run it) and against
its XLA reference, plus the paged cache writes. Tolerance 1e-5 abs in f32:
both sides compute the same f32 arithmetic, in a different summation order.

The CUDA kernels themselves are held against these plain versions on the
card in `test_torch_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.kernels import rms_norm as jrms
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels import rms_norm as trms
from paddle_tpu_torch.nn import functional as TF

ATOL = 1e-5


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,cols", [(8, 128), (64, 256), (512, 128)])
def test_rms_norm_ref_matches_pallas(rows, cols):
    rng = np.random.RandomState(rows + cols)
    x = rng.randn(rows, cols).astype(np.float32) * 3.0
    w = rng.randn(cols).astype(np.float32)
    want = np.asarray(jrms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = trms.rms_norm_ref(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_rms_norm_functional_on_cpu_is_the_plain_version():
    x = torch.randn(4, 3, 128)
    w = torch.randn(128)
    n0 = trms.launches
    torch.testing.assert_close(TF.rms_norm(x, w, 1e-5),
                               trms.rms_norm_ref(x, w, 1e-5), rtol=0, atol=0)
    assert trms.launches == n0


def test_rms_norm_bf16_keeps_dtype():
    x = torch.randn(8, 128).to(torch.bfloat16)
    y = trms.rms_norm(x, torch.ones(128, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == x.shape


def test_cuda_paths_raise_instead_of_falling_back():
    # the kernel entry points refuse a CPU tensor: no plain-version fallback
    x = torch.randn(8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        trms._rms_norm_cuda(x, torch.ones(128), 1e-6)
    q = torch.randn(2, 4, 64)
    kp, vp = tpa.alloc_pages(4, 8, 2, 64)
    tables = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpa._paged_attention_cuda(q, kp, vp, tables, lens, None)


# ---------------------------------------------------------------------------
# paged cache writes
# ---------------------------------------------------------------------------


def _pools(rng, kvh=2, n_pages=12, page=8, d=32):
    k = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    v = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    return k, v


def test_update_paged_kv_cache_matches_jax_with_inactive_rows():
    rng = np.random.RandomState(0)
    k, v = _pools(rng)
    tables = rng.permutation(12)[:8].reshape(4, 2).astype(np.int32)
    lens = np.array([0, 7, 8, 15], np.int32)
    active = np.array([True, False, True, True])
    kn = rng.randn(4, 2, 32).astype(np.float32)
    vn = rng.randn(4, 2, 32).astype(np.float32)
    jk, jv = jpa.update_paged_kv_cache(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(tables), jnp.asarray(lens), active=jnp.asarray(active))
    tk, tv = tpa.update_paged_kv_cache(
        torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
        torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(tables), torch.from_numpy(lens),
        active=torch.from_numpy(active))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the inactive row's target slot kept its old value
    page = tables[1, 7 // 8]
    np.testing.assert_array_equal(tk.numpy()[:, page, 7], k[:, page, 7])


def test_prefill_paged_kv_cache_matches_jax_and_drops_padding():
    rng = np.random.RandomState(1)
    k, v = _pools(rng)
    tables = rng.permutation(12)[:9].reshape(3, 3).astype(np.int32)
    seq_lens = np.array([5, 17, 1], np.int32)
    ks = rng.randn(3, 20, 2, 32).astype(np.float32)
    vs = rng.randn(3, 20, 2, 32).astype(np.float32)
    jk, jv = jpa.prefill_paged_kv_cache(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(tables[:, :3]), jnp.asarray(seq_lens))
    tk, tv = tpa.prefill_paged_kv_cache(
        torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
        torch.from_numpy(ks), torch.from_numpy(vs),
        torch.from_numpy(tables), torch.from_numpy(seq_lens))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_alloc_pages_shape_and_dtype():
    k, v = tpa.alloc_pages(6, 8, 2, 32, dtype=torch.bfloat16)
    assert k.shape == v.shape == (2, 6, 8, 32)
    assert k.dtype == torch.bfloat16 and not k.any()


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


def _decode_case(seed, b=5, q_heads=4, kv_heads=2, d=32, page=8,
                 pages_per_seq=4, lens=(0, 1, 8, 9, 32)):
    rng = np.random.RandomState(seed)
    n_pages = b * pages_per_seq
    k = rng.randn(kv_heads, n_pages, page, d).astype(np.float32)
    v = rng.randn(kv_heads, n_pages, page, d).astype(np.float32)
    q = rng.randn(b, q_heads, d).astype(np.float32)
    tables = rng.permutation(n_pages).reshape(b, pages_per_seq) \
        .astype(np.int32)
    return q, k, v, tables, np.asarray(lens, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("q_heads,kv_heads", [(4, 4), (4, 2), (8, 1)])
def test_paged_attention_ref_matches_pallas(q_heads, kv_heads):
    """GQA groups 1, 2 and 8; ragged lens, a ctx == 0 row (zeros)."""
    q, k, v, tables, lens = _decode_case(q_heads * 10 + kv_heads,
                                         q_heads=q_heads, kv_heads=kv_heads)
    want = np.asarray(jpa.paged_attention(*map(jnp.asarray,
                                               (q, k, v, tables, lens))))
    got = tpa.paged_attention_ref(*_torch(q, k, v, tables, lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[0], 0.0)


def test_paged_attention_ref_matches_xla_reference():
    q, k, v, tables, lens = _decode_case(3, lens=(3, 1, 8, 30, 32))
    want = np.asarray(jpa.paged_attention_xla(
        *map(jnp.asarray, (q, k, v, tables, lens)), scale=0.3))
    got = tpa.paged_attention_ref(*_torch(q, k, v, tables, lens),
                                  scale=0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_paged_attention_on_cpu_is_the_plain_version():
    q, k, v, tables, lens = _decode_case(4)
    n0 = tpa.launches
    args = _torch(q, k, v, tables, lens)
    torch.testing.assert_close(tpa.paged_attention(*args),
                               tpa.paged_attention_ref(*args), rtol=0,
                               atol=0)
    assert tpa.launches == n0
