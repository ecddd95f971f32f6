"""The port's kernel modules against the JAX package.

On the CPU: each kernel's plain PyTorch version against the JAX Pallas
kernel (interpret mode off the TPU, as the JAX tests run it) and against
its XLA reference, plus the paged cache writes. Tolerance 1e-5 abs in f32:
both sides compute the same f32 arithmetic, in a different summation order
(the RMSNorm weight gradient, a sum over 512 rows, 1e-4).

The CUDA kernels themselves are held against these plain versions on the
card in `test_torch_cuda.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.kernels import rms_norm as jrms
from paddle_tpu_torch.kernels import flash_attention as tfa
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


@pytest.mark.parametrize("rows,cols", [(512, 128), (512, 256)])
def test_rms_norm_rstd_and_backward_match_pallas(rows, cols):
    """512 rows: two of the Pallas backward's 256-row blocks, so its dw
    accumulates across its grid."""
    rng = np.random.RandomState(rows * cols)
    x = rng.randn(rows, cols).astype(np.float32) * 2.0
    w = rng.randn(cols).astype(np.float32)
    g = rng.randn(rows, cols).astype(np.float32)
    _, j_rstd = jrms._fwd(jnp.asarray(x), jnp.asarray(w), 1e-6)
    y, rstd = trms.rms_norm_ref(torch.from_numpy(x), torch.from_numpy(w),
                                1e-6, with_rstd=True)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(j_rstd)[:, 0],
                               rtol=1e-6, atol=0)
    _, vjp = jax.vjp(lambda a, b: jrms.rms_norm_2d(a, b, 1e-6),
                     jnp.asarray(x), jnp.asarray(w))
    j_dx, j_dw = vjp(jnp.asarray(g))
    dx, dw = trms.rms_norm_bwd_ref(torch.from_numpy(x), torch.from_numpy(w),
                                   rstd, torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(j_dx), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), rtol=0,
                               atol=1e-4)


def test_rms_norm_functional_gradient_is_the_plain_backward():
    """The differentiable functional (RMSNormFunction on the CPU: the plain
    forward and backward) equals autograd through the plain expression."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 64, 256).astype(np.float32))
    w = torch.from_numpy(rng.randn(256).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 64, 256).astype(np.float32))
    got = []
    for fn in (TF.rms_norm, trms.rms_norm_ref):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xa, wa, 1e-6).backward(g)
        got.append((xa.grad, wa.grad))
    torch.testing.assert_close(got[0][0], got[1][0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[0][1], got[1][1], rtol=0, atol=1e-4)


def test_rms_norm_functional_takes_the_kernel_by_shape():
    """The kernels take every float32, bfloat16 or float16 x with a row and
    a column, with no weight or one [cols] in x's dtype or float32; an
    integer x, a float64 x or a weight of another shape or dtype they do
    not. On the CPU a shape they do not take (float64) runs the plain
    expression under autograd."""
    x = torch.randn(4, 100, requires_grad=True)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for cols in (1, 6, 100, 20000):
            xd = torch.randn(3, cols).to(dt)
            assert trms.supports(xd)
            assert trms.supports(xd, None)
            assert trms.supports(xd, torch.ones(cols, dtype=dt))
            assert trms.supports(xd, torch.ones(cols))  # a float32 weight
    assert not trms.supports(x.double(), torch.ones(100).double())
    assert not trms.supports(torch.ones(4, 100, dtype=torch.int32))
    assert not trms.supports(x.half(), torch.ones(100).bfloat16())
    assert not trms.supports(x, torch.ones(99))
    assert not trms.supports(torch.randn(0, 100))
    y = TF.rms_norm(torch.randn(3, 6, dtype=torch.float64,
                                requires_grad=True),
                    torch.ones(6, dtype=torch.float64, requires_grad=True))
    y.sum().backward()  # the plain expression, under autograd


def test_rms_norm_functional_off_the_cpu_never_takes_the_plain_version():
    """Only a CPU tensor takes the plain version. A tensor on another device
    (here `meta`, which no kernel takes) goes to the kernels' wrappers and
    raises, whatever its width, weight or dtype, with or without a
    gradient."""
    x = torch.empty(5, 11008, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TF.rms_norm(x, torch.empty(11008, device="meta"))
    for cols in (16384, 6, 131072):
        for weight in (torch.empty(cols, device="meta"), None):
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                x = torch.empty(3, cols, device="meta", dtype=dt,
                                requires_grad=True)
                with pytest.raises(ValueError, match="CUDA"):
                    TF.rms_norm(x, weight)
                with pytest.raises(ValueError, match="CUDA"):
                    TF.rms_norm(x.detach(), weight)


def test_rms_norm_ring_takes_only_rows_on_16_byte_boundaries():
    """The ring and direct instances' bulk copies and 16-byte loads need
    every row of every array 16-byte aligned; anything else takes the
    stream instance."""
    x = torch.zeros(4, 4096, dtype=torch.bfloat16)
    assert trms.ring_aligned((x, torch.empty_like(x)), 4096, 2)
    off = torch.zeros(4 * 4096 + 1, dtype=torch.bfloat16)[1:].view(4, 4096)
    assert off.data_ptr() % 16 == 2
    assert not trms.ring_aligned((off,), 4096, 2)
    assert not trms.ring_aligned((x, off), 4096, 2)
    odd = torch.zeros(4, 4100, dtype=torch.bfloat16)  # rows 8200 bytes
    assert not trms.ring_aligned((odd,), 4100, 2)
    assert trms.ring_aligned((torch.zeros(3, 4100),), 4100, 4)  # f32 rows
    assert not trms.ring_aligned((torch.zeros(3, 6),), 6, 4)


def test_cuda_paths_raise_instead_of_falling_back():
    # the kernel entry points refuse a CPU tensor: no plain-version fallback
    x = torch.randn(8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        trms._rms_norm_cuda(x, torch.ones(128), 1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        trms._rms_norm_bwd_cuda(x, torch.ones(128), torch.ones(8), x)
    q = torch.randn(2, 4, 64)
    kp, vp = tpa.alloc_pages(4, 8, 2, 64)
    tables = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpa._paged_attention_cuda(q, kp, vp, tables, lens, None)
    q = torch.randn(2, 128, 128)
    lse = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._fwd_cuda(q, q, q, 0.1, True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._bwd_cuda(q, q, q, q, lse, lse, 0.1, True)


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


@pytest.mark.parametrize("q_heads,kv_heads,d", [(32, 1, 32), (64, 2, 32),
                                                (8, 2, 256)])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_ref_matches_pallas_at_any_group(q_heads, kv_heads,
                                                          d, quant):
    """A multi-query group (32 query heads on one KV head), 32 per KV head
    over two, and head_dim 256, float pages and int8 pages with their
    scales: the widths the CUDA kernels take in chunks of 16 (8 at head_dim
    256) queries. int8: 2e-4 relative, as `test_torch_kv_quant.py`."""
    q, k, v, tables, lens = _decode_case(q_heads + d, q_heads=q_heads,
                                         kv_heads=kv_heads, d=d)
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, lens)]
    targs = _torch(q, k, v, tables, lens)
    jsc, tsc, tol = {}, {}, dict(rtol=0, atol=ATOL)
    if quant:
        kq, ks = tpa._quant_kv_token(targs[1])
        vq, vs = tpa._quant_kv_token(targs[2])
        targs[1:3] = kq, vq
        tsc = dict(k_scales=ks, v_scales=vs)
        pad = ((0, 0), (0, 0), (0, jpa._SCALE_LANES - ks.shape[-1]))
        jargs[1:3] = jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy())
        jsc = dict(k_scales=jnp.asarray(np.pad(ks.numpy(), pad)),
                   v_scales=jnp.asarray(np.pad(vs.numpy(), pad)))
        tol = dict(rtol=2e-4, atol=2e-5)
    want = np.asarray(jpa.paged_attention(*jargs, **jsc))
    got = tpa.paged_attention(*targs, **tsc).numpy()
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_array_equal(got[0], 0.0)  # ctx == 0


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


# ---------------------------------------------------------------------------
# grouped-fetch decode and the decode dispatch
# ---------------------------------------------------------------------------


def _grouped_pools(rng, kvh, n_pages, hd, dtype):
    kp = rng.standard_normal((kvh, n_pages, 16, hd)).astype(np.float32)
    vp = rng.standard_normal((kvh, n_pages, 16, hd)).astype(np.float32)
    return kp, vp


def _as(dtype, *arrays):
    """Each array in `dtype` on both sides: (jax arrays, torch tensors)."""
    js = [jnp.asarray(a, dtype) for a in arrays]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32)))
          .to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
          for j in js]
    return js, ts


def test_grouped_ref_matches_pallas_multi_group():
    """`tests/test_flash_kernels.py`'s multi-group case: lens 384 (every
    group), 129 (just into the second group), 16 (one page); f32, 1e-4
    abs, the reference's bar."""
    rng = np.random.default_rng(0)
    kp, vp = _grouped_pools(rng, 2, 96, 128, jnp.float32)
    q = rng.standard_normal((3, 4, 128)).astype(np.float32)
    bt = rng.permutation(96)[:3 * 24].reshape(3, 24).astype(np.int32)
    cl = np.asarray([384, 129, 16], np.int32)
    want = np.asarray(jpa.paged_attention_grouped(
        *map(jnp.asarray, (q, kp, vp, bt, cl))))
    got = tpa.paged_attention_grouped(*_torch(q, kp, vp, bt, cl)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(
        got, tpa.paged_attention_ref(*_torch(q, kp, vp, bt, cl)).numpy(),
        atol=ATOL)


def test_grouped_ref_matches_pallas_gqa_bf16():
    """The reference's GQA bf16 case (12 query heads over 2, group 6, pad
    to 8 rows there): bf16 outputs within 0.04 abs, the reference's bar."""
    rng = np.random.default_rng(1)
    kp, vp = _grouped_pools(rng, 2, 32, 128, jnp.bfloat16)
    q = rng.standard_normal((2, 12, 128)).astype(np.float32)
    bt = rng.integers(0, 32, (2, 8)).astype(np.int32)
    cl = np.asarray([100, 37], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _as(jnp.bfloat16, q, kp, vp)
    want = np.asarray(jpa.paged_attention_grouped(
        jq, jk, jv, jnp.asarray(bt), jnp.asarray(cl)), np.float32)
    got = tpa.paged_attention_grouped(tq, tk, tv, torch.from_numpy(bt),
                                      torch.from_numpy(cl))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.04)


def test_grouped_ref_zero_context_and_stale_tables():
    """A row with context 0 is zeros; entries past a row's pages are never
    read (ids far out of the pool change nothing)."""
    rng = np.random.default_rng(2)
    kp, vp = _grouped_pools(rng, 1, 48, 128, jnp.float32)
    q = rng.standard_normal((3, 2, 128)).astype(np.float32)
    bt = rng.permutation(48).reshape(3, 16).astype(np.int32)
    cl = np.asarray([0, 129, 256], np.int32)
    got = tpa.paged_attention_grouped(*_torch(q, kp, vp, bt, cl)).numpy()
    np.testing.assert_array_equal(got[0], 0.0)
    stale = bt.copy()
    stale[0, :], stale[1, 9:], stale[2, 16:] = 10 ** 6, 10 ** 6, 10 ** 6
    np.testing.assert_array_equal(
        tpa.paged_attention_grouped(*_torch(q, kp, vp, stale, cl)).numpy(),
        got)


def test_grouped_raises_when_the_width_is_not_a_multiple_of_8():
    rng = np.random.default_rng(2)
    kp, vp = _grouped_pools(rng, 1, 8, 128, jnp.float32)
    q = rng.standard_normal((1, 1, 128)).astype(np.float32)
    bt = rng.integers(0, 8, (1, 6)).astype(np.int32)
    cl = np.asarray([50], np.int32)
    with pytest.raises(ValueError):
        jpa.paged_attention_grouped(*map(jnp.asarray, (q, kp, vp, bt, cl)))
    with pytest.raises(ValueError, match="multiple of 8"):
        tpa.paged_attention_grouped(*_torch(q, kp, vp, bt, cl))
    with pytest.raises(ValueError, match="16-token"):  # 8-token pages
        tpa.paged_attention_grouped(*_torch(q, kp[:, :, :8], vp[:, :, :8],
                                            np.zeros((1, 8), np.int32), cl))
    with pytest.raises(TypeError):
        tpa.paged_attention_grouped(
            *_torch(q, kp.astype(np.int8), vp.astype(np.int8),
                    np.zeros((1, 8), np.int32), cl))
    with pytest.raises(ValueError, match="CUDA"):
        tpa._paged_attention_cuda(*_torch(q, kp, vp,
                                          np.zeros((1, 8), np.int32), cl),
                                  None, grouped=True)


@pytest.fixture
def grouped_flag():
    from paddle_tpu_torch.framework import config as tconfig

    old = tconfig.get_flags(["FLAGS_paged_grouped_kernel"])
    yield lambda on: tconfig.set_flags({"FLAGS_paged_grouped_kernel": on})
    tconfig.set_flags(old)


def _dispatched(monkeypatch, q, k, v, tables, lens, **kw):
    seen = []
    for name in ("paged_attention", "paged_attention_grouped"):
        real = getattr(tpa, name)
        monkeypatch.setattr(tpa, name, lambda *a, _r=real, _n=name, **k_:
                            seen.append(_n) or _r(*a, **k_))
    out = tpa.paged_attention_dispatch(q, k, v, tables, lens, **kw)
    monkeypatch.undo()
    return seen, out


def test_decode_dispatch_order(monkeypatch, grouped_flag):
    """Tuner off: the grouped kernel exactly when its flag is set and the
    pages are float, 16 tokens, head_dim 128, the table a multiple of 8
    pages wide; otherwise the per-page kernel. (The tuner's winner comes
    first when it is on: test_torch_autotune.py.)"""
    rng = np.random.default_rng(3)
    kp, vp = _grouped_pools(rng, 2, 32, 128, jnp.float32)
    q = rng.standard_normal((2, 4, 128)).astype(np.float32)
    bt = rng.permutation(32).reshape(2, 16).astype(np.int32)
    cl = np.asarray([200, 17], np.int32)
    args = _torch(q, kp, vp, bt, cl)
    want = tpa.paged_attention_ref(*args)
    grouped_flag(False)
    seen, out = _dispatched(monkeypatch, *args)
    assert seen == ["paged_attention"]
    torch.testing.assert_close(out, want, rtol=0, atol=ATOL)
    grouped_flag(True)
    seen, out = _dispatched(monkeypatch, *args)
    assert seen == ["paged_attention_grouped"]
    torch.testing.assert_close(out, want, rtol=0, atol=ATOL)
    # a table 12 pages wide does not fit the grouped kernel
    seen, _ = _dispatched(monkeypatch, *_torch(q, kp, vp, bt[:, :12], cl))
    assert seen == ["paged_attention"]
    # int8 pages take the per-page kernel's int8 body
    k8, ks = tpa._quant_kv_token(args[1])
    v8, vs = tpa._quant_kv_token(args[2])
    seen, _ = _dispatched(monkeypatch, args[0], k8, v8, args[3], args[4],
                          k_scales=ks, v_scales=vs)
    assert seen == ["paged_attention"]


def test_tiny_engine_with_the_grouped_flag_matches_jax_engine(
        monkeypatch, grouped_flag):
    """head_dim 128, 16-token pages, tables 8 pages wide: with
    FLAGS_paged_grouped_kernel set in both packages, the port's engine
    decodes through the grouped plain version and its greedy streams equal
    the JAX engine's."""
    import paddle_tpu as paddle
    from paddle_tpu.inference import ServingEngine as JaxEngine
    from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.weights import load_llama_state
    from torch_parity import jax_state

    dims = dict(vocab=256, hidden=256, layers=2, heads=2, seq=128)
    paddle.seed(7)
    jcfg = JaxLlamaConfig.tiny(**dims)
    jcfg.num_key_value_heads = 1
    jm = JaxLlama(jcfg)
    jm.eval()
    tcfg = LlamaConfig.tiny(**dims)
    tcfg.num_key_value_heads = 1
    tm = LlamaForCausalLM(tcfg, device="cpu")
    load_llama_state(tm, jax_state(jm))
    calls = []
    real = tpa.paged_attention_grouped_ref
    monkeypatch.setattr(tpa, "paged_attention_grouped_ref",
                        lambda *a: calls.append(1) or real(*a))
    old = paddle.get_flags(["FLAGS_paged_grouped_kernel"])
    paddle.set_flags({"FLAGS_paged_grouped_kernel": True})
    grouped_flag(True)
    try:
        rng = np.random.RandomState(5)
        prompts = [rng.randint(0, 256, (n,)) for n in (5, 9, 17, 3, 40)]
        streams = []
        for cls, model, kw in ((JaxEngine, jm, {}),
                               (ServingEngine, tm, {"device": "cpu"})):
            eng = cls(model, max_batch=3, max_seq_len=128, page_size=16,
                      decode_strategy="greedy_search", **kw)
            for p in prompts:
                eng.add_request(p, max_new_tokens=16)
            streams.append({f.request_id: f.output_ids.tolist()
                            for f in eng.run()})
    finally:
        paddle.set_flags(old)
    assert calls  # the port decoded through the grouped plain version
    assert streams[0] == streams[1]
