"""The port's flash attention against the JAX package, on the CPU in f32.

The plain versions (`flash_fwd_ref`, `flash_bwd_dkv_ref`,
`flash_bwd_dq_ref`) are held against the reference's Pallas passes
(`_flash_fwd`, `_run_dkv_pass`, `_run_dq_pass`, interpret mode off the TPU,
as the JAX tests run them) and against its XLA reference
(`_xla_ref_fwd`, `_xla_ref_bwd`). Tolerances: forward 2e-5 abs (the same
f32 arithmetic summed in another order; outputs are O(1), lse O(10));
gradients 1e-3 relative to the largest magnitude, the reference's own bar
for its flash backward.

The CUDA kernels are held against these plain versions on the card in
`test_torch_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.nn import functional as TF

FWD_ATOL = 2e-5
GRAD_RTOL = 1e-3

# (bh, s_q, s_kv, causal): square, s_q < s_kv, and s_q > s_kv causal, whose
# first s_q - s_kv rows see no key at all
CASES = [(2, 128, 128, True), (2, 256, 256, False), (2, 256, 256, True),
         (2, 128, 256, True), (2, 128, 256, False), (2, 256, 128, True)]


def _inputs(bh, s_q, s_kv, seed, d=128):
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, s_q, d).astype(np.float32)
    k = rng.randn(bh, s_kv, d).astype(np.float32)
    v = rng.randn(bh, s_kv, d).astype(np.float32)
    do = rng.randn(bh, s_q, d).astype(np.float32)
    return q, k, v, do


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bh,s_q,s_kv,causal", CASES)
def test_flash_fwd_ref_matches_pallas_and_xla(bh, s_q, s_kv, causal):
    q, k, v, _ = _inputs(bh, s_q, s_kv, s_q + s_kv)
    scale = 128 ** -0.5
    out, lse = tfa.flash_fwd_ref(*_t(q, k, v), scale, causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want_out, want_lse in (
            jfa._flash_fwd(jq, jk, jv, scale, causal, 128, 128),
            jfa._xla_ref_fwd(jq, jk, jv, scale, causal)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   rtol=0, atol=FWD_ATOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   rtol=0, atol=FWD_ATOL)
    if s_q > s_kv and causal:  # rows that see no key: out 0, lse -1e30
        dead = s_q - s_kv
        assert not out[:, :dead].any()
        np.testing.assert_array_equal(lse[:, :dead].numpy(),
                                      np.float32(-1e30))


@pytest.mark.parametrize("bh,s_q,s_kv,causal", CASES)
def test_flash_bwd_refs_match_pallas_and_xla(bh, s_q, s_kv, causal):
    q, k, v, do = _inputs(bh, s_q, s_kv, 100 + s_q + s_kv)
    scale = 128 ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = jfa._flash_fwd(jq, jk, jv, scale, causal, 128, 128)
    res = (jq, jk, jv, out, lse)
    _, lse8, delta8 = jfa._bwd_delta(res, jdo)
    tq, tk, tv, tdo = _t(q, k, v, do)
    t_out, t_lse = tfa.flash_fwd_ref(tq, tk, tv, scale, causal)
    delta = tfa.flash_bwd_delta(t_out, tdo)
    np.testing.assert_allclose(delta.numpy(), np.asarray(delta8[:, 0]),
                               rtol=0, atol=1e-4)
    dk, dv = tfa.flash_bwd_dkv_ref(tq, tk, tv, tdo, t_lse, delta, scale,
                                   causal)
    dq = tfa.flash_bwd_dq_ref(tq, tk, tv, tdo, t_lse, delta, scale, causal)
    pk, pv = jfa._run_dkv_pass(jq, jk, jv, jdo, lse8, delta8, scale, causal,
                               128, 128)
    pq = jfa._run_dq_pass(jq, jk, jv, jdo, lse8, delta8, scale, causal, 128,
                          128)
    xq, xk, xv = jfa._xla_ref_bwd(res, jdo, scale, causal)
    for name, got, pallas, xla in (("dq", dq, pq, xq), ("dk", dk, pk, xk),
                                   ("dv", dv, pv, xv)):
        assert _rel_err(got.numpy(), pallas) <= GRAD_RTOL, name
        assert _rel_err(got.numpy(), xla) <= GRAD_RTOL, name
    if s_q > s_kv and causal:  # rows that see no key give no gradient
        assert not dq[:, :s_q - s_kv].any()


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_cpu_autograd_is_the_plain_backward(causal):
    """bshd [1, 256, 2, 128]: the port's sdpa forward and autograd backward
    on the CPU equal the plain versions run by hand over [b*h, s, d]."""
    rng = np.random.RandomState(5)
    q, k, v, g = (rng.randn(1, 256, 2, 128).astype(np.float32)
                  for _ in range(4))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = TF.scaled_dot_product_attention(tq, tk, tv, is_causal=causal)
    out.backward(torch.from_numpy(g))

    def bhsd(a):
        return torch.from_numpy(a).transpose(1, 2).reshape(2, 256, 128)

    scale = 128 ** -0.5
    q2, k2, v2, g2 = map(bhsd, (q, k, v, g))
    o2, lse = tfa.flash_fwd_ref(q2, k2, v2, scale, causal)
    delta = tfa.flash_bwd_delta(o2, g2)
    dk, dv = tfa.flash_bwd_dkv_ref(q2, k2, v2, g2, lse, delta, scale, causal)
    dq = tfa.flash_bwd_dq_ref(q2, k2, v2, g2, lse, delta, scale, causal)

    def bshd(t):
        return t.reshape(1, 2, 256, 128).transpose(1, 2)

    torch.testing.assert_close(out, bshd(o2), rtol=0, atol=0)
    for got, want in ((tq.grad, dq), (tk.grad, dk), (tv.grad, dv)):
        torch.testing.assert_close(got, bshd(want), rtol=0, atol=0)


def test_sdpa_on_cpu_never_launches_a_kernel():
    rng = np.random.RandomState(6)
    q = torch.from_numpy(rng.randn(1, 128, 2, 128).astype(np.float32))
    q.requires_grad_()
    counts = (tfa.fwd_launches, tfa.bwd_launches)
    TF.scaled_dot_product_attention(q, q, q, is_causal=True).sum().backward()
    assert (tfa.fwd_launches, tfa.bwd_launches) == counts


@pytest.mark.parametrize("shape,masked", [((1, 128, 2, 128), True),
                                          ((1, 100, 2, 128), False),
                                          ((1, 128, 2, 64), False)])
def test_sdpa_masked_or_unsupported_takes_the_reference_path(shape, masked):
    """A mask, a sequence that is not a multiple of 128 or a head_dim other
    than 128 goes to `_sdpa_reference`, which matches the JAX one."""
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    s = shape[1]
    mask = rng.rand(1, 1, s, s) > 0.3 if masked else None
    assert masked or not tfa.supports(s, s, shape[3])
    want = np.asarray(jattn._sdpa_reference(
        *map(jnp.asarray, (q, k, v)),
        mask=None if mask is None else jnp.asarray(mask), causal=True))
    counts = (tfa.fwd_launches, tfa.bwd_launches)
    got = TF.scaled_dot_product_attention(
        *_t(q, k, v), attn_mask=None if mask is None
        else torch.from_numpy(mask), is_causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)
    assert (tfa.fwd_launches, tfa.bwd_launches) == counts


@pytest.mark.parametrize("flag", [False, True])
def test_sdpa_dropout_in_training_runs_and_is_seeded(flag):
    """Dropout in training runs (the reference path, or with
    FLAGS_flash_dropout_kernel the flash dropout bodies) and repeats itself
    under the same `paddle_tpu_torch.seed`; out of training it is off."""
    import paddle_tpu_torch as ptt

    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rng.randn(1, 128, 2, 128).astype(np.float32))
               for _ in range(3))
    ptt.set_flags({"FLAGS_flash_dropout_kernel": flag})
    try:
        ptt.seed(12)
        a = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.1)
        b = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.1)
        ptt.seed(12)
        a2 = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.1)
        out, none = TF.flash_attention(q, k, v, dropout=0.1, causal=True,
                                       training=False)
    finally:
        ptt.set_flags({"FLAGS_flash_dropout_kernel": False})
    assert torch.equal(a, a2) and not torch.equal(a, b)
    full = TF.scaled_dot_product_attention(q, k, v)
    assert not torch.equal(a, full)
    assert none is None
    torch.testing.assert_close(out, TF.scaled_dot_product_attention(
        q, k, v, is_causal=True), rtol=0, atol=0)


def test_flash_attention_bshd_refuses_unsupported_shapes():
    q = torch.zeros(1, 100, 2, 128)
    with pytest.raises(ValueError, match="unsupported"):
        tfa.flash_attention_bshd(q, q, q)
    assert tfa.supports(4096, 4096, 128, dtype=torch.bfloat16)
    assert not tfa.supports(4096, 4096, 256)
    assert not tfa.supports(4096, 4096, 128, dtype=torch.float16)
