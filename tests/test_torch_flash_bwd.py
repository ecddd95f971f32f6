"""The port's one-call flash backward (`flash_bwd`, plain version
`flash_bwd_ref`) against the JAX package's backward, on the CPU in f32.

The reference's `_flash_bwd` runs its two Pallas passes (`_run_dkv_pass`,
`_run_dq_pass`) in interpret mode off the TPU, as its own tests run them,
in all four bodies (plain, segment ids, dropout, both), causal and not,
with s_q != s_kv, with queries that see no key, and with an lse cotangent
folded into delta (`d_lse`). Both sides get the same numpy inputs and the
same explicit dropout seed, so they regenerate the same threefry mask.

Tolerance: each gradient within 1e-4 of the largest magnitude of the
reference's (the f32 arithmetic of the same algorithm summed in another
order; measured ~2e-6), tighter than the 1e-3 of the port's first flash
slice.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa

GRAD_RTOL = 1e-4
SCALE = 128 ** -0.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread, so that the file does not crowd
    the other test workers; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _segments(rng, b, s, pad, pad_id):
    """[b, s] int32 ids of packed sequences of 1-89 tokens, the last `pad`
    positions `pad_id`."""
    out = np.full((b, s), pad_id, np.int32)
    for i in range(b):
        pos, sid = 0, 0
        while pos < s - pad:
            n = min(int(rng.randint(1, 90)), s - pad - pos)
            out[i, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return out


# (b, heads, s_q, s_kv, causal, body)
CASES = [
    (1, 2, 256, 256, True, "plain"),
    (1, 2, 256, 256, False, "plain"),
    (1, 2, 128, 256, True, "plain"),
    (1, 2, 256, 128, True, "plain"),   # the first 128 queries see no key
    (2, 2, 256, 256, True, "seg"),
    (2, 1, 128, 256, False, "seg"),
    (1, 2, 256, 256, True, "drop"),
    (1, 3, 256, 128, False, "drop"),
    (2, 2, 256, 256, True, "seg_drop"),
    (2, 1, 256, 256, False, "seg_drop"),
]


def _case(b, h, s_q, s_kv, body, seed):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(b * h, s_q, 128).astype(np.float32)
             for _ in range(2))
    k, v = (rng.randn(b * h, s_kv, 128).astype(np.float32)
            for _ in range(2))
    sq = sk = None
    if body in ("seg", "seg_drop"):
        # padded queries (-1) and keys (-2) meet nothing
        sq = _segments(rng, b, s_q, 16, -1)
        sk = _segments(rng, b, s_kv, 8, -2)
        if s_q == s_kv:
            sk = np.where(sq < 0, -2, sq).astype(np.int32)
    rate = 0.2 if body in ("drop", "seg_drop") else 0.0
    return q, k, v, do, sq, sk, rate


def _reference(q, k, v, do, sq, sk, h, rate, seed, causal, d_lse=None):
    """The JAX forward and `_flash_bwd` (interpret-mode Pallas passes)."""
    b = q.shape[0] // h
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    kw = dict(heads=h, dropout=rate, seed=seed if rate else None)
    if sq is not None:
        kw.update(seg_q=jfa._seg8(sq, b, q.shape[1]),
                  seg_k=jfa._seg8(sk, b, k.shape[1]))
    out, lse = jfa._flash_fwd(jq, jk, jv, SCALE, causal, 128, 128, **kw)
    grads = jfa._flash_bwd(
        (jq, jk, jv, out, lse), jdo, SCALE, causal, 128, 128,
        d_lse=None if d_lse is None else jnp.asarray(d_lse), **kw)
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("b,h,s_q,s_kv,causal,body", CASES)
def test_flash_bwd_ref_matches_the_reference_backward(b, h, s_q, s_kv,
                                                      causal, body):
    seed = 31 * s_q + s_kv + len(body)
    q, k, v, do, sq, sk, rate = _case(b, h, s_q, s_kv, body, seed)
    var = None
    if body != "plain":
        var = tfa.Variant(None if sq is None else torch.from_numpy(sq),
                          None if sk is None else torch.from_numpy(sk),
                          heads=h, rate=rate, seed=seed)
        assert var.name == body
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = tfa.flash_fwd_ref(tq, tk, tv, SCALE, causal, var)
    delta = tfa.flash_bwd_delta(out, tdo)
    got = tfa.flash_bwd_ref(tq, tk, tv, tdo, lse, delta, SCALE, causal, var)
    want = _reference(q, k, v, do, sq, sk, h, rate, seed, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        assert _rel_err(g.numpy(), w) <= GRAD_RTOL, name
    # the one-call plain version is the two passes' math
    dk, dv = tfa.flash_bwd_dkv_ref(tq, tk, tv, tdo, lse, delta, SCALE,
                                   causal, var)
    dq = tfa.flash_bwd_dq_ref(tq, tk, tv, tdo, lse, delta, SCALE, causal,
                              var)
    for g, w in zip(got, (dq, dk, dv)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    if causal and s_q > s_kv:  # queries that see no key give no gradient
        assert not got[0][:, :s_q - s_kv].any()
    if sq is not None:  # nor do padded queries
        assert not got[0].numpy()[sq.repeat(h, axis=0) < 0].any()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_folds_the_lse_cotangent_as_the_reference(causal):
    """`_backward` with d_lse (the lse entry's gradient) against the
    reference's `_flash_bwd(..., d_lse=...)`."""
    h, s = 2, 256
    q, k, v, do, _, _, _ = _case(1, h, s, s, "plain", 5)
    d_lse = np.random.RandomState(6).randn(h, s).astype(np.float32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = tfa.flash_fwd_ref(tq, tk, tv, SCALE, causal)
    n0 = tfa.bwd_launches
    got = tfa._backward(tq, tk, tv, out, lse, tdo, SCALE, causal, None,
                        torch.from_numpy(d_lse))
    assert tfa.bwd_launches == n0  # CPU tensors: the plain version
    want = _reference(q, k, v, do, None, None, h, 0.0, 0, causal, d_lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g.numpy(), w) <= GRAD_RTOL, name


def test_flash_bwd_dispatch_takes_the_plain_version_on_the_cpu():
    """`flash_bwd` on CPU tensors is `flash_bwd_ref`, bf16 included (the
    gradients in the inputs' dtype), and launches nothing."""
    q, k, v, do, _, _, _ = _case(1, 2, 128, 256, "plain", 9)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    out, lse = tfa.flash_fwd(tq, tk, tv, SCALE, True)
    delta = tfa.flash_bwd_delta(out, tdo)
    counts = (tfa.fwd_launches, tfa.bwd_launches)
    got = tfa.flash_bwd(tq, tk, tv, tdo, lse, delta, SCALE, True)
    want = tfa.flash_bwd_ref(tq, tk, tv, tdo, lse, delta, SCALE, True)
    assert (tfa.fwd_launches, tfa.bwd_launches) == counts
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w)
