"""The port's segment-id (varlen), dropout and differentiable-lse flash
attention against the JAX package, on the CPU in f32.

- The threefry mask (`threefry2x32`, `dropout_keep`) is bit-identical to
  the reference's `_threefry2x32` / `_dropout_keep`, with wrapping keys and
  counters and at several tile sizes.
- The plain versions of the seg, drop and seg+drop bodies are held against
  the reference's Pallas passes (`_flash_fwd`, `_run_dkv_pass`,
  `_run_dq_pass`, interpret mode off the TPU, as its own tests run them),
  the segment ids also against its XLA reference (`_xla_ref_fwd`,
  `_xla_ref_bwd`), and the entry points (`flash_attention_bshd`,
  `flash_attn_unpadded`, `flash_attention_with_lse_bshd`, the functional
  `flash_attn_unpadded`) against the reference's, each side given the same
  explicit dropout seed.

Tolerances: forward 2e-5 abs (`FWD_ATOL` of `test_torch_flash.py`: the same
f32 arithmetic summed in another order; outputs are O(1), lse O(10));
gradients 1e-4 relative to the largest magnitude (measured ~2e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.nn import functional as TF

FWD_ATOL = 2e-5
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


@pytest.fixture
def pallas_bwd(monkeypatch):
    """The reference's seg backward takes its XLA recompute below 4096
    tokens; at 128 its Pallas passes run, as the port's always do."""
    monkeypatch.setattr(jfa, "_PALLAS_BWD_MIN_SEQ", 128)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _segments(rng, b, s, pad=0):
    """[b, s] int32 ids of packed sequences of random lengths, the last
    `pad` positions padding (-1)."""
    out = np.full((b, s), -1, np.int32)
    for i in range(b):
        pos, sid = 0, 0
        while pos < s - pad:
            n = min(int(rng.randint(1, 90)), s - pad - pos)
            out[i, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return out


# ---------------------------------------------------------------------------
# the threefry mask
# ---------------------------------------------------------------------------


def test_threefry_bits_equal_the_reference():
    rng = np.random.RandomState(0)
    # keys and counters across the whole uint32 range (sign bit set, sums
    # that wrap), as the reference's int32 lanes hold them
    vals = rng.randint(0, 2 ** 32, size=(4, 512), dtype=np.uint64)
    vals[:, :4] = [[0], [2 ** 32 - 1], [2 ** 31], [2 ** 31 - 1]]
    k0, k1, c0, c1 = vals
    want = jfa._threefry2x32(*(jnp.asarray(v.astype(np.uint32).view(np.int32))
                               for v in (k0, k1, c0, c1)))
    got = tfa.threefry2x32(*(torch.from_numpy(v.astype(np.int64))
                             for v in (k0, k1, c0, c1)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("seed", [7, -5])
@pytest.mark.parametrize("bh", [0, 3])
@pytest.mark.parametrize("block_q,block_k", [(128, 128), (64, 64),
                                             (128, 64), (64, 128)])
def test_dropout_keep_equals_the_reference_at_any_tile(seed, bh, block_q,
                                                       block_k):
    """Tiles of one [256, 256] mask from the reference at block sizes
    64/128 against the port's mask over global positions."""
    rate = 0.3
    want = np.concatenate([np.concatenate(
        [np.asarray(jfa._dropout_keep(jnp.int32(seed), jnp.int32(bh), i, j,
                                      block_q, block_k, rate))
         for j in range(256 // block_k)], axis=1)
        for i in range(256 // block_q)], axis=0)
    got = tfa.dropout_mask(seed, bh + 1, 256, 256, rate)[bh]
    np.testing.assert_array_equal(got.numpy(), want)
    # a 64-tile assembly equals a 128-tile one (the mask ignores tiling)
    whole = np.asarray(jfa._dropout_keep(jnp.int32(seed), jnp.int32(bh), 0,
                                         0, 256, 256, rate))
    np.testing.assert_array_equal(want, whole)


def test_dropout_keep_share_and_decorrelation():
    keep = tfa.dropout_mask(123, 2, 256, 256, 0.3)
    assert abs(keep.float().mean().item() - 0.7) < 0.01
    # other rows of b*h draw other bits
    agree = (keep[0] == keep[1]).float().mean().item()
    assert 0.5 < agree < 0.65  # 0.7^2 + 0.3^2 = 0.58 if independent


# ---------------------------------------------------------------------------
# the variant bodies, pass by pass
# ---------------------------------------------------------------------------

# (b, heads, s_q, s_kv, causal, seg, rate)
PASS_CASES = [
    (2, 2, 256, 256, True, True, 0.0),
    (2, 2, 256, 256, False, True, 0.0),
    (1, 3, 128, 256, True, True, 0.0),
    (2, 2, 256, 256, True, False, 0.2),
    (1, 4, 256, 128, False, False, 0.5),
    (2, 2, 256, 256, True, True, 0.2),
    (2, 1, 128, 256, False, True, 0.1),
]


def _pass_inputs(b, h, s_q, s_kv, seg, seed):
    rng = np.random.RandomState(seed)
    q, do = _rand(rng, b * h, s_q, 128), _rand(rng, b * h, s_q, 128)
    k, v = _rand(rng, b * h, s_kv, 128), _rand(rng, b * h, s_kv, 128)
    sq = sk = None
    if seg:
        sq = _segments(rng, b, s_q, pad=16)
        sk = sq if s_q == s_kv else _segments(rng, b, s_kv)
        if s_q == s_kv:  # key padding never equals query padding
            sk = np.where(sq < 0, -2, sq).astype(np.int32)
    return q, k, v, do, sq, sk


def _variant(sq, sk, h, rate, seed):
    return tfa.Variant(None if sq is None else torch.from_numpy(sq),
                       None if sk is None else torch.from_numpy(sk),
                       heads=h, rate=rate, seed=seed)


@pytest.mark.parametrize("b,h,s_q,s_kv,causal,seg,rate", PASS_CASES)
def test_variant_plain_versions_match_the_pallas_passes(b, h, s_q, s_kv,
                                                        causal, seg, rate):
    seed = 1234 + s_q
    q, k, v, do, sq, sk = _pass_inputs(b, h, s_q, s_kv, seg, seed)
    var = _variant(sq, sk, h, rate, seed)
    assert var.name == {(True, False): "seg", (False, True): "drop",
                        (True, True): "seg_drop"}[(seg, rate > 0)]
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    kw = dict(heads=h, dropout=rate, seed=seed if rate else None)
    if seg:
        kw.update(seg_q=jfa._seg8(sq, b, s_q), seg_k=jfa._seg8(sk, b, s_kv))
    out, lse = jfa._flash_fwd(jq, jk, jv, SCALE, causal, 128, 128, **kw)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    t_out, t_lse = tfa.flash_fwd_ref(tq, tk, tv, SCALE, causal, var)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(lse), rtol=0,
                               atol=FWD_ATOL)
    _, lse8, delta8 = jfa._bwd_delta((jq, jk, jv, out, lse), jdo)
    delta = tfa.flash_bwd_delta(t_out, tdo)
    pk, pv = jfa._run_dkv_pass(jq, jk, jv, jdo, lse8, delta8, SCALE, causal,
                               128, 128, **kw)
    pq = jfa._run_dq_pass(jq, jk, jv, jdo, lse8, delta8, SCALE, causal, 128,
                          128, **kw)
    dk, dv = tfa.flash_bwd_dkv_ref(tq, tk, tv, tdo, t_lse, delta, SCALE,
                                   causal, var)
    dq = tfa.flash_bwd_dq_ref(tq, tk, tv, tdo, t_lse, delta, SCALE, causal,
                              var)
    for name, got, want in (("dq", dq, pq), ("dk", dk, pk), ("dv", dv, pv)):
        assert _rel_err(got.numpy(), want) <= GRAD_RTOL, name


def _aligned_segments(rng, b, s):
    """[b, s] int32 ids of packed sequences whose lengths are multiples of
    64: every 64-row tile lies inside one segment, the tiles the forward
    kernel runs without the segment mask."""
    out = np.empty((b, s), np.int32)
    for i in range(b):
        pos, sid = 0, 0
        while pos < s:
            n = min(64 * int(rng.randint(1, 4)), s - pos)
            out[i, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return out


def _fwd_parity(q, k, v, sq, sk, b, h, causal, rate, seed):
    """flash_fwd_ref against the reference's `_flash_fwd` (Pallas in
    interpret mode) at 64-row blocks, the port kernels' tile."""
    s_q, s_kv = q.shape[1], k.shape[1]
    kw = dict(heads=h, dropout=rate, seed=seed if rate else None)
    if sq is not None:
        kw.update(seg_q=jfa._seg8(sq, b, s_q), seg_k=jfa._seg8(sk, b, s_kv))
    out, lse = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)), SCALE, causal,
                              64, 64, **kw)
    t_out, t_lse = tfa.flash_fwd_ref(*map(torch.from_numpy, (q, k, v)),
                                     SCALE, causal,
                                     _variant(sq, sk, h, rate, seed))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(lse), rtol=0,
                               atol=FWD_ATOL)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_plain_version_on_tile_aligned_segments(causal, rate):
    """Packed ids whose 64-row tiles each lie inside one segment (the
    pattern whose tiles the kernel takes mask-free) against the
    reference's forward."""
    b, h, s = 2, 2, 320
    rng = np.random.RandomState(11)
    q, k, v = (_rand(rng, b * h, s, 128) for _ in range(3))
    ids = _aligned_segments(rng, b, s)
    rq, rk = _variant(ids, ids, h, rate, 5).ranges()
    assert torch.equal(rq[..., 0], rq[..., 1]) and ids.max() > 0
    _fwd_parity(q, k, v, ids, ids, b, h, causal, rate, 5)


@pytest.mark.parametrize("seg,rate", [(False, 0.0), (True, 0.0),
                                      (False, 0.2), (True, 0.2)])
def test_fwd_plain_version_at_a_rectangular_causal_shape(seg, rate):
    """s_q = 192 (a 128-row q tile and a 64-row remainder), s_kv = 320,
    causal bottom-right aligned, every body, against the reference's
    forward."""
    b, h = 1, 2
    q, k, v, _, sq, sk = _pass_inputs(b, h, 192, 320, seg, 77)
    _fwd_parity(q, k, v, sq, sk, b, h, True, rate, 77)


@pytest.mark.parametrize("causal", [True, False])
def test_seg_plain_versions_match_the_xla_reference(causal):
    b, h, s = 2, 2, 256
    q, k, v, do, sq, sk = _pass_inputs(b, h, s, s, True, 77)
    var = _variant(sq, sk, h, 0.0, 0)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    sq8, sk8 = jfa._seg8(sq, b, s), jfa._seg8(sk, b, s)
    out, lse = jfa._xla_ref_fwd(jq, jk, jv, SCALE, causal, seg_q=sq8,
                                seg_k=sk8, heads=h)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    t_out, t_lse = tfa.flash_fwd_ref(tq, tk, tv, SCALE, causal, var)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(lse), rtol=0,
                               atol=FWD_ATOL)
    xq, xk, xv = jfa._xla_ref_bwd((jq, jk, jv, out, lse), jdo, SCALE, causal,
                                  seg_q=sq8, seg_k=sk8, heads=h)
    delta = tfa.flash_bwd_delta(t_out, tdo)
    dk, dv = tfa.flash_bwd_dkv_ref(tq, tk, tv, tdo, t_lse, delta, SCALE,
                                   causal, var)
    dq = tfa.flash_bwd_dq_ref(tq, tk, tv, tdo, t_lse, delta, SCALE, causal,
                              var)
    for name, got, want in (("dq", dq, xq), ("dk", dk, xk), ("dv", dv, xv)):
        assert _rel_err(got.numpy(), want) <= GRAD_RTOL, name
    # padded queries see no key: output 0, lse -1e30, no gradient
    dead = sq.repeat(h, axis=0) < 0
    assert not t_out.numpy()[dead].any() and not dq.numpy()[dead].any()
    np.testing.assert_array_equal(t_lse.numpy()[dead], np.float32(-1e30))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _grads(fn, arrays, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grads(fn, arrays, g):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seg,rate", [(True, 0.0), (False, 0.25),
                                      (True, 0.25)])
def test_flash_attention_bshd_variants_match_the_reference(pallas_bwd,
                                                           causal, seg,
                                                           rate):
    b, s, h = 2, 256, 2
    rng = np.random.RandomState(11)
    q, k, v, g = (_rand(rng, b, s, h, 128) for _ in range(4))
    ids = _segments(rng, b, s) if seg else None
    seed = 99 if rate else None

    def jf(q_, k_, v_):
        return jfa.flash_attention_bshd(
            q_, k_, v_, causal=causal,
            segment_ids_q=None if ids is None else jnp.asarray(ids),
            segment_ids_k=None if ids is None else jnp.asarray(ids),
            dropout=rate, dropout_seed=seed)

    def tf(q_, k_, v_):
        t_ids = None if ids is None else torch.from_numpy(ids)
        return tfa.flash_attention_bshd(
            q_, k_, v_, causal=causal, segment_ids_q=t_ids,
            segment_ids_k=t_ids, dropout=rate, dropout_seed=seed)

    want, want_g = _jax_grads(jf, (q, k, v), g)
    got, got_g = _grads(tf, (q, k, v), g)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    for name, a, w in zip("qkv", got_g, want_g):
        assert _rel_err(a, w) <= GRAD_RTOL, name


def test_dropout_entry_is_deterministic_per_seed_and_never_launches():
    rng = np.random.RandomState(3)
    q = torch.from_numpy(_rand(rng, 1, 128, 2, 128))
    counts = dict(tfa.variant_launches)
    a = tfa.flash_attention_bshd(q, q, q, dropout=0.2, dropout_seed=7)
    b = tfa.flash_attention_bshd(q, q, q, dropout=0.2, dropout_seed=7)
    c = tfa.flash_attention_bshd(q, q, q, dropout=0.2, dropout_seed=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert tfa.variant_launches == counts  # CPU tensors: plain versions
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention_bshd(q, q, q, dropout=0.2)
    ids = torch.zeros(1, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="segment"):
        tfa.flash_attention_bshd(q, q, q, segment_ids_q=ids)
    with pytest.raises(ValueError, match="batch, seq"):
        tfa.flash_attention_bshd(q, q, q, segment_ids_q=ids[:, :64],
                                 segment_ids_k=ids)


UNPADDED = [([100, 28, 128], [100, 28, 128], True),
            ([100, 28, 128], [100, 28, 128], False),
            ([60, 100, 40], [200, 30, 70], False),
            ([256], [256], True)]


@pytest.mark.parametrize("lens_q,lens_k,causal", UNPADDED)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_attn_unpadded_matches_the_reference(pallas_bwd, lens_q,
                                                   lens_k, causal, rate):
    h = 2
    rng = np.random.RandomState(sum(lens_q) + len(lens_k))
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    q, g = (_rand(rng, int(cu_q[-1]), h, 128) for _ in range(2))
    k, v = (_rand(rng, int(cu_k[-1]), h, 128) for _ in range(2))
    seed = 5 if rate else None

    def jf(q_, k_, v_):
        return jfa.flash_attn_unpadded(q_, k_, v_, cu_q, cu_k, max(lens_q),
                                       max(lens_k), dropout=rate,
                                       causal=causal, dropout_seed=seed)[0]

    def tf(q_, k_, v_):
        out, none = tfa.flash_attn_unpadded(
            q_, k_, v_, torch.from_numpy(cu_q), torch.from_numpy(cu_k),
            max(lens_q), max(lens_k), dropout=rate, causal=causal,
            dropout_seed=seed)
        assert none is None
        return out

    want, want_g = _jax_grads(jf, (q, k, v), g)
    got, got_g = _grads(tf, (q, k, v), g)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    for name, a, w in zip("qkv", got_g, want_g):
        assert _rel_err(a, w) <= GRAD_RTOL, name


def test_flash_attn_unpadded_refuses_what_the_reference_refuses():
    q = torch.zeros(5, 2, 128)
    cu_q, cu_k = torch.tensor([0, 2, 5]), torch.tensor([0, 3, 5])
    with pytest.raises(ValueError, match="cu_seqlens_q == cu_seqlens_k"):
        tfa.flash_attn_unpadded(q, q, q, cu_q, cu_k, 3, 3, causal=True)
    with pytest.raises(ValueError, match="matching"):
        tfa.flash_attn_unpadded(q, q, q, cu_q, torch.tensor([0, 5]), 3, 5,
                                causal=True)
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attn_unpadded(q, q, q, cu_q, cu_q, 3, 3, dropout=0.1)


@pytest.mark.parametrize("d,causal", [(128, True), (128, False),
                                      (64, True), (64, False)])
def test_functional_flash_attn_unpadded_matches_the_reference(d, causal):
    """head_dim 128 through the segment-id bodies, 64 through the dense
    segment-masked path; both against the reference's functional, which
    takes its Pallas kernel at 128 and its dense path at 64."""
    import paddle_tpu as paddle

    lens = [70, 130, 56]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    rng = np.random.RandomState(d)
    q, k, v = (_rand(rng, int(cu[-1]), 2, d) for _ in range(3))
    want, none = jattn.flash_attn_unpadded(
        *(paddle.to_tensor(a) for a in (q, k, v)), paddle.to_tensor(cu),
        paddle.to_tensor(cu), max(lens), max(lens), causal=causal)
    got, none_t = TF.flash_attn_unpadded(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(cu),
        torch.from_numpy(cu), max(lens), max(lens), causal=causal)
    assert none is None and none_t is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), rtol=0,
                               atol=FWD_ATOL)


def test_functional_dense_path_errors_match_the_reference():
    import paddle_tpu as paddle

    q = np.zeros((6, 2, 64), np.float32)
    cu, cu2 = np.array([0, 3, 6], np.int32), np.array([0, 2, 6], np.int32)
    for impl, wrap in ((jattn.flash_attn_unpadded, paddle.to_tensor),
                       (TF.flash_attn_unpadded, torch.from_numpy)):
        with pytest.raises(NotImplementedError):
            impl(wrap(q), wrap(q), wrap(q), wrap(cu), wrap(cu), 3, 3,
                 dropout=0.1, training=True)
        with pytest.raises(ValueError, match="cu_seqlens_q"):
            impl(wrap(q), wrap(q), wrap(q), wrap(cu), wrap(cu2), 3, 4,
                 causal=True)
    # out of training the dense path takes dropout > 0 and ignores it
    out, _ = TF.flash_attn_unpadded(*(torch.from_numpy(q),) * 3,
                                    torch.from_numpy(cu),
                                    torch.from_numpy(cu), 3, 3, dropout=0.1,
                                    training=False)
    assert out.shape == (6, 2, 64)


@pytest.mark.parametrize("causal,s_q,s_kv", [(True, 256, 256),
                                             (False, 128, 256),
                                             (True, 256, 128)])
def test_lse_entry_matches_the_reference(causal, s_q, s_kv):
    """out and lse, and the gradients of a loss on both (the lse cotangent
    folds into delta)."""
    b, h = 1, 2
    rng = np.random.RandomState(s_q + s_kv)
    q, g = _rand(rng, b, s_q, h, 128), _rand(rng, b, s_q, h, 128)
    k, v = _rand(rng, b, s_kv, h, 128), _rand(rng, b, s_kv, h, 128)
    g_lse = _rand(rng, b, h, s_q)

    def jloss(q_, k_, v_):
        out, lse = jfa.flash_attention_with_lse_bshd(q_, k_, v_,
                                                     causal=causal)
        live = lse > -1e29
        return (jnp.sum(out * g) + jnp.sum(jnp.where(live, lse, 0.0)
                                           * g_lse), (out, lse))

    (_, (want, want_lse)), want_g = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, lse = tfa.flash_attention_with_lse_bshd(*ts, causal=causal)
    live = lse > -1e29
    (torch.sum(out * torch.from_numpy(g)) + torch.sum(
        torch.where(live, lse, 0.0) * torch.from_numpy(g_lse))).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse),
                               rtol=0, atol=FWD_ATOL)
    for name, t, w in zip("qkv", ts, want_g):
        assert _rel_err(t.grad.numpy(), w) <= GRAD_RTOL, name


def test_lse_entry_cotangent_of_lse_alone():
    """Only the lse differentiated: dout is zero, delta = -d_lse."""
    rng = np.random.RandomState(9)
    q, k, v = (_rand(rng, 1, 128, 2, 128) for _ in range(3))
    (want_q, want_k, _) = jax.grad(
        lambda *a: jnp.sum(jfa.flash_attention_with_lse_bshd(*a)[1]),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa.flash_attention_with_lse_bshd(*ts)[1].sum().backward()
    assert _rel_err(ts[0].grad.numpy(), want_q) <= GRAD_RTOL
    assert _rel_err(ts[1].grad.numpy(), want_k) <= GRAD_RTOL
    assert not ts[2].grad.any()  # the lse does not depend on v
