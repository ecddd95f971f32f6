"""The split-KV paged decode's plan and its plain version against the JAX
package, on the CPU.

The CUDA decode kernel cuts every row's context into splits of whole pages
(`split_plan`), computes each split's f32 partial and combines them in
split order in the same launch. Here:

- `split_plan` covers each row's context once, in order, in whole pages,
  at many page sizes, groups, batches and SM counts, and cuts one
  full-length row into enough units to fill the card;
- `paged_attention_split_ref` (the kernel's computation in plain PyTorch)
  equals the reference's Pallas `paged_attention` (interpret mode off the
  TPU, as the JAX tests run it) and its `paged_attention_xla`, for float
  and int8 pages, groups 1, 4 and 32, context 0, stale table entries and
  contexts at split edges. f32, 1e-5 abs: the same f32 arithmetic summed
  in another order; int8 2e-4 relative (and 2e-5 abs), as
  `test_torch_kv_quant.py`: the dequantization is exact, the reference
  pads its scale rows to 128 lanes;
- the grouped plain version still equals the reference's Pallas
  `paged_attention_grouped` (1e-4 abs, the reference's own bar).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import paged_attention as tpa

ATOL = 1e-5


def _ranges(plan, ctx, page_size, pps):
    """The token ranges [start, end) the kernel's live units take of a row
    of context `ctx` under `plan` (the context clipped to the table)."""
    ctx = max(0, min(ctx, pps * page_size))
    return [(p0 * page_size, min(ctx, p1 * page_size))
            for p0, p1 in tpa.split_bounds(ctx, page_size,
                                           plan["split_pages"])]


@pytest.mark.parametrize("page_size", [1, 3, 5, 16, 128])
@pytest.mark.parametrize("context", [4096, 65536])
@pytest.mark.parametrize("group", [1, 4, 32])
@pytest.mark.parametrize("batch,kv_heads", [(1, 32), (8, 8), (3, 1),
                                            (64, 40)])
@pytest.mark.parametrize("sms", [1, 80, 132])
def test_split_plan_covers_each_context_once_in_whole_pages(
        page_size, context, group, batch, kv_heads, sms):
    pps = max(1, context // page_size)
    plan = tpa.split_plan(batch, kv_heads, group, 128, page_size, pps, sms)
    sp, n = plan["split_pages"], plan["n_splits"]
    assert sp >= 1 and (n - 1) * sp < pps <= n * sp <= tpa.MAX_SPLITS * sp
    assert n <= tpa.MAX_SPLITS
    assert plan["grid"] == (n, kv_heads * plan["chunks"], batch)
    assert plan["chunks"] == -(-group // tpa.QUERY_CHUNK)
    # one full-length row fills the card, unless the split's floor or the
    # cap on the splits stops it
    units = kv_heads * plan["chunks"] * n
    floor = -(-tpa.SPLIT_MIN_TOKENS // page_size)
    assert units >= tpa.UNITS_PER_SM * sms or sp == min(floor, pps) or \
        sp == -(-pps // tpa.MAX_SPLITS)
    for ctx in (0, 1, page_size - 1, page_size, sp * page_size - 1,
                sp * page_size, sp * page_size + 1, pps * page_size - 1,
                pps * page_size, pps * page_size + 7):
        ranges = _ranges(plan, ctx, page_size, pps)
        covered = min(ctx, pps * page_size)
        assert ranges[0][0] == 0 and ranges[-1][1] == covered
        assert len(ranges) <= n
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0 and a1 > a0  # in order, no gap, no overlap
        for a0, a1 in ranges:
            assert a0 % page_size == 0  # whole pages
            assert a1 - a0 <= sp * page_size  # no unit past its split
        assert len(ranges) == max(1, -(-covered // (sp * page_size)))
        if covered:
            assert all(a1 > a0 for a0, a1 in ranges)
    work = plan["workspace"]
    assert work == (0 if n == 1 else batch * kv_heads * plan["chunks"] * n *
                    plan["bucket"] * 130)


def test_split_units_are_balanced():
    """A row's live pages are spread evenly over its live units: at the
    7B plan (28-page splits) a 1000-token row (63 pages) is cut 21 / 21 /
    21, not 28 / 28 / 7, and no two units differ by more than one page."""
    plan = tpa.split_plan(8, 32, 1, 128, 16, 256, 132)
    assert _ranges(plan, 1000, 16, 256) == [
        (0, 336), (336, 672), (672, 1000)]
    for ctx in range(1, 4097, 37):
        pages = [(a1 - a0 + 15) // 16
                 for a0, a1 in _ranges(plan, ctx, 16, 256)]
        assert max(pages) - min(pages) <= 1


def test_split_plan_at_the_table_shapes():
    """The 7B serving shape (8 rows, 32 kv heads, a 256-page table) cuts
    into 10 splits of 28 pages (the last 4); GQA 32/8 into 32 of 8; MQA
    32/1 (four chunks of 8 queries) into 32 of 8 (the 128-token floor).
    The grouped entry runs the same kernel at the same plans."""
    plan = tpa.split_plan(8, 32, 1, 128, 16, 256, 132)
    assert (plan["split_pages"], plan["n_splits"]) == (28, 10)
    plan = tpa.split_plan(8, 8, 4, 128, 16, 256, 132)
    assert (plan["split_pages"], plan["n_splits"]) == (8, 32)
    plan = tpa.split_plan(8, 1, 32, 128, 16, 256, 132)
    assert (plan["split_pages"], plan["n_splits"], plan["chunks"]) == \
        (8, 32, 4)


def _case(seed, b, q_heads, kv_heads, d, page, pps, lens):
    rng = np.random.RandomState(seed)
    n_pages = b * pps
    k = rng.randn(kv_heads, n_pages, page, d).astype(np.float32)
    v = rng.randn(kv_heads, n_pages, page, d).astype(np.float32)
    q = rng.randn(b, q_heads, d).astype(np.float32)
    tables = rng.permutation(n_pages).reshape(b, pps).astype(np.int32)
    return q, k, v, tables, np.asarray(lens, np.int32)


def _quant(k, v):
    kq, ks = tpa._quant_kv_token(torch.from_numpy(k))
    vq, vs = tpa._quant_kv_token(torch.from_numpy(v))
    return kq, ks, vq, vs


def _jax_scales(s):
    pad = ((0, 0), (0, 0), (0, jpa._SCALE_LANES - s.shape[-1]))
    return jnp.asarray(np.pad(s.numpy(), pad))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("q_heads,kv_heads", [(4, 4), (8, 2), (32, 1)])
@pytest.mark.parametrize("split_pages", [1, 2, 3, 6])
def test_split_ref_matches_pallas_and_xla(quant, q_heads, kv_heads,
                                          split_pages):
    """Groups 1, 4 and 32; contexts 0, at split edges (one split's tokens
    -1, +0, +1) and the full table; table entries past each row's context
    made ids far out of the pool (never read)."""
    page, pps, d = 4, 12, 32
    span = split_pages * page
    lens = (0, span - 1, span, span + 1, 2 * span + 1, pps * page)
    q, k, v, tables, ln = _case(q_heads + split_pages, len(lens), q_heads,
                                kv_heads, d, page, pps, lens)
    stale = tables.copy()
    for row, n in enumerate(lens):
        stale[row, -(-n // page):] = 10 ** 6
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, ln)]
    targs = [torch.from_numpy(a) for a in (q, k, v, stale, ln)]
    jsc, tsc, tol = {}, {}, dict(rtol=0, atol=ATOL)
    if quant:
        kq, ks, vq, vs = _quant(k, v)
        jargs[1:3] = jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy())
        targs[1:3] = kq, vq
        jsc = dict(k_scales=_jax_scales(ks), v_scales=_jax_scales(vs))
        tsc = dict(k_scales=ks, v_scales=vs)
        tol = dict(rtol=2e-4, atol=2e-5)
    got = tpa.paged_attention_split_ref(*targs, split_pages=split_pages,
                                        **tsc).numpy()
    want = np.asarray(jpa.paged_attention(*jargs, **jsc))
    np.testing.assert_allclose(got, want, **tol)
    # the XLA reference spreads a context-0 row's weight over its masked
    # positions; the kernels write zeros there, as the Pallas kernel does
    xla = np.asarray(jpa.paged_attention_xla(*jargs, **jsc))
    np.testing.assert_allclose(got[1:], xla[1:], **tol)
    np.testing.assert_array_equal(got[0], 0.0)  # context 0


def test_split_ref_at_the_plans_of_the_kernel():
    """The plain version at the plan the wrapper gives the kernel (a
    small card: 4 SMs) equals the dense plain version, float and int8."""
    page, pps, d = 4, 64, 64
    lens = (0, 1, 127, 128, 129, 255, 256)
    q, k, v, tables, ln = _case(11, len(lens), 8, 2, d, page, pps, lens)
    plan = tpa.split_plan(len(lens), 2, 4, d, page, pps, 4)
    assert plan["n_splits"] > 1
    args = [torch.from_numpy(a) for a in (q, k, v, tables, ln)]
    got = tpa.paged_attention_split_ref(*args,
                                        split_pages=plan["split_pages"])
    torch.testing.assert_close(got, tpa.paged_attention_ref(*args), rtol=0,
                               atol=ATOL)
    kq, ks, vq, vs = _quant(k, v)
    qargs = [args[0], kq, vq, args[3], args[4]]
    got = tpa.paged_attention_split_ref(*qargs, k_scales=ks, v_scales=vs,
                                        split_pages=plan["split_pages"])
    torch.testing.assert_close(
        got, tpa.paged_attention_ref(*qargs, k_scales=ks, v_scales=vs),
        rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("q_heads,kv_heads,lens", [
    (4, 2, (384, 129, 16, 0)), (32, 1, (256, 1, 130)), (8, 8, (17, 255))])
def test_grouped_ref_matches_pallas(q_heads, kv_heads, lens):
    """The grouped plain version against the reference's Pallas
    `paged_attention_grouped`: groups 2, 32 and 1, contexts inside, at and
    past a group's 128 tokens, context 0."""
    pps = 24
    q, k, v, tables, ln = _case(q_heads * 3 + kv_heads, len(lens), q_heads,
                                kv_heads, 128, 16, pps, lens)
    want = np.asarray(jpa.paged_attention_grouped(
        *map(jnp.asarray, (q, k, v, tables, ln))))
    got = tpa.paged_attention_grouped(
        *map(torch.from_numpy, (q, k, v, tables, ln))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_grouped_and_per_page_counters_do_not_move_on_the_cpu():
    q, k, v, tables, ln = _case(5, 2, 4, 2, 128, 16, 8, (3, 100))
    args = [torch.from_numpy(a) for a in (q, k, v, tables, ln)]
    before = (tpa.launches, tpa.q8_launches, tpa.grouped_launches)
    tpa.paged_attention(*args)
    tpa.paged_attention_grouped(*args)
    assert (tpa.launches, tpa.q8_launches, tpa.grouped_launches) == before
