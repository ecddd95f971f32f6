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
                ours = tmm.supports(m, k, n, dtype=torch.float32)
                assert ours == (m >= 1 and k > 0 and n > 0 and k % 64 == 0
                                and n % 128 == 0)
                if jmm.supports(m, k, n):
                    assert ours and tmm.supports(m, k, n, dtype=torch.bfloat16)
    assert not tmm.supports(8, 128, 128, dtype=torch.float16)


@pytest.mark.parametrize("dtype,m,n,names,default", [
    (torch.bfloat16, 8, 4096, ("skinny", "m16"), "skinny"),
    (torch.bfloat16, 16, 384, ("skinny", "m16"), "skinny"),
    (torch.bfloat16, 17, 4096, ("128x256", "128x128"), "128x256"),
    (torch.bfloat16, 4096, 11008, ("128x256", "128x128"), "128x256"),
    (torch.bfloat16, 4096, 384, ("128x256", "128x128"), "128x128"),
    (torch.float32, 8, 4096, ("m16", "m64"), "m16"),
    (torch.float32, 300, 256, ("m16", "m64"), "m64"),
    (torch.float16, 8, 128, (), None)])
def test_tiles_and_default_tile(dtype, m, n, names, default):
    """The kernel variants that take m rows (the tuner's candidates) and
    the one a call without `tile` runs: bf16 the decode kernels at m <= 16
    and the wgmma tiles above, the 128 x 128 tile where n is not a
    multiple of 256; f32 the split kernel's row tiles."""
    assert tmm.variants(dtype, m) == names
    if default is not None:
        assert tmm.default_variant(m, n, dtype) == default
        assert default in tmm.variants(dtype, m)
    assert set(names) <= set(tmm.variants(dtype))


# LLaMA-2-7B's linears (4096->4096, ->11008, 11008->4096, ->32000) and the
# tails: m not a multiple of 128, n not a multiple of 256
_WALKS = [(m, k, n, bn, sms)
          for m in (4096, 2512, 1, 17, 129, 4095)
          for k, n in ((4096, 4096), (4096, 11008), (11008, 4096),
                       (4096, 32000))
          for bn, sms in ((256, 132), (128, 132))] + [
    (17, 512, 384, 256, 132), (129, 256, 384, 256, 132),
    (300, 1024, 384, 128, 20)]


@pytest.mark.parametrize("m,k,n,bn,sms", _WALKS)
def test_band_walk_visits_every_output_tile_once(m, k, n, bn, sms):
    """The wgmma kernel's persistent walk (`band_tile`, the kernel's
    `sm90::tile_of`) over 128 x bn output tiles: every tile once, in bands
    of row tiles whose x rows fit the band budget, the band's row tiles
    fastest; the blocks' strided shares cover the walk; a tile's columns
    past n (n % 256 == 128 at bn 256) are whole 64-column atoms."""
    sch = tmm.band_schedule(m, k, n, sms, 128, bn)
    tm, tn = sch["tiles_m"], sch["tiles_n"]
    assert (tm, tn) == (-(-m // 128), -(-n // bn))
    assert sch["grid"] == min(tm * tn, sms)
    g = sch["group_m"]
    assert 1 <= g <= tm
    assert g == tm or g * 128 * k * 2 <= tmm._BAND_BYTES
    walk = [tmm.band_tile(t, tm, tn, g) for t in range(tm * tn)]
    assert sorted(walk) == [(i, j) for i in range(tm) for j in range(tn)]
    assert walk[:g] == [(i, 0) for i in range(g)]
    mine = [t for b in range(sch["grid"])
            for t in range(b, tm * tn, sch["grid"])]
    assert sorted(mine) == list(range(tm * tn))
    atoms = [min(bn // 64, (n - j * bn) // 64) for j in range(tn)]
    assert sum(atoms) * 64 == n and all(a >= 1 for a in atoms)


def test_band_walk_at_the_7b_shapes():
    """m = 4096 on 132 SMs: 512 tiles of 128 x 256 at n = 4096 (3.88
    rounds), 1376 at n = 11008 (10.4), 4000 at n = 32000 (30.3)."""
    for n, tiles in ((4096, 512), (11008, 1376), (32000, 4000)):
        sch = tmm.band_schedule(4096, 4096, n, 132, 128, 256)
        assert sch["tiles_m"] * sch["tiles_n"] == tiles
        assert sch["rounds"] == pytest.approx(tiles / 132)


_DECODE = [(k, n, sms, splits)
           for k, n in ((4096, 4096), (4096, 11008), (11008, 4096),
                        (4096, 32000), (5120, 5120), (5120, 13824),
                        (13824, 5120), (192, 384), (320, 128), (64, 128))
           for sms, splits in ((132, None), (114, None), (132, 1),
                               (132, 2))
           if splits is None or splits <= -(-k // 128)] + [
    (5120, 5120, 132, 40), (13824, 5120, 132, 9), (128, 128, 132, None),
    (5120, 13824, 20, None)]


@pytest.mark.parametrize("k,n,sms,splits", _DECODE)
def test_decode_split_covers_k_once_in_order(k, n, sms, splits):
    """The decode kernel's split (`decode_schedule`, `decode_segments`, the
    kernel's unit ranges and `skinny::owner`) over column tiles of 128
    columns and stages of 128 k rows: every (column tile, stage)
    unit is walked by exactly one block; the blocks' shares differ by at
    most one unit; a column tile's segments follow each other in block
    order and cover its k stages once, in order, so its partials are added
    in k order; a tile of one segment is written at once, the others each
    take the slot block + tile, distinct and below grid + tiles_n; by
    default every tile is cut into the same number of k ranges (where the
    SMs hold them), and `splits` cuts every tile into that many."""
    sch = tmm.decode_schedule(k, n, sms, splits)
    kt, tiles_n, grid = sch["kt"], sch["tiles_n"], sch["grid"]
    assert (kt, tiles_n) == (-(-k // 128), n // 128)
    assert sch["units"] == kt * tiles_n
    if splits is not None:
        assert grid == tiles_n * splits
    elif tiles_n <= sms:
        assert grid % tiles_n == 0 and grid <= sms
        assert grid == tiles_n * kt or grid + tiles_n > sms
    else:
        assert grid == sms
    segs = tmm.decode_segments(sch)
    share = [sum(e - s for b, _, s, e, _ in segs if b == blk)
             for blk in range(grid)]
    assert max(share) - min(share) <= 1 and min(share) >= 1
    assert [b for b, *_ in segs] == sorted(b for b, *_ in segs)
    slots = [slot for *_, slot in segs if slot is not None]
    assert len(set(slots)) == len(slots)
    assert all(0 <= s < grid + tiles_n for s in slots)
    assert tmm.decode_part_shape(sch, 8)[0] == grid + tiles_n
    per_tile = set()
    for c in range(tiles_n):
        mine = [(b, s, e, slot) for b, cc, s, e, slot in segs if cc == c]
        blocks = [b for b, *_ in mine]
        assert blocks == list(range(blocks[0], blocks[0] + len(blocks)))
        assert blocks[0] == tmm.decode_owner(c * kt, sch["units"], grid)
        assert blocks[-1] == tmm.decode_owner((c + 1) * kt - 1,
                                              sch["units"], grid)
        assert mine[0][1] == 0 and mine[-1][2] == kt
        assert all(a[2] == b[1] for a, b in zip(mine, mine[1:]))
        assert all((slot is None) == (len(mine) == 1)
                   for *_, slot in mine)
        per_tile.add(len(mine))
        if splits is not None or tiles_n <= sms:
            s_ = grid // tiles_n
            assert len(mine) == s_
            assert {e - s for _, s, e, _ in mine} <= {kt // s_, -(-kt // s_)}
    assert len(per_tile) == 1 or tiles_n > sms


def test_decode_split_refuses_more_splits_than_stages():
    with pytest.raises(ValueError, match="splits"):
        tmm.decode_schedule(512, 128, 132, 5)
    with pytest.raises(ValueError, match="splits"):
        tmm.decode_schedule(512, 128, 132, 0)


def test_matmul_on_cpu_is_the_plain_version():
    x = torch.randn(33, 256)
    w = torch.randn(256, 128)
    n0 = tmm.launches
    assert torch.equal(tmm.matmul_fused(x, w, tile=64), torch.matmul(x, w))
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
