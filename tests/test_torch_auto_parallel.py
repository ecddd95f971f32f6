"""The port's auto-parallel API (`ProcessMesh`, `shard_tensor`, `reshard`,
`shard_layer`, `dtensor_from_fn`, `shard_op`, over DTensor), the spec
forms over the global mesh (`named_sharding`, `distributed.shard_tensor`,
`mark_sharding`) and `distributed.split`, against the JAX package's, on
the CPU.

The port runs a 2 x 2 `ProcessMesh` on 4 gloo ranks
(`torch_zero_workers.auto_parallel_main`); the reference runs the same
2 x 2 mesh over 4 of its CPU devices (`tests/conftest.py`). Rank r's local
shard is held equal to the reference's shard on device r
(`addressable_shards`), the cases mirroring the reference's
`tests/test_auto_parallel.py`. `split` runs at dp 2 x tp 2 with the
reference's weights, its output on each rank equal (within 1e-6) to the
reference's (its tp rank's columns where the output is not gathered).
"""
import jax
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.distributed.mesh as jmesh
from paddle_tpu.distributed.auto_parallel import ProcessMesh as JaxMesh
from paddle_tpu.distributed.auto_parallel import Replicate as JRep
from paddle_tpu.distributed.auto_parallel import Shard as JShard
from paddle_tpu.distributed.auto_parallel import shard_tensor as jshard
from paddle_tpu.distributed.fleet.layers.mpu import mp_layers as jmp
from torch_dist_workers import run_group
from torch_zero_workers import auto_parallel_main

X = np.random.RandomState(0).randn(8, 16).astype(np.float32)
WMAT = np.random.RandomState(3).randn(16, 4).astype(np.float32)
X_LIN = np.random.RandomState(4).randn(2, 3, 8).astype(np.float32)
X_IDS = np.array([[0, 3, 9, 5], [7, 2, 4, 1]])
_rng = np.random.RandomState(5)
# tag -> (operation, size, axis, gather_out, weight, bias)
SPLITS = {
    "linear_column_gathered": ("linear", (8, 6), 1, True,
                               _rng.randn(8, 6).astype(np.float32),
                               _rng.randn(6).astype(np.float32)),
    "linear_column_split": ("linear", (8, 6), 1, False,
                            _rng.randn(8, 6).astype(np.float32),
                            _rng.randn(6).astype(np.float32)),
    "linear_row": ("linear", (8, 6), 0, True,
                   _rng.randn(8, 6).astype(np.float32),
                   _rng.randn(6).astype(np.float32)),
    "embedding": ("embedding", (10, 4), 0, True,
                  _rng.randn(10, 4).astype(np.float32), None),
}


@pytest.fixture(scope="module")
def ranks():
    cases = [(tag, *c) for tag, c in SPLITS.items()]
    res = run_group(auto_parallel_main, 4, X, WMAT, cases, X_LIN, X_IDS)
    return sorted(res, key=lambda r: r["rank"])


@pytest.fixture
def jax_mesh():
    return JaxMesh(np.arange(4).reshape(2, 2), dim_names=["dp", "mp"])


def _device_shards(t):
    """The reference's shard on each of devices 0-3 (device id order)."""
    arr = t._data if hasattr(t, "_data") else t
    return [np.asarray(s.data) for s in sorted(
        arr.addressable_shards, key=lambda s: s.device.id)]


def test_process_mesh_properties(ranks, jax_mesh):
    want = (jax_mesh.shape, jax_mesh.dim_names, jax_mesh.get_dim_size("mp"),
            jax_mesh.process_ids)
    jm = jax_mesh.jax_mesh()
    for r in ranks:
        got = r["auto"]["mesh"]
        assert got[:4] == want
        assert got[4] == tuple(jm.axis_names)
        assert got[5] == tuple(jm.shape[a] for a in jm.axis_names)


def test_shard_tensor_placements(ranks, jax_mesh):
    t = jshard(paddle.to_tensor(X.copy()), jax_mesh, [JShard(0), JShard(1)])
    for r, want in zip(ranks, _device_shards(t)):
        a = r["auto"]
        np.testing.assert_array_equal(a["shard01"], want)
        np.testing.assert_array_equal(a["shard01_full"], X)
        assert a["shard01_placements"]
        assert a["shard01_dims_mapping"] == t.dist_attr.dims_mapping


def test_replicate_and_reshard(ranks, jax_mesh):
    # the reference reshards in place: read each layout when it is made
    t = jshard(paddle.to_tensor(X.copy()), jax_mesh, [JRep(), JShard(0)])
    s1 = _device_shards(t)
    s2 = _device_shards(jdist.reshard(t, jax_mesh, [JRep(), JRep()]))
    t = jshard(paddle.to_tensor(X.copy()), jax_mesh, [JRep(), JShard(0)])
    s3 = _device_shards(jdist.reshard(t, jax_mesh, [JShard(1), JRep()]))
    for r, a1, a2, a3 in zip(ranks, s1, s2, s3):
        a = r["auto"]
        np.testing.assert_array_equal(a["rep_shard0"], a1)
        np.testing.assert_array_equal(a["reshard_rep"], a2)
        np.testing.assert_array_equal(a["reshard_rep"], X)
        assert a["reshard_placements"] == [True, True]
        np.testing.assert_array_equal(a["reshard_shard1"], a3)


def test_partial_of_a_full_value_keeps_it(ranks):
    """The reference treats `Partial` on a full value as replicated; the
    port's DTensor holds a partial sum whose `full_tensor()` is the
    value."""
    for r in ranks:
        assert r["auto"]["partial_is_partial"]
        np.testing.assert_allclose(r["auto"]["partial_full"], X, rtol=1e-6)


def test_shard_layer_replicates_params(ranks, jax_mesh):
    layer = paddle.nn.Linear(8, 8)
    jdist.shard_layer(layer, jax_mesh)
    assert layer.weight._data.sharding.is_fully_replicated
    for r in ranks:
        name, rep, shape = r["auto"]["layer_default"]
        assert name == "DTensor" and rep == [True, True] and shape == (8, 8)


def test_shard_layer_custom_fn(ranks, jax_mesh):
    layer = paddle.nn.Linear(8, 16)

    def shard_fn(name, sub, mesh):
        for p in sub.parameters(include_sublayers=False):
            if len(p.shape) == 2:
                jshard(p, mesh, [JRep(), JShard(1)])

    jdist.shard_layer(layer, jax_mesh, shard_fn)
    for r, s in zip(ranks, _device_shards(layer.weight)):
        placements, shape = r["auto"]["layer_custom"]
        assert placements == [JRep(), JShard(1)] or \
            [p.is_shard(1) if i else p.is_replicated()
             for i, p in enumerate(placements)] == [True, True]
        assert shape == s.shape


def test_dtensor_from_fn(ranks, jax_mesh):
    t = jdist.dtensor_from_fn(
        lambda: paddle.to_tensor(np.ones((4, 8), np.float32)),
        jax_mesh, [JShard(0), JRep()])
    for r, want in zip(ranks, _device_shards(t)):
        placements, local = r["auto"]["from_fn"]
        assert placements[0].is_shard(0) and placements[1].is_replicated()
        np.testing.assert_array_equal(local, want)


def test_sharding_propagates_through_ops(ranks, jax_mesh):
    """The reference's `test_sharding_propagates_under_jit`: an op on a
    row-split input keeps the rows split over "dp"."""
    jm = jax_mesh.jax_mesh()
    xs = jshard(paddle.to_tensor(X.copy()), jax_mesh, [JShard(0), JRep()])
    out = jax.jit(lambda a, b: jax.numpy.tanh(a @ b))(xs._data, WMAT)
    assert "dp" in str(out.sharding.spec)
    assert jm.shape["dp"] == 2
    for r in ranks:
        placements, full = r["auto"]["propagated"]
        assert placements[0].is_shard(0)
        np.testing.assert_allclose(full, np.asarray(out), rtol=1e-5,
                                   atol=1e-5)


def test_shard_op_places_inputs_and_outputs_and_counts_them(ranks,
                                                            jax_mesh):
    f = jdist.shard_op(lambda a, b: a + b, jax_mesh)
    np.testing.assert_array_equal(
        np.asarray(f(paddle.to_tensor(X), paddle.to_tensor(X))._data), 2 * X)
    want_errors = []
    for kw in (dict(in_placements=[[JRep(), JRep()]]),
               dict(out_placements=[None])):
        with pytest.raises(ValueError) as e:
            jdist.shard_op(lambda a, b: (a, b), jax_mesh, **kw)(
                paddle.to_tensor(X), paddle.to_tensor(X))
        want_errors.append(str(e.value))
    for r in ranks:
        kind, local, other = r["auto"]["shard_op"]
        assert kind == "DTensor" and other == "DTensor"
        np.testing.assert_array_equal(local, 2 * X)
        assert r["auto"]["shard_op_errors"] == want_errors


def test_mesh_too_large_rejected(ranks):
    big = JaxMesh(np.arange(64).reshape(8, 8))
    with pytest.raises(ValueError, match="devices"):
        big.jax_mesh()
    for r in ranks:
        assert "devices" in r["auto"]["too_large"]
        assert "63" in r["auto"]["too_large"]


def _jax_global_mesh():
    jmesh.set_mesh(None)
    return jmesh.set_mesh(jmesh.build_mesh(
        dp=2, tp=2, devices=np.asarray(jax.devices("cpu")[:4])))


def test_named_sharding_and_the_spec_form_of_shard_tensor(ranks, jax_mesh):
    _jax_global_mesh()
    try:
        ns = jmesh.named_sharding("dp", "tp")
        spec = [_device_shards(jax.device_put(X, ns))]
        spec.append(_device_shards(jax.device_put(
            X, jmesh.named_sharding(("dp", "tp"), None))))
        dual = _device_shards(jdist.shard_tensor(
            paddle.to_tensor(X.copy()), jax_mesh, [JShard(1), JShard(0)]))
        marked = jdist.get_param_spec(jdist.mark_sharding(
            paddle.to_tensor(np.zeros((4, 2), np.float32)), "dp", None))
    finally:
        jmesh.set_mesh(None)
    for r, a, b, c in zip(ranks, spec[0], spec[1], dual):
        got = r["auto"]
        assert [p.is_shard(0) for p in got["named_sharding"]] == [True, False]
        assert got["named_sharding"][1].is_shard(1)
        assert [p.is_replicated() for p in got["named_sharding_rep"]] == \
            [False, True]
        np.testing.assert_array_equal(got["spec_shard"], a)
        np.testing.assert_array_equal(got["spec_shard_tuple"], b)
        np.testing.assert_array_equal(got["dual_form"], c)
        assert got["mark"] == (marked, None)
        assert got["manual"] is False


def _jax_split(tag):
    """The reference's `split` output with the layer's weights set to the
    case's."""
    op, size, axis, gather_out, weight, bias = SPLITS[tag]
    classes = (jmp.ColumnParallelLinear, jmp.RowParallelLinear,
               jmp.VocabParallelEmbedding)
    inits = {c: c.__init__ for c in classes}

    def patched(cls):
        def init(self, *a, **k):
            inits[cls](self, *a, **k)
            self.weight.set_value(weight)
            if bias is not None and getattr(self, "bias", None) is not None:
                self.bias.set_value(bias)
        return init

    _jax_global_mesh()
    try:
        for c in classes:
            c.__init__ = patched(c)
        x = X_IDS if op == "embedding" else X_LIN
        out = jdist.split(paddle.to_tensor(x), size, op, axis=axis,
                          num_partitions=2, gather_out=gather_out)
        return np.asarray(out._data)
    finally:
        for c in classes:
            c.__init__ = inits[c]
        jmesh.set_mesh(None)


@pytest.mark.parametrize("tag", sorted(SPLITS))
def test_split_at_tp2_matches_the_reference(ranks, tag):
    want = _jax_split(tag)
    gather_out = SPLITS[tag][3]
    for r in ranks:
        got = r["split"][tag]
        if not gather_out:
            t = r["rank"] % 2  # dp 2 x tp 2: tp rank = rank % 2
            want_r = np.split(want, 2, axis=-1)[t]
        else:
            want_r = want
        np.testing.assert_allclose(got, want_r, rtol=1e-6, atol=1e-6)


def test_split_refuses_a_partition_count_as_the_reference(ranks):
    _jax_global_mesh()
    try:
        with pytest.raises(ValueError) as e:
            jdist.split(paddle.to_tensor(X_LIN), (8, 6), "linear", axis=1,
                        num_partitions=4)
    finally:
        jmesh.set_mesh(None)
    for r in ranks:
        assert r["split"]["mismatch"] == str(e.value)
