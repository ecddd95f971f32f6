"""The port's distributed layer against the JAX package's, on the CPU:
TCPStore (the cases of `tests/test_native.py`), the collectives at world 2
and 4 over gloo (one group of spawned ranks a world size, started once by
a module fixture, each with a time limit) against the reference's eager
ops and its `shard_map` on the 8-device CPU mesh, the mesh and topology
arithmetic, `spawn` and the environment's backend rules.

Process model (ROADMAP, deliberate differences): the port runs one process
a rank; the reference one process over a device mesh. With the same
tensor on every rank the port's eager ops give the reference's eager
results; with shard r on rank r, rank r gives what the reference's
`shard_map` gives shard r. Tolerances: f32 sums over at most 4 ranks in
another order, 1e-6 relative; gathers, permutations and max / min exact.
"""
import importlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import paddle_tpu.distributed.mesh as jmesh
from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.store import TCPStore
from torch_dist_workers import collectives_main, rank_input, run_group

try:
    from jax import shard_map as jax_shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map as jax_shard_map

# the module (the package's `spawn` attribute is the function)
tspawn = importlib.import_module("paddle_tpu_torch.distributed.spawn")
RTOL = 1e-6


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def group(request):
    """Every rank's readings of `collectives_main` (one spawn a world)."""
    return request.param, run_group(collectives_main, request.param)


def _shard_map(fn, world, shards):
    """The reference's per-shard program over a 1-D mesh 'x' of `world` CPU
    devices: shard r is rank r's input; returns each shard's output."""
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("x",))
    f = _shard_map_fn(fn, mesh)
    return np.split(np.asarray(f(np.concatenate(shards))), world)


def _shard_map_fn(fn, mesh):
    return jax.jit(jax_shard_map(fn, mesh=mesh, in_specs=P("x"),
                                 out_specs=P("x")))


def _inputs(world, shape=(4, 6)):
    return [rank_input(r, shape) for r in range(world)]


# ---------------------------------------------------------------- TCPStore
def test_tcp_store_ops():
    m = TCPStore(is_master=True, world_size=2)
    c = TCPStore(port=m.port, world_size=2)
    try:
        c.set("k", b"v1")
        assert m.get("k") == b"v1"
        assert m.get("missing") is None
        assert c.add("ctr", 5) == 5
        assert m.add("ctr", 2) == 7
        assert m.num_keys() >= 2
        assert m.delete_key("k") and m.get("k") is None
        c.set("n", 42)
        assert m.get("n") == b"42"
    finally:
        c.close()
        m.close()


def test_tcp_store_wait_and_barrier():
    m = TCPStore(is_master=True, world_size=2)
    c = TCPStore(port=m.port, world_size=2)
    try:
        got = []
        t = threading.Thread(target=lambda: got.append(c.wait("late", 10)))
        t.start()
        time.sleep(0.1)
        m.set("late", b"ok")
        t.join(5)
        assert got == [b"ok"]
        with pytest.raises(TimeoutError):
            m.wait("never", timeout=0.2)
        done = []
        ts = [threading.Thread(
            target=lambda s=s, r=r: (s.barrier("b", r), done.append(r)))
            for r, s in enumerate((m, c))]
        [t.start() for t in ts]
        [t.join(5) for t in ts]
        assert sorted(done) == [0, 1]
    finally:
        c.close()
        m.close()


def test_tcp_store_large_value_and_negative_counter():
    m = TCPStore(is_master=True, world_size=1)
    try:
        blob = bytes(np.random.RandomState(0).bytes(3 << 20))  # 3 MiB
        m.set("big", blob)
        assert m.get("big") == blob  # no truncation at the 1 MiB probe
        assert m.wait("big", timeout=5) == blob
        assert m.add("neg", -5) == -5
        assert m.add("neg", 2) == -3
    finally:
        m.close()


def test_tcp_store_barrier_reusable():
    m = TCPStore(is_master=True, world_size=2)
    c = TCPStore(port=m.port, world_size=2)
    try:
        for _ in range(3):  # the same name, every iteration
            done = []
            ts = [threading.Thread(
                target=lambda s=s: (s.barrier("step", timeout=10),
                                    done.append(1)))
                for s in (m, c)]
            [t.start() for t in ts]
            [t.join(10) for t in ts]
            assert len(done) == 2
    finally:
        c.close()
        m.close()


def test_tcp_store_unreachable_master_times_out():
    port = tspawn.free_port()
    with pytest.raises(TimeoutError):
        TCPStore(port=port, timeout=0.3)


# ------------------------------------------------------------ collectives
def test_group_environment(group):
    world, res = group
    assert [r["rank"] for r in res] == list(range(world))
    for r in res:
        assert r["world"] == world and r["backend"] == "gloo"
        assert r["initialized"] and r["mesh"] == (("dp",), (world,))
        assert r["after_destroy"] == (False, None)
    # the reference's mesh at the same degree
    assert jmesh.build_mesh(dp=world).axis_names == ("dp",)


@pytest.mark.parametrize("op", ["sum", "max", "min", "avg"])
def test_all_reduce_of_one_tensor_matches_the_reference_eager_op(group, op):
    """The same tensor on every rank: the reference's eager all_reduce on
    a replicated input over a dp mesh of the world (SUM gives world * x)."""
    world, res = group
    x = rank_input(-1)
    jmesh.init_mesh(dp=world)
    try:
        want = np.asarray(jcoll.all_reduce(Tensor(jnp.asarray(x)), op,
                                           group="dp")._data)
    finally:
        jmesh.set_mesh(None)
    for r in res:
        np.testing.assert_allclose(r[f"same_{op}"], want, rtol=RTOL)


@pytest.mark.parametrize("op", ["sum", "max", "min", "avg"])
def test_all_reduce_of_shards_matches_shard_map(group, op):
    world, res = group
    red = {"sum": jax.lax.psum, "max": jax.lax.pmax, "min": jax.lax.pmin,
           "avg": jax.lax.pmean}[op]
    want = _shard_map(lambda a: red(a, "x"), world, _inputs(world))
    for r, w in zip(res, want):
        np.testing.assert_allclose(r[f"shard_{op}"], w, rtol=RTOL)
    if op == "sum":  # the reference's own jit helper
        want = _shard_map(lambda a: jcoll.psum(a, "x"), world,
                          _inputs(world))
        for r, w in zip(res, want):
            np.testing.assert_allclose(r["psum"], w, rtol=RTOL)


def test_prod_is_the_product_of_the_ranks(group):
    world, res = group
    want = np.prod(np.stack(_inputs(world)), axis=0)
    for r in res:
        np.testing.assert_allclose(r["shard_prod"], want, rtol=RTOL)


def test_all_gather_matches_shard_map(group):
    world, res = group
    xs = _inputs(world)
    for r in res:
        np.testing.assert_array_equal(r["all_gather"], np.stack(xs))
    for key, axis, tiled in (("all_gather_jit", 1, True),
                             ("all_gather_jit_untiled", 0, False)):
        want = _shard_map(
            lambda a: jcoll.all_gather_jit(a, "x", axis=axis, tiled=tiled),
            world, xs)
        for r, w in zip(res, want):
            np.testing.assert_array_equal(r[key], w)


def test_reduce_scatter_matches_psum_scatter(group):
    world, res = group
    xs = _inputs(world, (2 * world, 3))
    want = _shard_map(lambda a: jcoll.psum_scatter(a, "x"), world, xs)
    for r, w in zip(res, want):
        np.testing.assert_allclose(r["reduce_scatter"], w, rtol=RTOL)
        np.testing.assert_allclose(r["psum_scatter"], w, rtol=RTOL)
    xs = _inputs(world, (world, 3))
    want = _shard_map(lambda a: jcoll.psum_scatter(a, "x", tiled=False),
                      world, xs)
    for r, w in zip(res, want):
        np.testing.assert_allclose(r["psum_scatter_untiled"], w, rtol=RTOL)


def test_all_to_all_matches_shard_map(group):
    world, res = group
    xs = _inputs(world, (2 * world, 3))
    want = _shard_map(lambda a: jcoll.all_to_all_jit(a, "x", 0, 0), world,
                      xs)
    for r, w in zip(res, want):
        np.testing.assert_array_equal(r["alltoall"], w)
        np.testing.assert_array_equal(r["alltoall_single"], w)
    want = _shard_map(lambda a: jcoll.all_to_all_jit(a, "x", 0, 1), world,
                      xs)
    for r, w in zip(res, want):
        np.testing.assert_array_equal(r["all_to_all_jit"], w)


def test_send_recv_ring_matches_ppermute(group):
    world, res = group
    ring = [(i, (i + 1) % world) for i in range(world)]
    want = _shard_map(lambda a: jcoll.ppermute(a, "x", ring), world,
                      _inputs(world))
    for r, w in zip(res, want):
        np.testing.assert_array_equal(r["ppermute"], w)
        np.testing.assert_array_equal(r["isend_irecv_ring"], w)
    np.testing.assert_array_equal(res[1]["recv_from_0"], rank_input(0))


def test_rooted_ops_and_subgroups(group):
    world, res = group
    xs = _inputs(world)
    for r in res:
        np.testing.assert_array_equal(r["broadcast_from_1"], xs[1])
        np.testing.assert_array_equal(r["scatter_from_0"],
                                      np.full((4, 6), 10.0 * r["rank"]))
    np.testing.assert_allclose(res[0]["reduce_to_0"], np.sum(xs, axis=0),
                               rtol=RTOL)
    np.testing.assert_array_equal(res[0]["gather_to_0"], np.stack(xs))
    for r in res[:2]:
        np.testing.assert_allclose(r["subgroup_sum"], xs[0] + xs[1],
                                   rtol=RTOL)
        assert r["subgroup"] == ([0, 1], 2, r["rank"])
    assert all("subgroup" not in r for r in res[2:])
    # an axis the mesh lacks is a group of one: no communication
    assert all(r["absent_axis_calls"] == {"all_reduce": 1} for r in res)


def test_object_collectives(group):
    world, res = group
    for r in res:
        assert r["all_gather_object"] == [{"rank": j, "sq": j * j}
                                          for j in range(world)]
        assert r["broadcast_object_list"] == [world - 1, "x"]
        assert r["scatter_object_list"] == [f"o{r['rank']}"]


def test_one_process_is_a_group_of_one():
    """Without a process group every op is the identity of one rank, as the
    reference's eager ops are at world 1."""
    import paddle_tpu_torch.distributed as tdist

    x = torch.arange(6.0).reshape(2, 3)
    for op in ("sum", "max", "avg"):
        assert torch.equal(tdist.all_reduce(x.clone(), op), x)
        want = np.asarray(jcoll.all_reduce(Tensor(jnp.asarray(x.numpy())),
                                           op)._data)
        np.testing.assert_array_equal(x.numpy(), want)
    out = []
    tdist.all_gather(out, x)
    assert len(out) == 1 and torch.equal(out[0], x)
    objs = []
    tdist.all_gather_object(objs, {"a": 1})
    assert objs == [{"a": 1}]
    assert tdist.get_rank() == 0 and tdist.get_world_size() == 1
    assert tdist.get_backend() is None and not tdist.is_initialized()


# ------------------------------------------------------- mesh and topology
@pytest.mark.parametrize("degrees", [dict(), dict(dp=2), dict(dp=2, tp=4),
                                     dict(pp=2, dp=2, tp=2),
                                     dict(sharding=2, sep=2, tp=2)])
def test_build_mesh_axes_follow_the_reference(degrees):
    """AXIS_ORDER and the degree-1 rule: the axes a mesh of these degrees
    gets, without processes (the port builds the DeviceMesh only after
    init_parallel_env)."""
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    want = jmesh.build_mesh(**degrees)
    sizes = {a: degrees.get(a, 1) for a in tmesh.AXIS_ORDER}
    axes = [a for a in tmesh.AXIS_ORDER if sizes[a] > 1] or ["dp"]
    assert tuple(axes) == want.axis_names
    assert tuple(sizes[a] for a in axes if degrees) == \
        tuple(want.shape[a] for a in want.axis_names if degrees)
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        tmesh.build_mesh(**degrees)
    assert tmesh.axis_size("dp") == 1


@pytest.mark.parametrize("names,dims", [
    (("data", "pipe", "sharding", "model"), (2, 2, 1, 2)),
    (("data", "pipe", "sharding", "model"), (1, 4, 1, 2)),
    (("data", "model"), (4, 2))])
def test_communicate_topology_matches_reference(names, dims):
    want = jmesh.CommunicateTopology(names, dims)
    got = tmesh.CommunicateTopology(names, dims)
    assert got.world_size() == want.world_size()
    for n in names:
        assert got.get_dim(n) == want.get_dim(n)
        assert got.get_comm_list(n) == want.get_comm_list(n)
        for i in range(got.get_dim(n)):
            assert got.get_axis_list(n, i) == want.get_axis_list(n, i)
    for r in range(got.world_size()):
        assert got.get_coord(r) == want.get_coord(r)
        kw = dict(zip(names, got.get_coord(r)))
        assert got.get_rank(**kw) == want.get_rank(**kw) == r


def test_hybrid_group_over_a_topology_matches_reference():
    names, dims = ("data", "pipe", "sharding", "model"), (2, 2, 1, 2)
    for rank in range(8):
        hs = []
        for mod in (jmesh, tmesh):
            h = mod.HybridCommunicateGroup(mod.CommunicateTopology(names,
                                                                   dims))
            h.global_rank = rank
            hs.append(h)
        for fn in ("get_data_parallel_world_size", "get_data_parallel_rank",
                   "get_model_parallel_world_size", "get_model_parallel_rank",
                   "get_pipe_parallel_world_size", "get_stage_id",
                   "get_sharding_parallel_world_size", "get_parallel_mode",
                   "get_data_parallel_group", "get_model_parallel_group"):
            assert getattr(hs[1], fn)() == getattr(hs[0], fn)(), fn
        assert hs[1].get_rank_from_stage(1) == hs[0].get_rank_from_stage(1)


def test_hybrid_group_over_the_mesh(group):
    world, res = group
    if world != 4:
        assert all(r["hcg"] is None for r in res)
        return
    topo = jmesh.CommunicateTopology(("data", "model"), (2, 2))
    for r in res:
        h = r["hcg"]
        assert h["names"] == ("dp", "tp") and h["shape"] == (2, 2)
        assert (h["dp_rank"], h["tp_rank"]) == topo.get_coord(r["rank"])
        assert h["dp_size"] == 2 and h["mode"] == "hybrid"


def test_named_sharding_waits_for_dtensor():
    """Without a global mesh `named_sharding` raises as the reference's
    does (`get_mesh`); with one it gives DTensor placements
    (`tests/test_torch_auto_parallel.py` holds them against the
    reference's shards)."""
    jmesh.set_mesh(None)
    with pytest.raises(RuntimeError):
        jmesh.named_sharding("dp")
    with pytest.raises(RuntimeError):
        tmesh.named_sharding("dp")


# ------------------------------------------------ spawn and the backends
def test_spawn_one_process_per_card_or_one_on_the_cpu(monkeypatch):
    from torch_dist_workers import noop_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    procs = tspawn.spawn(noop_main, nprocs=-1, timeout=60)
    assert len(procs) == 1 and procs[0].exitcode == 0


def test_spawn_fails_with_the_ranks_traceback_and_ends_the_others():
    from torch_dist_workers import failing_main

    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        run_group(failing_main, 2)
    assert "rank 1 fails on purpose" in str(e.value)
    assert "--- rank 1" in str(e.value)
    assert time.monotonic() - t0 < 50  # not the rank's 60 s barrier


def test_env_reads_the_launch_contract(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    assert tenv.get_rank() == 3 and tenv.get_world_size() == 4
    monkeypatch.setenv("PADDLE_MASTER", "10.0.0.1:1234")
    assert tenv._master() == ("10.0.0.1", "1234")
    monkeypatch.delenv("PADDLE_MASTER")
    monkeypatch.setenv("MASTER_ADDR", "h")
    monkeypatch.setenv("MASTER_PORT", "77")
    assert tenv._master() == ("h", "77")


def test_a_rank_without_a_card_raises_unless_it_asks_for_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenv.init_parallel_env()
    assert not tenv.is_initialized()


def test_nccl_with_two_ranks_on_one_card_raises_naming_the_reason(
        monkeypatch):
    """Never moved to gloo: the run fails and names the reason."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one "
                                           "card"):
        tenv.init_parallel_env(device=torch.device("cuda", 0))
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "nccl")
    with pytest.raises(RuntimeError, match="NCCL runs CUDA ranks only"):
        tenv.init_parallel_env(device="cpu")
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "mpi")
    with pytest.raises(ValueError):
        tenv.init_parallel_env(device="cpu")
    assert not tenv.is_initialized()
