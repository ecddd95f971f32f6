"""The rank programs of the port's distributed tests
(`tests/test_torch_distributed.py`, `tests/test_torch_data_parallel.py`),
run by `paddle_tpu_torch.distributed.spawn` over gloo on the CPU. They
import torch and the port only (a spawned rank imports this module, not
the test files, which import JAX). Each rank writes its readings to
`<out_dir>/rank<r>.pkl` as numpy arrays; the tests compare them with the
JAX package's results in the pytest process.

`run_group` starts one group with a time limit and returns every rank's
readings; on a failure it raises with each rank's traceback (`spawn` kills
the ranks)."""
from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch

GROUP_TIMEOUT_S = 120


def rank_input(rank, shape=(4, 6), seed=100):
    return np.random.RandomState(seed + rank).randn(*shape).astype(
        np.float32)


def _save(out_dir, rank, res):
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def run_group(fn, world, *args):
    """Run `fn(out_dir, *args)` on `world` gloo ranks; [rank readings]."""
    from paddle_tpu_torch.distributed import spawn

    with tempfile.TemporaryDirectory(prefix="torch-dist-") as out:
        spawn(fn, args=(out, *args), nprocs=world, timeout=GROUP_TIMEOUT_S)
        res = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
    return res


def collectives_main(out_dir):
    """Every collective on this rank's shard (`rank_input`) and on one
    tensor common to all ranks (`rank_input(-1)`), over the mesh's dp
    axis or the default group."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M

    dist.init_parallel_env(device="cpu", timeout=60)
    rank, world = dist.get_rank(), dist.get_world_size()
    res = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "initialized": dist.is_initialized()}
    m = dist.init_mesh(dp=world)
    res["mesh"] = (tuple(m.mesh_dim_names), tuple(m.shape))
    x = torch.from_numpy(rank_input(rank))
    same = torch.from_numpy(rank_input(-1))
    for op in ("sum", "max", "min", "avg", "prod"):
        res[f"shard_{op}"] = dist.all_reduce(x.clone(), op).numpy()
        res[f"same_{op}"] = dist.all_reduce(same.clone(), op,
                                            group="dp").numpy()
    res["all_gather"] = np.stack([t.numpy() for t in
                                  dist.all_gather([], x)])
    res["all_gather_jit"] = C.all_gather_jit(x, "dp", axis=1).numpy()
    res["all_gather_jit_untiled"] = C.all_gather_jit(
        x, "dp", axis=0, tiled=False).numpy()
    res["psum"] = C.psum(x, "dp").numpy()
    big = torch.from_numpy(rank_input(rank, (2 * world, 3)))
    out = torch.empty(2, 3)
    res["reduce_scatter"] = dist.reduce_scatter(
        out, list(big.chunk(world)), group="dp").numpy()
    res["psum_scatter"] = C.psum_scatter(big, "dp").numpy()
    res["psum_scatter_untiled"] = C.psum_scatter(
        torch.from_numpy(rank_input(rank, (world, 3))), "dp",
        tiled=False).numpy()
    res["alltoall"] = torch.cat(dist.alltoall(list(big.chunk(world)))
                                ).numpy()
    res["all_to_all_jit"] = C.all_to_all_jit(big, "dp", 0, 1).numpy()
    single = torch.empty_like(big)
    res["alltoall_single"] = dist.alltoall_single(single, big).numpy()
    ring = [(i, (i + 1) % world) for i in range(world)]
    res["ppermute"] = C.ppermute(x, "dp", ring).numpy()
    # the same ring by hand: isend to the next rank, irecv from the last
    got = torch.empty_like(x)
    tasks = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, (rank + 1) % world),
        dist.P2POp(dist.irecv, got, (rank - 1) % world)])
    for t in tasks:
        t.wait()
    res["isend_irecv_ring"] = got.numpy()
    if rank == 0:
        dist.send(x, 1)
    elif rank == 1:
        res["recv_from_0"] = dist.recv(torch.empty_like(x), 0).numpy()
    b = x.clone()
    res["broadcast_from_1"] = dist.broadcast(b, src=1).numpy()
    red = x.clone()
    dist.reduce(red, dst=0, op="sum")
    if rank == 0:
        res["reduce_to_0"] = red.numpy()
    sc = torch.empty(4, 6)
    src_list = [torch.full((4, 6), float(10 * j)) for j in range(world)]
    res["scatter_from_0"] = dist.scatter(sc, src_list if rank == 0 else None,
                                         src=0).numpy()
    gl = []
    dist.gather(x, gl if rank == 0 else None, dst=0)
    if rank == 0:
        res["gather_to_0"] = np.stack([t.numpy() for t in gl])
    objs = []
    dist.all_gather_object(objs, {"rank": rank, "sq": rank * rank})
    res["all_gather_object"] = objs
    lst = [rank, "x"]
    dist.broadcast_object_list(lst, src=world - 1)
    res["broadcast_object_list"] = lst
    outs = []
    dist.scatter_object_list(outs, [f"o{j}" for j in range(world)]
                             if rank == 0 else None, src=0)
    res["scatter_object_list"] = outs
    g = dist.new_group([0, 1])
    if rank in (0, 1):
        res["subgroup_sum"] = dist.all_reduce(x.clone(), group=g).numpy()
        res["subgroup"] = (g.ranks, g.nranks, g.rank)
    dist.barrier()
    C.reset_calls()
    dist.all_reduce(x.clone(), group="tp")  # an axis the mesh lacks
    res["absent_axis_calls"] = dict(C.calls)
    res["hcg"] = _hcg_readings(world)
    dist.destroy_process_group()
    res["after_destroy"] = (dist.is_initialized(), M.get_mesh(optional=True))
    _save(out_dir, rank, res)


def _hcg_readings(world):
    """This rank's coordinates on a (dp, tp) mesh of the world (2 x 2 at
    world 4) through HybridCommunicateGroup."""
    from paddle_tpu_torch.distributed import mesh as M

    if world != 4:
        return None
    m = M.build_mesh(dp=2, tp=2)
    hcg = M.HybridCommunicateGroup(mesh=m)
    return dict(names=tuple(m.mesh_dim_names), shape=tuple(m.shape),
                dp_rank=hcg.get_data_parallel_rank(),
                tp_rank=hcg.get_model_parallel_rank(),
                dp_size=hcg.get_data_parallel_world_size(),
                mode=hcg.get_parallel_mode())


# ---------------------------------------------------------------------------
# DataParallel
# ---------------------------------------------------------------------------

MLP = (8, 16, 4)
GLOBAL_BATCH = 8
STEPS = 3
LR = 0.01


def mlp_weights(seed=3):
    rng = np.random.RandomState(seed)
    dims = MLP
    return [(rng.randn(dims[i], dims[i + 1]).astype(np.float32) * 0.3,
             rng.randn(dims[i + 1]).astype(np.float32) * 0.1)
            for i in range(len(dims) - 1)]


def global_batch(seed=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(GLOBAL_BATCH * STEPS, MLP[0]).astype(np.float32),
            rng.randn(GLOBAL_BATCH * STEPS, MLP[-1]).astype(np.float32))


class _Mlp(torch.nn.Module):
    def __init__(self, weights, perturb=0.0):
        super().__init__()
        from paddle_tpu_torch.nn import Linear

        self.layers = torch.nn.ModuleList()
        for w, b in weights:
            lin = Linear(w.shape[0], w.shape[1], device="cpu", has_bias=True)
            with torch.no_grad():
                lin.weight.copy_(torch.from_numpy(w) + perturb)
                lin.bias.copy_(torch.from_numpy(b))
            self.layers.append(lin)

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def _grads_of(model):
    return [p.grad.clone() for p in model.parameters()]


def _set_grads(model, seed):
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)


def data_parallel_main(out_dir):
    """3 AdamW steps of DataParallel over batch shards from a
    DistributedBatchSampler (rank 0 starts from perturbed weights: the
    construction's broadcast must overwrite them); then the bucket
    checks on seeded gradients."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import parallel as P
    from paddle_tpu_torch.io import (DataLoader, DistributedBatchSampler,
                                     TensorDataset)
    from paddle_tpu_torch.optimizer import AdamW

    dist.init_parallel_env(device="cpu", timeout=60)
    rank, world = dist.get_rank(), dist.get_world_size()
    dist.init_mesh(dp=world)
    res = {"rank": rank}
    net = _Mlp(mlp_weights(), perturb=0.5 if rank != 0 else 0.0)
    dp = dist.DataParallel(net)
    opt = AdamW(learning_rate=LR, parameters=dp.parameters(),
                weight_decay=0.01)
    xs, ys = global_batch()
    per_step = []
    for s in range(STEPS):
        sl = slice(s * GLOBAL_BATCH, (s + 1) * GLOBAL_BATCH)
        ds = TensorDataset([xs[sl], ys[sl]])
        sampler = DistributedBatchSampler(ds, GLOBAL_BATCH // world)
        (x, y), = list(DataLoader(ds, batch_sampler=sampler))
        loss = ((dp(x) - y) ** 2).mean()
        loss.backward()
        dp.sync_gradients()
        per_step.append([g.numpy().copy() for g in _grads_of(dp)])
        opt.step()
        opt.clear_grad()
    res["params"] = [p.detach().numpy().copy() for p in dp.parameters()]
    res["grads"] = per_step

    # bucketed against per-parameter, on the same seeded gradients
    def synced(flags, seed=7):
        set_flags(flags)
        m = dist.DataParallel(_Mlp(mlp_weights()))
        _set_grads(m, seed + rank)
        n_buckets = len(P._bucket_grads(list(m.parameters())))
        C.reset_calls()
        m.sync_gradients()
        return ([g.numpy() for g in _grads_of(m)], C.calls["all_reduce"],
                n_buckets, m)

    per_param, n_pp, _, _ = synced({"FLAGS_train_overlap": False})
    tiny, n_t, _, _ = synced({"FLAGS_train_overlap": True,
                              "FLAGS_grad_bucket_mb": 0})
    bucketed, n_b, n_buckets, m = synced({"FLAGS_grad_bucket_mb": 25})
    res["per_param"], res["bucketed"], res["tiny_buckets"] = \
        per_param, bucketed, tiny
    res["calls"] = dict(per_param=n_pp, bucketed=n_b, tiny=n_t,
                        n_params=len(list(m.parameters())),
                        n_buckets=n_buckets)
    # no_sync skips the reduce; the window closed, it reduces again
    _set_grads(m, 11)
    C.reset_calls()
    with m.no_sync():
        m.sync_gradients()
    res["no_sync_calls"] = C.calls["all_reduce"]
    m.sync_gradients()
    res["after_no_sync_calls"] = C.calls["all_reduce"]
    # a gradient that goes mid-run: the per-parameter fallback, for good
    params = list(m.parameters())
    params[1].grad = None
    C.reset_calls()
    m.sync_gradients()
    res["fallback"] = (m._bucket_fallback, C.calls["all_reduce"])
    _set_grads(m, 12)
    C.reset_calls()
    m.sync_gradients()
    res["fallback_after"] = (m._bucket_fallback, C.calls["all_reduce"])
    dist.destroy_process_group()
    _save(out_dir, rank, res)


def noop_main():
    pass


def failing_main(out_dir):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env(device="cpu", timeout=60)
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()
