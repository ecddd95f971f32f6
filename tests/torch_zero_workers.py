"""The rank programs of the port's ZeRO tests
(`tests/test_torch_sharding_stages.py`), run over gloo on the CPU by
`torch_dist_workers.run_group`. They import torch and the port only. The
weights come from the test as the reference model's full numpy state; a
rank takes its shard of the batch (over dp x sharding, data rank =
dp_rank * sharding + sharding_rank) and returns its readings as numpy
arrays and Python numbers."""
from __future__ import annotations

import os

import numpy as np
import torch

from torch_dist_workers import _save

# the reference's own geometry (tests/test_sharding_stages.py:17-31)
TINY = dict(vocab=128, hidden=64, layers=2, heads=4, seq=16)
LR = 1e-3
LEVEL = {1: "os", 2: "os_g", 3: "p_g_os"}


_DEGREES = []


def _fleet(dp=1, sharding=1, tp=1):
    """fleet.init over CPU ranks at these degrees (once while they stay the
    same: each init makes every axis's group anew); (fleet, data rank,
    data ranks, tp rank)."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import fleet

    torch.set_num_threads(1)
    D.init_parallel_env(device="cpu", timeout=60)
    if _DEGREES != [(dp, sharding, tp)]:
        s = fleet.DistributedStrategy()
        s.hybrid_configs = dict(dp_degree=dp, sharding_degree=sharding,
                                mp_degree=tp)
        fleet.init(is_collective=True, strategy=s)
        _DEGREES[:] = [(dp, sharding, tp)]
    hcg = fleet.get_hybrid_communicate_group()
    d = hcg.get_data_parallel_rank() * sharding + \
        hcg.get_sharding_parallel_rank()
    return fleet, d, dp * sharding, hcg.get_model_parallel_rank()


def _model(state):
    from paddle_tpu_torch import weights as W
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    return W.load_llama_state(
        LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu"), state)


def _shard(a, d, n):
    k = a.shape[0] // n
    return torch.from_numpy(a[d * k:(d + 1) * k])


def _adamw(params, clip=None):
    from paddle_tpu_torch.optimizer import AdamW

    return AdamW(learning_rate=LR, parameters=params, grad_clip=clip)


def zero_train(state, x, y, steps, dp=1, sharding=1, tp=1, stage=0, merge=1,
               how="step"):
    """`steps` calls of `build_train_step` over the dp x sharding x tp
    mesh: `how` "step" passes `sharding_stage` with a plain AdamW, "gsp"
    goes through `group_sharded_parallel` at `stage`'s level, "fleet"
    through `fleet.distributed_optimizer` (stage 1). Returns the losses,
    this rank's state (`llama_state_to_numpy`: pieces at stage 3), its
    coordinates, the engine's traffic and the update's piece count."""
    from paddle_tpu_torch import weights as W
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel
    from paddle_tpu_torch.models import build_train_step

    fleet, d, n, t = _fleet(dp, sharding, tp)
    model = _model(state)
    dm = fleet.distributed_model(model)
    opt = _adamw(dm.parameters())
    if how == "fleet":
        opt = fleet.distributed_optimizer(opt)
        step = build_train_step(dm, opt)
    elif how == "gsp":
        dm, opt, _ = group_sharded_parallel(dm, opt, level=LEVEL[stage])
        step = build_train_step(dm, opt)
    else:
        step = build_train_step(dm, opt, sharding_stage=stage,
                                gradient_merge_steps=merge)
    xs, ys = _shard(x, d, n), _shard(y, d, n)
    updates = []
    losses = []
    inner = getattr(opt, "_inner_opt", opt)
    for _ in range(steps):
        before = getattr(inner, "_zero_test_updates", 0)
        losses.append(step(xs, ys).item())
        updates.append(getattr(inner, "_zero_test_updates", 0) - before)
    zero = step._zero
    out = dict(losses=losses, state=W.llama_state_to_numpy(model),
               data_rank=d, tp_rank=t, optimizer=type(opt).__name__,
               stage=None if zero is None else zero.stage,
               axis=None if zero is None else zero.axis,
               traffic=dict(zero.traffic) if zero is not None else {},
               pieces=None if zero is None else sum(
                   len(b.pieces) for b in zero.buckets),
               updates=updates)
    return out


def eager_bytes(state, x, y, stage):
    """One eager step at dp 2: the bytes of gradients this rank holds
    after the backward, then of optimizer state and parameters after the
    step (stage 0: `DataParallel` and a plain AdamW; stages 1-3:
    `group_sharded_parallel`)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding \
        .group_sharded import held_bytes

    fleet, d, n, _ = _fleet(dp=2)
    model = _model(state)
    opt = _adamw(model.parameters())
    if stage == 0:
        dm, sopt = fleet.distributed_model(model), opt
    else:
        dm, sopt, _ = group_sharded_parallel(model, opt, level=LEVEL[stage])
    xs, ys = _shard(x, d, n), _shard(y, d, n)
    loss = model.compute_loss(dm(xs), ys)
    loss.backward()
    if stage == 0:
        dm.sync_gradients()
    engine = getattr(sopt, "_zero_engine", None)
    grads = held_bytes(opt, engine)["grads"]
    sopt.step()
    sopt.clear_grad()
    after = held_bytes(opt, engine)
    return dict(grads=grads, state=after["state"], params=after["params"],
                loss=float(loss), buckets=0 if engine is None else
                len(engine.buckets))


def eager_clip(state, x, y, stage):
    """One eager step at dp 2 with `ClipGradByGlobalNorm(1.0)` (stage 0:
    DataParallel; else `group_sharded_parallel`): the norm the clip
    computed and the parameters after the step."""
    from paddle_tpu_torch import weights as W
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    fleet, d, n, _ = _fleet(dp=2)
    model = _model(state)
    opt = _adamw(model.parameters(), clip=ClipGradByGlobalNorm(1.0))
    if stage == 0:
        dm, sopt = fleet.distributed_model(model), opt
    else:
        dm, sopt, _ = group_sharded_parallel(model, opt, level=LEVEL[stage])
    seen = []
    if stage:
        sopt._clip(sopt._zero_engine)
    clip = opt._grad_clip
    norm_of = clip._params_norm

    def recorded(pairs):
        gn = norm_of(pairs)
        seen.append(float(gn))
        return gn

    clip._params_norm = recorded
    xs, ys = _shard(x, d, n), _shard(y, d, n)
    model.compute_loss(dm(xs), ys).backward()
    if stage == 0:
        dm.sync_gradients()
    sopt.step()
    sopt.clear_grad()
    return dict(norms=seen, state=W.llama_state_to_numpy(model))


def eager_inf(state, x, y):
    """Stage 2 under a GradScaler: an inf planted in rank 1's gradient
    slice after the backward; (the parameters unchanged on every rank,
    the scale after the skip, the parameters after a clean step moved)."""
    from paddle_tpu_torch import weights as W
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel

    fleet, d, n, _ = _fleet(dp=2)
    model = _model(state)
    scaler = GradScaler(init_loss_scaling=1024.0)
    model, sopt, scaler = group_sharded_parallel(
        model, _adamw(model.parameters()), level="os_g", scaler=scaler)
    xs, ys = _shard(x, d, n), _shard(y, d, n)
    before = W.llama_state_to_numpy(model)
    before = {k: v.copy() for k, v in before.items()}
    scaler.scale(model.compute_loss(model(xs), ys)).backward()
    got = [b.grad is not None for b in sopt._zero_engine.buckets]
    if d == 1:
        sopt._zero_engine.buckets[0].grad[0] = float("inf")
    scaler.step(sopt)
    sopt.clear_grad()
    after = W.llama_state_to_numpy(model)
    skipped = all(np.array_equal(before[k], after[k]) for k in before)
    scale = scaler.get_loss_scaling()
    scaler.scale(model.compute_loss(model(xs), ys)).backward()
    scaler.step(sopt)
    sopt.clear_grad()
    moved = not all(np.array_equal(before[k], v) for k, v in
                    W.llama_state_to_numpy(model).items())
    return dict(skipped=skipped, scale=scale, moved=moved,
                slices_after_backward=got)


def state_dict_roundtrip(state, x, y, out_dir, rank):
    """Stage 2, one eager step, `paddle_tpu_torch.save` of the optimizer's
    state (this rank's slices, one file a rank), loaded into a fresh
    sharded optimizer over the same model: (the saved shapes, the loaded
    state equal, the whole parameter count)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel

    fleet, d, n, _ = _fleet(dp=2)
    model = _model(state)
    model, sopt, _ = group_sharded_parallel(
        model, _adamw(model.parameters()), level="os_g")
    xs, ys = _shard(x, d, n), _shard(y, d, n)
    model.compute_loss(model(xs), ys).backward()
    sopt.step()
    sopt.clear_grad()
    sd = sopt.state_dict()
    path = os.path.join(out_dir, f"opt{rank}.pdopt")
    ptt.save(sd, path)
    fresh = group_sharded_parallel(
        model, _adamw(model.parameters()), level="os_g")[1]
    fresh.set_state_dict(ptt.load(path, device="cpu"))
    re = fresh.state_dict()
    equal = set(re) == set(sd) and all(
        np.array_equal(np.asarray(re[k]), np.asarray(sd[k]))
        if isinstance(sd[k], torch.Tensor) else re[k] == sd[k] for k in sd)
    sizes = {k: int(v.numel()) for k, v in sd.items()
             if isinstance(v, torch.Tensor) and k.endswith("_moment1")}
    return dict(equal=equal, moment1_elements=sum(sizes.values()),
                params=sum(p.numel() for p in model.parameters()))


def zero_runs_main(out_dir, runs):
    """For each (tag, function name, kwargs) of `runs`, in one group, the
    function's result; each rank saves {tag: result}."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.optimizer import AdamW

    fns = {"train": zero_train, "bytes": eager_bytes, "clip": eager_clip,
           "inf": eager_inf}
    count_updates_on(AdamW)
    out = {}
    for tag, fn, kw in runs:
        if fn == "state_dict":
            out[tag] = state_dict_roundtrip(out_dir=out_dir,
                                            rank=D.get_rank(), **kw)
        else:
            out[tag] = fns[fn](**kw)
    rank = D.get_rank()
    D.destroy_process_group()
    _save(out_dir, rank, out)


def count_updates_on(cls):
    """Count every instance's `_update_param` calls in
    `_zero_test_updates`."""
    inner = cls._update_param

    def counted(self, *a, **k):
        self._zero_test_updates = getattr(self, "_zero_test_updates", 0) + 1
        return inner(self, *a, **k)

    cls._update_param = counted


# ---------------------------------------------------------------------------
# the auto-parallel API and `distributed.split`
# (`tests/test_torch_auto_parallel.py`)
# ---------------------------------------------------------------------------


def _local(t):
    return t.to_local().detach().numpy().copy()


def auto_parallel_results(x, w):
    """The auto-parallel cases on a 2 x 2 `ProcessMesh` of 4 ranks: this
    rank's local shards and what the API reports."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.auto_parallel import (
        Partial, ProcessMesh, Replicate, Shard, shard_tensor)

    mesh = ProcessMesh(np.arange(4).reshape(2, 2), dim_names=["dp", "mp"])
    dm = mesh.device_mesh()
    res = dict(mesh=(mesh.shape, mesh.dim_names, mesh.get_dim_size("mp"),
                     mesh.process_ids, tuple(dm.mesh_dim_names),
                     tuple(dm.shape)))
    xt = torch.from_numpy(x)
    t = shard_tensor(xt, mesh, [Shard(0), Shard(1)])
    res["shard01"] = _local(t)
    res["shard01_full"] = t.full_tensor().numpy()
    res["shard01_placements"] = list(t.placements) == [Shard(0), Shard(1)]
    res["shard01_dims_mapping"] = t.dist_attr.dims_mapping
    t = shard_tensor(xt, mesh, [Replicate(), Shard(0)])
    res["rep_shard0"] = _local(t)
    t2 = D.reshard(t, mesh, [Replicate(), Replicate()])
    res["reshard_rep"] = _local(t2)
    res["reshard_placements"] = [p.is_replicated() for p in t2.placements]
    t3 = D.reshard(t, mesh, [Shard(1), Replicate()])
    res["reshard_shard1"] = _local(t3)
    p = shard_tensor(xt, mesh, [Partial(), Replicate()])
    res["partial_full"] = p.full_tensor().numpy()
    res["partial_is_partial"] = p.placements[0].is_partial()
    from paddle_tpu_torch.nn import Linear

    layer = Linear(8, 8)
    D.shard_layer(layer, mesh)
    res["layer_default"] = (type(layer.weight).__name__, [
        q.is_replicated() for q in layer.weight.placements],
        _local(layer.weight).shape)

    def shard_fn(name, sub, m):
        for pname, prm in list(sub.named_parameters(recurse=False)):
            if prm.dim() == 2:
                sub.register_parameter(pname, torch.nn.Parameter(
                    shard_tensor(prm.detach(), m, [Replicate(), Shard(1)])))

    layer = Linear(8, 16)
    D.shard_layer(layer, mesh, shard_fn)
    res["layer_custom"] = (list(layer.weight.placements),
                           _local(layer.weight).shape)
    t = D.dtensor_from_fn(lambda: torch.ones(4, 8), mesh,
                          [Shard(0), Replicate()])
    res["from_fn"] = (list(t.placements), _local(t))
    # an op on DTensors keeps the row split (the reference's propagation
    # under jit)
    xs = shard_tensor(xt, mesh, [Shard(0), Replicate()])
    ws = shard_tensor(torch.from_numpy(w), mesh, [Replicate(), Replicate()])
    out = torch.tanh(xs @ ws)
    res["propagated"] = (list(out.placements), out.full_tensor().numpy())
    f = D.shard_op(lambda a, b: (a + b, a - b), mesh,
                   in_placements=[[Shard(0), Replicate()],
                                  [Replicate(), Replicate()]],
                   out_placements=[[Replicate(), Replicate()], None])
    s, d = f(xt, xt)
    res["shard_op"] = (type(s).__name__, _local(s), type(d).__name__)
    errs = []
    for kw, args in ((dict(in_placements=[[Replicate(), Replicate()]]),
                      (xt, xt)),
                     (dict(out_placements=[None]), (xt, xt))):
        try:
            D.shard_op(lambda a, b: (a, b), mesh, **kw)(*args)
        except ValueError as e:
            errs.append(str(e))
    res["shard_op_errors"] = errs
    try:
        ProcessMesh(np.arange(64).reshape(8, 8)).device_mesh()
    except ValueError as e:
        res["too_large"] = str(e)
    # the spec forms over the global mesh
    D.init_mesh(dp=2, tp=2)
    res["named_sharding"] = D.named_sharding("dp", "tp")
    res["named_sharding_rep"] = D.named_sharding(None, "dp")
    res["spec_shard"] = _local(D.shard_tensor(xt, "dp", "tp"))
    res["spec_shard_tuple"] = _local(D.shard_tensor(xt, ("dp", "tp"), None))
    res["dual_form"] = _local(D.shard_tensor(xt, mesh, [Shard(1),
                                                        Shard(0)]))
    prm = torch.nn.Parameter(torch.zeros(4, 2))
    res["mark"] = (D.get_param_spec(D.mark_sharding(prm, "dp", None)),
                   D.get_param_spec(torch.nn.Parameter(torch.zeros(1))))
    from paddle_tpu_torch.distributed import sharding_utils

    res["manual"] = sharding_utils.in_manual_region()
    return res


def split_results(cases, x_lin, x_ids):
    """`distributed.split` at tp 2 (the global mesh dp 2 x tp 2) for each
    (tag, operation, size, axis, gather_out, weight, bias): the layer's
    weight set from the full arrays the test gives (the reference's), this
    rank's output; and the refusal of a `num_partitions` that does not
    match."""
    import paddle_tpu_torch.distributed as D

    out = {}
    for tag, op, size, axis, gather_out, weight, bias in cases:
        def init(layer, full_shape, ax, weight=weight, bias=bias):
            n = layer.weight.shape[ax]
            r = layer.rank if n != full_shape[ax] else 0
            with torch.no_grad():
                layer.weight.copy_(torch.from_numpy(weight).narrow(
                    ax, r * n, n))
                if bias is not None:
                    b = torch.from_numpy(bias)
                    if layer.bias.shape != b.shape:
                        b = b.narrow(0, layer.rank * layer.bias.shape[0],
                                     layer.bias.shape[0])
                    layer.bias.copy_(b)

        D._split_init = init
        x = torch.from_numpy(x_ids if op == "embedding" else x_lin)
        y = D.split(x, size, op, axis=axis, num_partitions=2,
                    gather_out=gather_out)
        out[tag] = y.detach().numpy().copy()
    try:
        D.split(torch.from_numpy(x_lin), (8, 6), "linear", axis=1,
                num_partitions=4)
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


def auto_parallel_main(out_dir, x, w, cases, x_lin, x_ids):
    import paddle_tpu_torch.distributed as D

    torch.set_num_threads(1)
    D.init_parallel_env(device="cpu", timeout=60)
    res = dict(rank=D.get_rank(), auto=auto_parallel_results(x, w),
               split=split_results(cases, x_lin, x_ids))
    D.destroy_process_group()
    _save(out_dir, res["rank"], res)
