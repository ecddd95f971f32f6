"""`train_step` (counterpart of `paddle_tpu/jit/api.py::train_step`), eager,
on one card or one rank of a mesh: the reference compiles forward, loss,
gradients and the update into one XLA program; here they run as PyTorch
operations and the port's kernels, in the same order and with the same
arithmetic.

The step matches the reference's compiled step, which differs from its
eager `Optimizer.step()`:
- the update is `optimizer.apply_gradients` (the reference's
  `apply_gradients_functional`): no `grad_clip`, no `optimize_attr`
  learning-rate scale;
- AdamW's `apply_decay_param_fun` receives each parameter's structured
  name (`llama.layers.0.input_layernorm.weight`), where the eager step
  passes the parameter's `name` ('' for a layer's parameters);
- the learning rate is an f32 scalar (the reference passes a
  `jnp.float32`), read from the optimizer at each call;
- every parameter is updated, one that took no gradient with a zero
  gradient (the reference differentiates every parameter);
- gradient merge (`gradient_merge_steps` k > 1): each call adds its
  gradients to f32 accumulators; the k-th call casts accum * (1 / k) (or
  accum, without `gradient_merge_avg`) to each parameter's dtype, applies
  it and zeroes the accumulators. `optimizer._step_count` counts every
  call; the optimizer's state (Adam's beta powers) advances only when a
  merged gradient is applied.

With `mesh` (the global mesh of `fleet.init` / `distributed.init_mesh`,
axes "dp", "sharding" and "tp"; one process a rank) each rank passes its
own shard of the batch, which goes over dp x sharding (the reference
splits its global batch over "dp" alone; both give the global batch's
mean loss). At `sharding_stage` 0 every gradient is averaged over "dp"
(the model's `sync_gradients` when it is a `DataParallel` /
`TensorParallel`, else one all_reduce a parameter) and over "sharding".
At stages 1-3 with a ZeRO axis of more than one rank ("sharding", else
"dp") the step is ZeRO's (`distributed/fleet/meta_parallel/sharding/`):
the gradients are reduce_scattered into this rank's slices (in the
backward at stages 2-3), the update runs on the rank's pieces (one Adam
launch a piece), the parameters are all_gathered after it (stages 1-2)
or kept as slices between steps (stage 3), and gradient merge
accumulates f32 slices. The optimizer may be a `DygraphShardingOptimizer`
(its engine is used) or a plain one (the step builds the engine). Parameters
marked sequence-parallel have their gradients summed over "tp" by
`register_sequence_parallel_allreduce_hooks`, which the step registers;
the returned loss is the mean over dp x sharding. The tensor-parallel
layers run their own collectives in the forward and backward. With "pp"
> 1 the step is the pipeline's (`models.trainer.build_pipeline_train_step`:
each rank holds its stage, and every pp rank of one dp coordinate passes
the same rows), at any ZeRO stage over the stage's own parameters. A mesh with "sep", "sp", "cp" or "ep" raises, naming its
ROADMAP item.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

# the mesh axes a train step does not take yet, and their ROADMAP items
_AXES_NOT_PORTED = {
    "sep": "context parallelism (Queue 1 item 4: context_parallel.py)",
    "sp": "context parallelism (Queue 1 item 4: context_parallel.py)",
    "cp": "context parallelism (Queue 1 item 4: context_parallel.py)",
    "ep": "expert parallelism (Queue 1 item 4: MoE)",
}


def check_mesh(mesh):
    """`mesh` if it is the global mesh and holds only "pp", "dp",
    "sharding" and "tp" axes; raises NotImplementedError otherwise, naming
    what is missing."""
    from ..distributed import mesh as _mesh

    if mesh is not _mesh.get_mesh(optional=True):
        raise NotImplementedError(
            f"train step: mesh {mesh!r} is not the global mesh; build it "
            "with fleet.init or distributed.init_mesh")
    for ax in mesh.mesh_dim_names or ():
        if ax in _AXES_NOT_PORTED:
            raise NotImplementedError(
                f"train step: a mesh with a {ax!r} axis: "
                f"{_AXES_NOT_PORTED[ax]} is not ported")
    return mesh


def _dp_sync(model):
    """Average every gradient over "dp": the model's own bucketed sync
    when it has one (`DataParallel`, `TensorParallel`), else
    `distributed.parallel.average_gradients`."""
    from ..distributed.parallel import average_gradients

    if hasattr(model, "sync_gradients"):
        model.sync_gradients()
    else:
        average_gradients(model.parameters())


def _data_mean(t):
    """`t` averaged in place over "dp", then over "sharding" (each an
    identity where the mesh lacks it)."""
    from ..distributed import collective as _c

    for ax in ("dp", "sharding"):
        _c.all_reduce(t, op=_c.ReduceOp.AVG, group=ax)
    return t


def train_step(model, criterion: Callable, optimizer, donate=True,
               model_call: Optional[Callable] = None, sharding_stage=0,
               mesh=None, gradient_merge_steps: int = 1,
               gradient_merge_avg: bool = True):
    """step(inputs, *labels) -> loss (a detached tensor): loss =
    criterion(model_call(model, inputs), *labels) (`model_call` defaults
    to model(inputs)), its gradients, one update; the gradients are
    cleared. `donate` is accepted (PyTorch updates in place anyway).
    `sharding_stage` 0-3 (ZeRO; see the module's docstring; without a mesh,
    or with a ZeRO axis of one rank, every stage is stage 0). `mesh`: None
    (one card) or the global mesh over "pp", "dp", "sharding" and "tp"
    (`check_mesh`; at "pp" > 1 the pipeline's step, which takes neither
    `model_call` nor gradient merge)."""
    stage = int(sharding_stage or 0)
    from ..distributed import pipeline as _pipe

    if stage not in (0, 1, 2, 3):
        raise ValueError(f"train_step: sharding_stage {sharding_stage!r} is "
                         "not 0, 1, 2 or 3")
    if mesh is not None and _pipe.pp_size(mesh) > 1:
        from ..models.trainer import build_pipeline_train_step

        if model_call is not None or int(gradient_merge_steps) > 1:
            raise NotImplementedError(
                "train_step at pp > 1: the pipeline's step takes the "
                "model's stage forward and no gradient merge (raise "
                "num_microbatches instead)")
        return build_pipeline_train_step(model, optimizer, criterion,
                                         mesh=check_mesh(mesh),
                                         sharding_stage=stage)
    data_ranks = 1
    zero = None
    if mesh is not None:
        from ..distributed.fleet.utils import sequence_parallel_utils as _sp

        check_mesh(mesh)
        names = mesh.mesh_dim_names or ()
        for ax in ("dp", "sharding"):
            data_ranks *= mesh[ax].size() if ax in names else 1
        tp = mesh["tp"].size() if "tp" in names else 1
        if tp > 1:
            _sp.register_sequence_parallel_allreduce_hooks(model)
        if stage >= 1:
            zero = _zero_engine(model, optimizer, stage)
    inner_opt = getattr(optimizer, "_inner_opt", optimizer) \
        if zero is not None else optimizer
    call = model_call or (lambda m, x: m(x))
    k_merge = max(int(gradient_merge_steps), 1)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    merge = {"accum": None, "count": 0}
    scale = float(np.float32(1.0 / k_merge if gradient_merge_avg else 1.0))

    def grad_of(p):
        return p.grad if p.grad is not None else torch.zeros_like(p)

    @torch.no_grad()
    def apply(lr):
        if k_merge == 1:
            optimizer.apply_gradients(
                [(n, p, grad_of(p)) for n, p in named], lr)
            return
        if merge["accum"] is None:
            merge["accum"] = [torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device) for _, p in named]
        for a, (_, p) in zip(merge["accum"], named):
            if p.grad is not None:
                a.add_(p.grad.float())
                p.grad = None
        merge["count"] += 1
        if merge["count"] < k_merge:
            return
        # one merged gradient at a time (a generator): no second copy of
        # every gradient is alive at once
        optimizer.apply_gradients(
            ((n, p, (a * scale).to(p.dtype))
             for a, (n, p) in zip(merge["accum"], named)), lr)
        for a in merge["accum"]:
            a.zero_()
        merge["count"] = 0

    @torch.no_grad()
    def apply_zero(lr):
        """ZeRO's update: True when the parameters moved."""
        grads = zero.grad_slices()
        names = {id(p): n for n, p in named}
        if k_merge == 1:
            zero.update(lr, grads, names)
            return True
        if merge["accum"] is None:
            merge["accum"] = [torch.zeros(b.shard_size, dtype=torch.float32,
                                          device=b.device)
                              for b in zero.buckets]
        for a, g in zip(merge["accum"], grads):
            if g is not None:
                a.add_(g.float())
        merge["count"] += 1
        if merge["count"] < k_merge:
            return False
        zero.update(lr, [(a * scale).to(b.dtype) for a, b in
                         zip(merge["accum"], zero.buckets)], names)
        for a in merge["accum"]:
            a.zero_()
        merge["count"] = 0
        return True

    def step(*args, **kwargs):
        lr = np.float32(inner_opt.get_lr())
        if zero is not None:
            zero.begin()
        out = call(model, args[0])
        loss = criterion(out, *args[1:], **kwargs)
        if zero is not None:
            zero.after_forward(loss)
        loss.backward()
        loss = loss.detach()
        if data_ranks > 1:
            if zero is None:
                _dp_sync(model)
                _sharding_sync(named)
            loss = _data_mean(loss.clone())
        if zero is not None:
            zero.end(updated=apply_zero(lr))
        else:
            apply(lr)
        for _, p in named:
            p.grad = None
        inner_opt._step_count += 1
        return loss

    step._merge = merge
    step._zero = zero
    return step


def _zero_engine(model, optimizer, stage):
    """The ZeRO engine of this step: the `DygraphShardingOptimizer`'s own,
    else one over the plain `optimizer`; None when the ZeRO axis has one
    rank."""
    from ..distributed import collective as _c
    from ..distributed import mesh as _mesh
    from ..distributed.fleet.meta_parallel.sharding import group_sharded \
        as _gs
    from ..distributed.fleet.meta_parallel.sharding.sharding_optimizer \
        import DygraphShardingOptimizer

    inner = getattr(model, "_layers", model)
    if isinstance(optimizer, DygraphShardingOptimizer):
        return optimizer._attach(inner, stage)
    if _c._size(_gs.zero_axis_for(_mesh.get_mesh(optional=True))) <= 1:
        return None
    return _gs.ZeroEngine(optimizer, stage, inner)


def _sharding_sync(named):
    """Stage 0 on a mesh with "sharding": each gradient averaged over it
    too (the batch goes over dp x sharding)."""
    from ..distributed import collective as _c
    from ..distributed import mesh as _mesh

    if _mesh.axis_size("sharding") <= 1:
        return
    for _, p in named:
        if p.grad is not None:
            _c.all_reduce(p.grad, op=_c.ReduceOp.AVG, group="sharding")
