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
axes "dp" and "tp"; one process a rank) each rank passes its own dp shard
of the batch. After the backward, every gradient is averaged over "dp"
(the model's `sync_gradients` when it is a `DataParallel` /
`TensorParallel`, else one all_reduce a parameter); parameters marked
sequence-parallel have their gradients summed over "tp" by
`register_sequence_parallel_allreduce_hooks`, which the step registers;
the returned loss is the mean over "dp". The tensor-parallel layers run
their own collectives in the forward and backward. A mesh with "pp",
"sharding", "sep", "sp", "cp" or "ep" raises, naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

# the mesh axes a train step does not take yet, and their ROADMAP items
_AXES_NOT_PORTED = {
    "pp": "pipeline parallelism (Queue 1 item 4: pipeline.py)",
    "sharding": "ZeRO sharding (Queue 1 item 4: meta_parallel/sharding/)",
    "sep": "context parallelism (Queue 1 item 4: context_parallel.py)",
    "sp": "context parallelism (Queue 1 item 4: context_parallel.py)",
    "cp": "context parallelism (Queue 1 item 4: context_parallel.py)",
    "ep": "expert parallelism (Queue 1 item 4: MoE)",
}


def check_mesh(mesh):
    """`mesh` if it is the global mesh and holds only "dp" and "tp" axes;
    raises NotImplementedError otherwise, naming what is missing."""
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


def train_step(model, criterion: Callable, optimizer, donate=True,
               model_call: Optional[Callable] = None, sharding_stage=0,
               mesh=None, gradient_merge_steps: int = 1,
               gradient_merge_avg: bool = True):
    """step(inputs, *labels) -> loss (a detached tensor): loss =
    criterion(model_call(model, inputs), *labels) (`model_call` defaults
    to model(inputs)), its gradients, one update; the gradients are
    cleared. `donate` is accepted (PyTorch updates in place anyway).
    `sharding_stage` takes 0 or 1 (replicated); 2-3 raise. `mesh`: None
    (one card) or the global mesh over "dp" and "tp" (`check_mesh`)."""
    if sharding_stage not in (None, 0, 1):
        raise NotImplementedError(
            "train_step: ZeRO sharding stages 2-3 are not ported (ROADMAP "
            f"Queue 1 item 4), sharding_stage={sharding_stage!r}")
    dp = tp = 1
    if mesh is not None:
        from ..distributed.fleet.utils import sequence_parallel_utils as _sp

        check_mesh(mesh)
        names = mesh.mesh_dim_names or ()
        dp = mesh["dp"].size() if "dp" in names else 1
        tp = mesh["tp"].size() if "tp" in names else 1
        if tp > 1:
            _sp.register_sequence_parallel_allreduce_hooks(model)
    call = model_call or (lambda m, x: m(x))
    k_merge = max(int(gradient_merge_steps), 1)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    merge = {"accum": None, "count": 0}

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
        scale = float(np.float32(1.0 / k_merge if gradient_merge_avg
                                 else 1.0))
        # one merged gradient at a time (a generator): no second copy of
        # every gradient is alive at once
        optimizer.apply_gradients(
            ((n, p, (a * scale).to(p.dtype))
             for a, (n, p) in zip(merge["accum"], named)), lr)
        for a in merge["accum"]:
            a.zero_()
        merge["count"] = 0

    def step(*args, **kwargs):
        lr = np.float32(optimizer.get_lr())
        out = call(model, args[0])
        loss = criterion(out, *args[1:], **kwargs)
        loss.backward()
        loss = loss.detach()
        if dp > 1:
            from ..distributed import collective as _c

            _dp_sync(model)
            loss = _c.all_reduce(loss.clone(), op=_c.ReduceOp.AVG,
                                 group="dp")
        apply(lr)
        for _, p in named:
            p.grad = None
        optimizer._step_count += 1
        return loss

    step._merge = merge
    return step
