"""The training step (counterpart of `paddle_tpu/models/trainer.py`
`build_train_step` and `prefetch_batches`), on one card or over the
global mesh's "dp", "sharding" and "tp" axes, with ZeRO stages 1-3
(`jit.train_step`); no pipeline.

`build_train_step` is `jit.train_step` (eager; see there how it matches
the reference's compiled step) with the model's loss: with
`config.fused_ce_chunks > 0` and no criterion, `forward_hidden` and the
chunked LM-head cross entropy `compute_loss_hidden`; else the model's
forward and `compute_loss` (the dense cross entropy, averaged over every
token). The kernels on the path (the flash-attention forward and backward,
the RMSNorm forward and backward, the Adam update) run under it.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..distributed import mesh as _mesh
from ..framework import config as _config
from ..io.dataloader import DevicePrefetcher
from ..jit.api import train_step


def build_train_step(model, optimizer, criterion: Optional[Callable] = None,
                     mesh=None, donate=True,
                     num_microbatches: Optional[int] = None,
                     sharding_stage: Optional[int] = None,
                     pipeline_schedule: Optional[str] = None,
                     virtual_pp_degree: int = 1,
                     gradient_merge_steps: Optional[int] = None):
    """step(input_ids, labels) -> loss, a detached 0-d tensor on the
    model's device. `gradient_merge_steps` defaults to the optimizer's
    `_gradient_merge_k` (or 1), the averaging to its `_gradient_merge_avg`
    (or True), as in the reference. `mesh` defaults to the global mesh
    (`fleet.init`), as in the reference; it may hold "dp", "sharding" and
    "tp" axes (`jit.api.check_mesh`). `model` may be the wrapper
    `fleet.distributed_model` returns (its `_layers` give the config and
    the loss). `sharding_stage` defaults to the optimizer's `stage` (a
    `DygraphShardingOptimizer`, or `group_sharded_parallel`'s), else 0:
    the reference defaults to 1, where a plain optimizer's moments are laid
    out over "dp" (`shard_opt_state`); here a plain optimizer keeps whole
    moments unless the stage is passed (the numbers are the same). The
    pipeline arguments (`num_microbatches`, `pipeline_schedule`,
    `virtual_pp_degree`) take their defaults; any other raises. On the
    card the step carries `_data_put`, which moves a batch to the model's
    device (`prefetch_batches` stages with it)."""
    if num_microbatches not in (None, 1) or pipeline_schedule is not None \
            or virtual_pp_degree != 1:
        raise NotImplementedError(
            "build_train_step: pipeline schedules are not ported (ROADMAP "
            "Queue 1 item 4: pipeline.py)")
    if mesh is None:
        mesh = _mesh.get_mesh(optional=True)
    if sharding_stage is None:
        sharding_stage = getattr(optimizer, "stage", 0)
    if gradient_merge_steps is None:
        gradient_merge_steps = int(getattr(optimizer, "_gradient_merge_k",
                                           1))
    merge_avg = bool(getattr(optimizer, "_gradient_merge_avg", True))
    inner = getattr(model, "_layers", model)
    fused_ce = int(getattr(getattr(inner, "config", None),
                           "fused_ce_chunks", 0) or 0)
    model_call = None
    if criterion is None:
        if fused_ce > 0 and hasattr(inner, "compute_loss_hidden"):
            model_call = lambda m, x: inner.forward_hidden(x)  # noqa: E731
            criterion = lambda h, y: inner.compute_loss_hidden(  # noqa: E731
                h, y, chunks=fused_ce)
        else:
            criterion = inner.compute_loss
    step = train_step(model, criterion, optimizer, donate=donate,
                      model_call=model_call, sharding_stage=sharding_stage,
                      mesh=mesh, gradient_merge_steps=gradient_merge_steps,
                      gradient_merge_avg=merge_avg)
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        def _data_put(a):
            return a.to(dev, non_blocking=True)

        step._data_put = _data_put
        step._device = dev
    return step


def prefetch_batches(step, data_iter, depth=None):
    """The batches of `data_iter`, each staged on the card ahead of its use
    by a `DevicePrefetcher` over the step's `_data_put` (at most
    `depth`, default `FLAGS_prefetch_depth`, batches ahead). Without a
    `_data_put` (a step on the CPU) or at depth <= 0, the raw iterator, as
    the reference's mesh-less path returns."""
    put = getattr(step, "_data_put", None)
    if depth is None:
        depth = int(_config.get_flag("FLAGS_prefetch_depth", 2))
    if put is None or int(depth) <= 0:
        return iter(data_iter)
    return DevicePrefetcher(data_iter, lambda batch: tuple(
        put(a) for a in batch), depth=depth, device=step._device)
