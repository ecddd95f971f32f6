"""The training step (counterpart of `paddle_tpu/models/trainer.py`
`build_train_step` and `prefetch_batches`), on one card: no mesh, no
pipeline, no ZeRO sharding.

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
    (or True), as in the reference. The pipeline and sharding arguments
    (`mesh`, `num_microbatches`, `pipeline_schedule`, `virtual_pp_degree`,
    `sharding_stage` 2-3) take their single-card defaults; any other
    raises. On the card the step carries `_data_put`, which moves a batch
    to the model's device (`prefetch_batches` stages with it)."""
    if mesh is not None or num_microbatches not in (None, 1) \
            or pipeline_schedule is not None or virtual_pp_degree != 1:
        raise NotImplementedError(
            "build_train_step: meshes and pipeline schedules are not ported")
    if sharding_stage is None:
        sharding_stage = getattr(optimizer, "stage", 1)
    if gradient_merge_steps is None:
        gradient_merge_steps = int(getattr(optimizer, "_gradient_merge_k",
                                           1))
    merge_avg = bool(getattr(optimizer, "_gradient_merge_avg", True))
    fused_ce = int(getattr(getattr(model, "config", None),
                           "fused_ce_chunks", 0) or 0)
    model_call = None
    if criterion is None:
        if fused_ce > 0 and hasattr(model, "compute_loss_hidden"):
            model_call = lambda m, x: m.forward_hidden(x)  # noqa: E731
            criterion = lambda h, y: model.compute_loss_hidden(  # noqa: E731
                h, y, chunks=fused_ce)
        else:
            criterion = model.compute_loss
    step = train_step(model, criterion, optimizer, donate=donate,
                      model_call=model_call, sharding_stage=sharding_stage,
                      gradient_merge_steps=gradient_merge_steps,
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
