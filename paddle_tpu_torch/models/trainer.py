"""The training step (counterpart of `paddle_tpu/models/trainer.py`
`build_train_step`, `build_pipeline_train_step` and `prefetch_batches`), on
one card or over the global mesh's "dp", "sharding" and "tp" axes, with
ZeRO stages 1-3 (`jit.train_step`), and over "pp" with the pipeline
schedules (`build_pipeline_train_step`).

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

import numpy as np
import torch

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
    (`fleet.init`), as in the reference; it may hold "pp", "dp",
    "sharding" and "tp" axes (`jit.api.check_mesh`). With "pp" > 1 and a
    model with the pipeline decomposition the step is
    `build_pipeline_train_step`'s (the dense loss, no fused chunked one;
    gradient merge raises the reference's NotImplementedError); without
    it the pipeline arguments are ignored, as in the reference. `model`
    may be the wrapper
    `fleet.distributed_model` returns (its `_layers` give the config and
    the loss). `sharding_stage` defaults to the optimizer's `stage` (a
    `DygraphShardingOptimizer`, or `group_sharded_parallel`'s), else 0:
    the reference defaults to 1, where a plain optimizer's moments are laid
    out over "dp" (`shard_opt_state`); here a plain optimizer keeps whole
    moments unless the stage is passed (the numbers are the same). On the
    card the step carries `_data_put`, which moves a batch to the model's
    device (`prefetch_batches` stages with it)."""
    if mesh is None:
        mesh = _mesh.get_mesh(optional=True)
    if sharding_stage is None:
        sharding_stage = getattr(optimizer, "stage", 0)
    if gradient_merge_steps is None:
        gradient_merge_steps = int(getattr(optimizer, "_gradient_merge_k",
                                           1))
    merge_avg = bool(getattr(optimizer, "_gradient_merge_avg", True))
    inner = getattr(model, "_layers", model)
    from ..distributed import pipeline as _pipe

    if _pipe.pp_size(mesh) > 1 and hasattr(inner, "pp_layers"):
        if gradient_merge_steps > 1:
            raise NotImplementedError(
                "gradient_merge with the pipeline schedule: raise "
                "num_microbatches instead (the pipeline accumulates "
                "microbatch grads inside the schedule already)")
        return build_pipeline_train_step(
            model, optimizer, criterion=criterion, mesh=mesh,
            num_microbatches=num_microbatches, donate=donate,
            sharding_stage=sharding_stage, schedule=pipeline_schedule,
            virtual_pp_degree=virtual_pp_degree)
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
    return _with_data_put(step, model)


def _with_data_put(step, model):
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        def _data_put(a):
            return a.to(dev, non_blocking=True)

        step._data_put = _data_put
        step._device = dev
    return step


def build_pipeline_train_step(model, optimizer,
                              criterion: Optional[Callable] = None,
                              mesh=None, num_microbatches: Optional[int]
                              = None, donate=True,
                              sharding_stage: int = 1,
                              schedule: Optional[str] = None,
                              virtual_pp_degree: int = 1):
    """The pipeline-parallel step over the global mesh's "pp" axis:
    step(input_ids, labels) -> loss (a detached f32 0-d tensor, equal on
    every rank).

    `model` (or the `_layers` of a fleet wrapper) is this rank's stage: a
    LLaMA / GPT built under the mesh, or a `PipelineLayer`. Each rank
    passes its own dp shard of the batch (every pp rank of one dp
    coordinate the same rows; the first stage reads the ids, the last the
    labels). The rows are cut into M contiguous microbatches
    (`pipeline.microbatch`); the schedule (`distributed/pipeline.py`) runs
    them across the ranks, point to point over "pp"; the loss is the mean
    of the microbatch losses (then over "dp"); each parameter's gradient is
    the sum of d(loss_m / M) (f32-accumulated for narrower parameters), a
    shared embedding's summed over its stages, then averaged over "dp"
    (and "sharding"); the update is the compiled step's
    (`optimizer.apply_gradients` over the stage's parameters, their
    structured names to the decay function).

    `schedule`: "1f1b" (default), "gpipe", or "vpp" (the default when
    `virtual_pp_degree` > 1; the model must be built with
    `config.virtual_pp_degree` equal to it; M % pp == 0). `criterion`
    (logits, labels) -> loss defaults to the model's dense
    `compute_loss`. `num_microbatches` defaults to the largest count <=
    2 * pp dividing the rank's batch (for "vpp" a multiple of pp),
    re-derived each call, as the reference's `_resolve_m`. The reference
    raises its errors: an unknown schedule, layers not divisible by pp *
    vpp, no microbatch count for "vpp".

    ZeRO (`sharding_stage` 1-3 with a "sharding" or "dp" axis of more than
    one rank) runs over the stage's own parameters along that axis, within
    the stage's ranks (`group_sharded.ZeroEngine`; a
    `DygraphShardingOptimizer`'s own engine, else one the step builds):
    each bucket is reduce_scattered once a step (stage 1 after the
    schedule, stages 2-3 in the last microbatch's backward, the gradients
    accumulated over the microbatches on the rank first), a shared
    weight's slice summed over its stages, one update a piece of the
    rank's slice, the stage's parameters all_gathered after it (stages
    1-2) or kept as slices (stage 3, gathered around each microbatch's
    forward and backward). The stage defaults to the optimizer's `stage`,
    else 0 (the reference defaults to 1; the numbers are the same). At
    stage 0, or on a ZeRO axis of one rank, the optimizer holds whole
    moments. `donate` is accepted. `step.sync_to_model()` exists and does
    nothing: the stage's modules own their parameters (the reference's
    step keeps stacked copies to write back)."""
    from ..distributed import pipeline as _pipe
    from ..distributed.fleet.meta_parallel import pipeline_parallel as _pp
    from ..distributed.fleet.meta_parallel.pp_utils.p2p_communication \
        import link_for
    from ..distributed.fleet.utils import sequence_parallel_utils as _sp
    from ..jit.api import (_data_mean, _dp_sync, _sharding_sync, _zero_engine,
                           check_mesh)

    mesh = mesh if mesh is not None else _mesh.get_mesh()
    check_mesh(mesh)
    inner = getattr(model, "_layers", model)
    S = _pipe.pp_size(mesh)
    v = int(virtual_pp_degree)
    if schedule is None:
        schedule = "vpp" if v > 1 else "1f1b"
    if schedule not in _pipe.SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                         "use '1f1b', 'gpipe' or 'vpp'")
    if schedule != "vpp":
        v = 1
    elif v < 1:
        raise ValueError(f"virtual_pp_degree must be >= 1, got {v}")
    # a model's decoder layers split evenly (the reference's check); a
    # PipelineLayer's entries are partitioned by its own seg_method
    if hasattr(inner, "config") and \
            inner.config.num_hidden_layers % (S * v):
        raise ValueError(f"{inner.config.num_hidden_layers} layers not "
                         f"divisible by pp*vpp={S}*{v}")
    _pp.check_layout(inner, schedule, v)
    stage_n = int(sharding_stage or 0)
    if stage_n not in (0, 1, 2, 3):
        raise ValueError(f"build_pipeline_train_step: sharding_stage "
                         f"{sharding_stage!r} is not 0, 1, 2 or 3")
    link = link_for(mesh)
    params = list(inner.parameters())
    dev = params[0].device
    # the shared weights' copies made equal before a stage-3 engine slices
    # them (an engine that sliced them already broadcasts its slices)
    _pipe.broadcast_shared_weights(params, link)
    zero = _zero_engine(model, optimizer, stage_n) if stage_n else None
    if _mesh.axis_size("tp") > 1:
        _sp.register_sequence_parallel_allreduce_hooks(inner)
    stage = _pp.model_stage(inner, criterion)
    named = [(n, p) for n, p in inner.named_parameters() if p.requires_grad]
    names = {id(p): n for n, p in named}
    inner_opt = getattr(optimizer, "_inner_opt", optimizer) \
        if zero is not None else optimizer
    data_ranks = _mesh.axis_size("dp") * _mesh.axis_size("sharding")

    def resolve_m(batch):
        if num_microbatches is not None:
            return int(num_microbatches)
        for cand in range(min(2 * S, batch), 0, -1):
            if batch % cand == 0 and (schedule != "vpp" or cand % S == 0):
                return cand
        raise ValueError(
            f"schedule='vpp' needs num_microbatches to be a multiple of "
            f"pp={S}; batch {batch} has no such divisor <= {2 * S} — "
            f"adjust the batch size or pass num_microbatches")

    def step(input_ids, labels):
        lr = np.float32(inner_opt.get_lr())
        m = resolve_m(int(input_ids.shape[0]))
        xs = list(_pipe.microbatch(input_ids, m))
        ys = list(_pipe.microbatch(labels, m))
        if zero is not None:
            zero.begin()
        loss = _pipe.run_schedule(stage, link, xs, ys, schedule, device=dev,
                                  trace=step.trace)
        _pipe.reduce_gradients(params, link)
        if data_ranks > 1:
            if zero is None:
                _dp_sync(model)
                _sharding_sync(named)
            loss = _data_mean(loss.clone())
        with torch.no_grad():
            if zero is not None:
                zero.update(lr, zero.grad_slices(), names)
                zero.end()
            else:
                optimizer.apply_gradients(
                    [(n, p, p.grad if p.grad is not None else
                      torch.zeros_like(p)) for n, p in named], lr)
        for _, p in named:
            p.grad = None
        inner_opt._step_count += 1
        return loss

    def sync_to_model():
        """Nothing to do: each stage's modules own their parameters, which
        the step updates in place (the reference's step keeps stacked
        copies and writes them back here)."""

    step.sync_to_model = sync_to_model
    step.trace = None
    step._link = link
    step._stage = stage
    step._schedule = schedule
    step._resolve_m = resolve_m
    step._zero = zero
    return _with_data_put(step, inner)


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
