"""ZeRO sharding stages 1-3 (counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/sharding/sharding_optimizer.py`):
`DygraphShardingOptimizer`, `group_sharded_parallel`, and the reference's
spec arithmetic (`zero_axis_for`, `zero_extend_spec`, `shard_spec_for`)
over the port's `DeviceMesh`.

The reference lays the stages out as GSPMD shardings inside its compiled
step, and its eager `DygraphShardingOptimizer.step` is plain data
parallelism (`sharding_optimizer.py:105-138`). Here the stages are runtime
machinery (`group_sharded.ZeroEngine`), in the eager step and in
`jit.train_step` alike: the optimizer's state covers only this rank's
slices; at stage 2 the gradients are reduce_scattered in the backward; at
stage 3 the parameters are stored as slices between steps and gathered
around each block's forward and backward. `state_dict` /
`set_state_dict` hold the rank's own slices, as Paddle's do. At pipeline
degree > 1 the engine runs over the rank's stage (`PipelineParallel`'s
`train_batch` and `build_train_step` drive it: one reduce_scatter a
bucket a step whatever the microbatches), and `fleet.save` writes the
slices as pieces of one checkpoint (`distributed/checkpoint.py`).
"""
from __future__ import annotations

import torch

from .... import collective as _collective
from .... import mesh as _mesh
from .group_sharded import ZeroEngine, zero_axis_for  # noqa: F401

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def zero_extend_spec(shape, base_spec, mesh, axis=None):
    """A parameter's spec (`base_spec`, entries naming mesh axes or None)
    with the ZeRO axis on the first replicated dimension it divides: the
    layout the reference stores gradients (stage >= 2) and parameters
    (stage 3) in."""
    axis = axis or zero_axis_for(mesh)
    names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
    if mesh is None or axis not in names:
        return tuple(base_spec or [None] * len(shape))
    size = int(mesh[axis].size())
    spec = list(base_spec or [])
    spec += [None] * (len(shape) - len(spec))
    if size <= 1 or not shape:
        return tuple(spec)
    for i, s in enumerate(spec):
        if s is None and shape[i] % size == 0:
            spec[i] = axis
            return tuple(spec)
    return tuple(spec)


def shard_spec_for(array_shape, stage: int, axis="sharding"):
    """The spec of an optimizer-state, gradient or parameter leaf: `axis`
    on the largest dimension it divides; scalars and indivisible shapes
    replicated."""
    size = _mesh.axis_size(axis)
    if size <= 1 or not array_shape:
        return tuple([None] * len(array_shape))
    dims = list(array_shape)
    order = sorted(range(len(dims)), key=lambda i: -dims[i])
    for i in order:
        if dims[i] % size == 0:
            spec = [None] * len(dims)
            spec[i] = axis
            return tuple(spec)
    return tuple([None] * len(dims))


class DygraphShardingOptimizer:
    """ZeRO over the global mesh's ZeRO axis ("sharding" at degree > 1,
    else "dp") at `stage` 1-3 (`group_sharded.py` says what each does).
    `step` reduces the gradients to this rank's slices, applies the inner
    optimizer's `grad_clip` (a global norm summed over the axis) and its
    update to the rank's pieces, and all_gathers the parameters (stages
    1-2). Stage 3 needs the model: `group_sharded_parallel` or
    `build_train_step` give it. With a ZeRO axis of one rank every stage
    is the inner optimizer (averaged over "dp" first, as the reference's
    eager step). Every other attribute is the inner optimizer's. The
    inner optimizer's update must be element by element (`Lamb`, whose
    trust ratio needs whole tensors, and `LBFGS` raise)."""

    _OWN = ("_inner_opt", "_hcg", "stage", "_zero_engine",
            "_gradient_merge_k", "_gradient_merge_avg")

    def __init__(self, optimizer, hcg=None, stage=1):
        from .....optimizer import optimizer as _opt

        if isinstance(optimizer, (_opt.Lamb, _opt.LBFGS)):
            raise NotImplementedError(
                f"DygraphShardingOptimizer: {type(optimizer).__name__} needs "
                "whole tensors for its update; ZeRO updates slices")
        self._inner_opt = optimizer
        self._hcg = hcg
        self.stage = int(stage)
        self._zero_engine = None
        self._gradient_merge_k = 1
        self._gradient_merge_avg = True
        if self.stage not in (1, 2, 3):
            raise ValueError(f"DygraphShardingOptimizer: stage {stage!r} "
                             "is not 1, 2 or 3")
        if self.stage < 3:
            self._attach(None, self.stage)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def __setattr__(self, item, value):
        if item in self._OWN:
            object.__setattr__(self, item, value)
        else:
            setattr(self._inner_opt, item, value)

    def _attach(self, model, stage):
        """The engine of this optimizer at `stage` over `model` (None at
        stages 1-2: the parameter list alone), built once; None when the
        ZeRO axis has one rank. A model-less engine that has not stepped
        is rebuilt for a model or another stage."""
        if _collective._size(zero_axis_for(
                _mesh.get_mesh(optional=True))) <= 1:
            return None
        eng = self._zero_engine
        if eng is not None and eng.stage == stage and \
                (stage < 3 or eng.model is model):
            return eng
        if eng is not None:
            if eng.stage == 3 or self._inner_opt._accumulators:
                raise ValueError(
                    f"DygraphShardingOptimizer: already sharded at stage "
                    f"{eng.stage}; a step at stage {stage} needs a new "
                    "optimizer")
            eng.detach()
        self._zero_engine = ZeroEngine(self._inner_opt, stage, model)
        self.stage = stage
        return self._zero_engine

    def _engine(self):
        if self._zero_engine is None and self.stage == 3 and \
                _collective._size(zero_axis_for(
                    _mesh.get_mesh(optional=True))) > 1:
            raise ValueError(
                "DygraphShardingOptimizer: stage 3 needs the model; use "
                "group_sharded_parallel(model, optimizer, 'p_g_os')")
        return self._zero_engine

    def _clip(self, engine):
        """The inner `grad_clip` for slices: a global-norm clip as a
        `HybridParallelClipGrad` summing over the ZeRO axis."""
        from .....nn.clip import ClipGradByGlobalNorm, ClipGradByValue
        from ..hybrid_optimizer import HybridParallelClipGrad

        clip = self._inner_opt._grad_clip
        if clip is None or isinstance(clip, ClipGradByValue):
            return clip
        if not isinstance(clip, ClipGradByGlobalNorm):
            raise NotImplementedError(
                f"DygraphShardingOptimizer: {type(clip).__name__} needs each "
                "whole gradient; ZeRO holds slices (ClipGradByGlobalNorm and "
                "ClipGradByValue are taken)")
        if not isinstance(clip, HybridParallelClipGrad):
            clip = HybridParallelClipGrad(clip, self._hcg)
            self._inner_opt._grad_clip = clip
        clip._zero_axes = (engine.axis,)
        return clip

    @torch.no_grad()
    def step(self):
        eng = self._engine()
        if eng is None:
            from ....parallel import average_gradients

            average_gradients(self._inner_opt._parameter_list or [])
            self._inner_opt.step()
            return
        grads = eng.grad_slices()
        self._inner_opt._step_count += 1
        eng.update(self._inner_opt.get_lr(), grads, skip_missing=True,
                   scale_lr=True, clip=self._clip(eng))
        eng.end()

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad(set_to_zero)
        if self._zero_engine is not None:
            self._zero_engine.clear()

    clear_gradients = clear_grad

    def state_dict(self):
        """The inner optimizer's state: this rank's slices of each
        parameter's moments (and master weight), keyed as the inner's."""
        return self._inner_opt.state_dict()

    def set_state_dict(self, state):
        """Restore this rank's slices (a `state_dict` this rank wrote)."""
        eng = self._zero_engine
        if eng is None:
            return self._inner_opt.set_state_dict(state)
        eng.init_states()
        own = {str(i) for i in self._inner_opt._accumulators}
        return self._inner_opt.set_state_dict(
            {k: v for k, v in state.items()
             if "_" not in k or k.partition("_")[0] in own
             or not k.partition("_")[0].isdigit()})

    def state_spec_pytree(self, params):
        """name -> the spec of its optimizer state (`shard_spec_for`)."""
        return {n: shard_spec_for(tuple(a.shape), self.stage)
                for n, a in params.items()}


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False):
    """`paddle.distributed.sharding.group_sharded_parallel`: (model, the
    `DygraphShardingOptimizer` at `level` "os" (stage 1), "os_g" (2) or
    "p_g_os" (3), `scaler`). The model is returned as it is, its
    parameters sharded at once at stage 3. Without a global mesh one is
    built over every rank as "dp". `group`, `sync_buffers`,
    `buffer_max_size`, `segment_size` and `sync_comm` are accepted and
    unused, as in the reference (the bucket size is
    `FLAGS_grad_bucket_mb`); `offload=True` raises."""
    if level not in _LEVELS:
        raise ValueError(f"group_sharded_parallel: level {level!r} is not "
                         f"one of {sorted(_LEVELS)}")
    if offload:
        raise NotImplementedError(
            "group_sharded_parallel(offload=True): offloading the sharded "
            "state to the host is not ported (ROADMAP Queue 1 item 4)")
    import torch.distributed as dist

    if _mesh.get_mesh(optional=True) is None and dist.is_initialized():
        _mesh.init_mesh(dp=dist.get_world_size())
    stage = _LEVELS[level]
    sharded = DygraphShardingOptimizer(optimizer, stage=stage)
    sharded._attach(getattr(model, "_layers", model), stage)
    return model, sharded, scaler
