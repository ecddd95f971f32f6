"""`PipelineParallel` (counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py`), what
`fleet.distributed_model` returns at pp_degree > 1.

The reference's `train_batch` accumulates gradients over microbatches in
one process (its compiled schedule is `build_train_step`'s). Here it runs
a schedule across the ranks of the "pp" axis (`distributed/pipeline.py`):
each rank holds its stage, activations and cotangents go by point-to-point
transfers, and the loss is the mean of the microbatch losses, broadcast
from the last stage, then averaged over "dp": each rank passes its own dp
shard of the batch. The schedule is `strategy.pipeline_configs`'
`schedule_mode` ("1F1B", "FThenB" for GPipe, or "VPP", the interleaved
schedule over a layer built with v chunks); `accumulate_steps` is the
number of microbatches M (the batch is cut into M contiguous slices) and
`micro_batch_size` is read as in the reference.

The wrapped layers are a `PipelineLayer` (Paddle's way: its loss is the
layer's `loss_fn`, its chunks its stage's entries, and the shapes between
stages are announced once a call) or a model with the pipeline
decomposition (`pp_embed` / `pp_layers` / `pp_head`: LLaMA and GPT built
under a "pp" mesh hold their stage), whose loss is its `compute_loss` and
whose activations are [rows, sequence, hidden] in its parameters' dtype.
At construction every parameter is broadcast over "dp" (`DataParallel`)
and, at tp > 1, every one that is not `is_distributed` over "tp" (as
`TensorParallel` does); shared weights from their first stage.
`forward_backward_pipeline`, which the reference leaves raising, runs the
schedule without the update.
"""
from __future__ import annotations

import torch

from ... import collective as _c
from ... import mesh as _mesh
from ... import pipeline as _pipe
from ...parallel import DataParallel
from ..layers.mpu.mp_layers import is_distributed
from .pp_layers import PipelineLayer

_MODES = {"1F1B": "1f1b", "FThenB": "gpipe", "VPP": "vpp",
          "1f1b": "1f1b", "gpipe": "gpipe", "vpp": "vpp"}


def model_stage(model, criterion=None):
    """The `pipeline.Stage` this rank runs for `model`: a `PipelineLayer`
    or a model with `pp_embed` / `pp_layers` / `pp_head` (its `pp` layout
    gives the chunks). `criterion(logits, labels)` defaults to the
    layer's `_loss_fn` / the model's `compute_loss`."""
    params = list(model.parameters())
    if isinstance(model, PipelineLayer):
        loss_fn = criterion or model._loss_fn
        return _pipe.Stage(model.chunk_fns(), embed=lambda x: x,
                           head_loss=lambda y, t: loss_fn(y, t),
                           params=params)
    if not hasattr(model, "pp_layers"):
        raise TypeError(
            f"a pipeline needs a PipelineLayer or a model with pp_embed / "
            f"pp_layers / pp_head, not {type(model).__name__}")
    layout = model.pp
    layers = model.pp_layers()
    if any(True for layer in layers for _ in layer.buffers()):
        raise NotImplementedError(
            "pipeline stages whose layers carry buffers (BatchNorm "
            "statistics) are not carried through the schedules yet (ROADMAP "
            "Queue 1 item 8 A)")
    crit = criterion or model.compute_loss
    cfg = model.config
    seq_div = model.tp_degree if getattr(cfg, "sequence_parallel", False) \
        and model.tp_degree > 1 else 1
    dtype = next(layers[0].parameters()).dtype

    def chunk(ls):
        def run(h):
            for layer in ls:
                h = layer(h)
            return h
        return run

    def act(ids):
        return (ids.shape[0], ids.shape[1] // seq_div, cfg.hidden_size), dtype

    return _pipe.Stage(
        [chunk(c) for c in _pipe.chunk_layers(layers, layout.virtual)],
        embed=model.pp_embed,
        head_loss=lambda y, t: crit(model.pp_head(y), t), act=act,
        params=params)


def check_layout(model, schedule, virtual):
    """Raise where `model`'s layout does not fit `schedule` at `virtual`
    chunks."""
    held = getattr(getattr(model, "pp", None), "virtual", None)
    if held is None and isinstance(model, PipelineLayer):
        held = model._num_virtual if model._split else 1
    want = virtual if schedule == "vpp" else 1
    if held is not None and held != want:
        raise ValueError(
            f"pipeline schedule {schedule!r} at virtual_pp_degree {want}, "
            f"but the model was built with {held} chunks a rank (set "
            f"config.virtual_pp_degree = {want} before building it)")


class PipelineParallel(DataParallel):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers)
        self._hcg = hcg
        self._strategy = strategy
        cfg = (strategy.pipeline_configs if strategy is not None else {})
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.micro_batch_size = int(cfg.get("micro_batch_size", 1))
        mode = cfg.get("schedule_mode", "1F1B")
        if mode not in _MODES:
            raise ValueError(f"pipeline_configs schedule_mode {mode!r}: use "
                             "'1F1B', 'FThenB' or 'VPP'")
        self._schedule = _MODES[mode]
        if _mesh.axis_size("tp") > 1:
            self._broadcast_state("tp", skip=is_distributed)
        self._link = None
        if _pipe.pp_size() > 1:
            from .pp_utils.p2p_communication import link_for

            self._link = link_for()
            _pipe.broadcast_shared_weights(list(layers.parameters()),
                                           self._link)
        virtual = getattr(getattr(layers, "pp", None), "virtual", None) or \
            getattr(layers, "_num_virtual", 1)
        check_layout(layers, self._schedule, virtual)
        self._stage = model_stage(layers)

    def _split_micro(self, data):
        if isinstance(data, (tuple, list)):
            parts = [self._split_micro(d) for d in data]
            return list(zip(*parts))
        n = self.accumulate_steps
        b = data.shape[0]
        mb = b // n
        return [data[i * mb: (i + 1) * mb] for i in range(n)]

    def _device(self):
        return next(self._layers.parameters()).device

    def forward_backward_pipeline(self, data, scaler=None):
        """The schedule over `data` = (inputs, labels) cut into
        `accumulate_steps` microbatches: the gradients (scaled by
        `scaler`'s scale) in the stage's parameters, each shared weight's
        summed over its stages (under ZeRO, a `DygraphShardingOptimizer`'s
        engine over the stage's parameters: the rank's gradient slices,
        reduced once a bucket); returns the loss (the mean of the
        microbatch losses, every rank of the "pp" group)."""
        inputs, labels = data
        xs, ys = self._split_micro(inputs), self._split_micro(labels)
        scale = scaler.get_loss_scaling() if scaler is not None and \
            scaler.is_enable() else 1.0
        loss = _pipe.run_schedule(self._stage, self._link, xs, ys,
                                  self._schedule, device=self._device(),
                                  loss_scale=scale)
        _pipe.reduce_gradients(list(self._layers.parameters()), self._link)
        return loss

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None,
                    loss_fn_idx=0):
        """data: (inputs, labels); loss = mean over microbatch losses
        (and over "dp"), one update of the stage's parameters."""
        from .hybrid_optimizer import HybridParallelOptimizer
        from .sharding.sharding_optimizer import DygraphShardingOptimizer

        loss = self.forward_backward_pipeline(data, scaler)
        # Paddle's HybridParallelOptimizer averages over "dp" in hybrid
        # mode, a DygraphShardingOptimizer over its axes; a plain optimizer
        # gets the model's own average
        if not isinstance(optimizer, (HybridParallelOptimizer,
                                      DygraphShardingOptimizer)):
            self.sync_gradients()
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return _data_mean(loss)

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """The forward over the microbatches: the mean loss (every rank),
        or with `compute_loss=False` the last stage's outputs (joined over
        the microbatches; None on the other stages)."""
        inputs, labels = data
        xs, ys = self._split_micro(inputs), self._split_micro(labels)
        outs = _pipe.run_forward(self._stage, self._link, xs, ys,
                                 compute_loss, device=self._device())
        return _data_mean(outs) if compute_loss else outs


def _data_mean(loss):
    for ax in ("dp", "sharding"):
        _c.all_reduce(loss, op=_c.ReduceOp.AVG, group=ax)
    return loss
