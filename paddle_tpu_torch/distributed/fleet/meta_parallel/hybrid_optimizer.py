"""`HybridParallelOptimizer` and `HybridParallelClipGrad` (counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/hybrid_optimizer.py`), what
`fleet.distributed_optimizer` returns.

The clip's norm is the whole model's: each rank holds a shard of every
`is_distributed` parameter and a full copy of the others, so the squares
of the distributed gradients are summed over the "tp" axis and the
replicated ones are counted once (summing every square over "tp" would
count them tp times). Under ZeRO (`DygraphShardingOptimizer`, which sets
`_zero_axes`) each gradient is this rank's slice, so both sums are also
summed over the ZeRO axis, and every rank joins those all_reduces whether
or not it holds a slice. At pipeline degree > 1 each stage holds distinct
parameters, so both sums are also summed over "pp"; a weight shared by
stages (a tied embedding) is counted on its first stage only. The
reference sees global arrays and needs none of this.
Gradient merge (`strategy.gradient_merge`) is wired to
`build_train_step` through `_gradient_merge_k` / `_gradient_merge_avg`.
"""
from __future__ import annotations

import torch

from ....nn.clip import ClipGradByGlobalNorm
from ... import collective as _collective
from ... import mesh as _mesh
from ...parallel import average_gradients
from ..layers.mpu.mp_layers import is_distributed


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """`ClipGradByGlobalNorm` over the whole tensor-parallel model."""

    # the axes the gradients are sliced over (ZeRO); () for whole ones
    _zero_axes = ()

    def __init__(self, clip, hcg=None):
        super().__init__(getattr(clip, "clip_norm", clip))
        self._hcg = hcg

    def hybrid_global_norm(self, params_grads):
        """The global norm (an f32 device scalar) of the (parameter,
        gradient) pairs over the model's every shard, or None without
        gradients."""
        from ...pipeline import is_shared_copy

        dist_sq, rep_sq = [], []
        for p, g in params_grads:
            if g is not None and not is_shared_copy(p):
                sq = torch.linalg.vector_norm(g, dtype=torch.float32).square()
                (dist_sq if self._sharded(p) else rep_sq).append(sq)
        axes = tuple(self._zero_axes) + (
            ("pp",) if _mesh.axis_size("pp") > 1 else ())
        if axes:
            return self._sliced_norm(rep_sq, dist_sq, axes)
        if not dist_sq and not rep_sq:
            return None
        total = torch.stack(rep_sq).sum() if rep_sq else None
        if dist_sq:
            d = torch.stack(dist_sq).sum()
            if _mesh.axis_size("tp") > 1:
                d = _collective.all_reduce(d.reshape(1), group="tp")[0]
            total = d if total is None else total + d
        return total.sqrt()

    def _sliced_norm(self, rep_sq, dist_sq, axes):
        """The global norm from this rank's squares (of its slices, its
        stage): summed over `axes` (the ZeRO axes, "pp"), the distributed
        ones also over "tp"."""
        from ... import env as _env

        dev = (rep_sq or dist_sq)[0].device if rep_sq or dist_sq \
            else (_env.device() or torch.device("cpu"))
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        both = torch.stack([torch.stack(rep_sq).sum() if rep_sq else zero,
                            torch.stack(dist_sq).sum() if dist_sq else zero])
        for ax in axes:
            _collective.all_reduce(both, group=ax)
        if _mesh.axis_size("tp") > 1:
            both[1:] = _collective.all_reduce(both[1:].clone(), group="tp")
        return both.sum().sqrt()

    @staticmethod
    def _sharded(p):
        """Whether `p` is a shard whose squares are summed over "tp"."""
        return is_distributed(p)

    _params_norm = hybrid_global_norm


class HybridParallelOptimizer:
    """Wraps `optimizer`: a `ClipGradByGlobalNorm` becomes
    `HybridParallelClipGrad`; in hybrid mode (tp > 1 or pp > 1), where the
    model is a `TensorParallel` or `PipelineParallel`, `step` averages the
    gradients over "dp" before the inner step, as Paddle's does (an eager
    loop calls `step` alone); in data-parallel mode the `DataParallel`
    model's `sync_gradients` averages them and `step` does not again. At
    pp > 1 the inner optimizer holds the rank's stage parameters. Every
    other attribute is the inner optimizer's."""

    _OWN = ("_inner_opt", "_hcg", "_strategy", "_gradient_merge_k",
            "_gradient_merge_avg")

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._gradient_merge_k = 1
        self._gradient_merge_avg = True
        if strategy is not None and getattr(strategy, "gradient_merge",
                                            False):
            cfg = getattr(strategy, "gradient_merge_configs", {})
            self._gradient_merge_k = int(cfg.get("k_steps", 1))
            self._gradient_merge_avg = bool(cfg.get("avg", True))
        if isinstance(optimizer._grad_clip, ClipGradByGlobalNorm):
            optimizer._grad_clip = HybridParallelClipGrad(
                optimizer._grad_clip, hcg)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def __setattr__(self, item, value):
        if item in self._OWN:
            object.__setattr__(self, item, value)
        else:
            setattr(self._inner_opt, item, value)

    @torch.no_grad()
    def step(self):
        # Paddle's `_dp_enable`: in hybrid mode (tp > 1 or pp > 1) the
        # optimizer averages over "dp"; in data-parallel mode the model's
        # `sync_gradients` (DataParallel) has done it
        if _mesh.axis_size("tp") > 1 or _mesh.axis_size("pp") > 1:
            average_gradients(self._inner_opt._parameter_list or [])
        self._inner_opt.step()

    def minimize(self, loss, **kwargs):
        loss.backward()
        self.step()
        self._inner_opt.clear_grad()
