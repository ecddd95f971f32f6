"""`DistributedStrategy` (counterpart of
`paddle_tpu/distributed/fleet/base/distributed_strategy.py`): a plain
config object with Paddle's toggle names. `fleet.init` reads
`hybrid_configs`; `fleet.distributed_optimizer` reads `gradient_merge` and
`gradient_merge_configs`. The toggles the port does not implement read
False, and setting one truthy raises, so a ported Fleet config learns of
an absent feature at configure time, not from a different training run."""
from __future__ import annotations

from typing import Any, Dict


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs: Dict[str, Any] = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs: Dict[str, Any] = {
            "init_loss_scaling": 65536.0,
            "use_pure_fp16": False,
            "use_bf16": True,
        }
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs: Dict[str, Any] = {
            "sharding_degree": 1,
            "stage": 1,
        }
        self.pipeline = False
        self.pipeline_configs: Dict[str, Any] = {
            "accumulate_steps": 1,
            "micro_batch_size": 1,
            "schedule_mode": "1F1B",
        }
        self.tensor_parallel = False
        self.tensor_parallel_configs: Dict[str, Any] = {
            "tensor_parallel_degree": 1,
        }
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.gradient_scale_configs = {"scale_strategy": "avg"}

    def _reject_toggle(self, name, value, why):
        if value:
            raise NotImplementedError(
                f"DistributedStrategy.{name} is not implemented in "
                f"paddle_tpu_torch: {why}")

    @property
    def dgc(self):
        return False

    @dgc.setter
    def dgc(self, value):
        self._reject_toggle(
            "dgc", value,
            "deep gradient compression is not ported; gradients go over "
            "dense all_reduces")

    @property
    def localsgd(self):
        return False

    @localsgd.setter
    def localsgd(self, value):
        self._reject_toggle(
            "localsgd", value,
            "periodic model averaging is unimplemented; use plain dp "
            "(an all_reduce a step) or gradient_merge for a larger "
            "effective batch")

    @property
    def find_unused_parameters(self):
        return False

    @find_unused_parameters.setter
    def find_unused_parameters(self, value):
        self._reject_toggle(
            "find_unused_parameters", value,
            "the train step gives every parameter a gradient (zero where "
            "unused), so there is no graph to walk for unused ones")

    @property
    def asp(self):
        return False

    @asp.setter
    def asp(self, value):
        self._reject_toggle(
            "asp", value,
            "2:4 automatic sparsity is not ported: no kernel on the "
            "port's path multiplies by a structured-sparse weight")

    @property
    def fp16_allreduce(self):
        return False

    @fp16_allreduce.setter
    def fp16_allreduce(self, value):
        self._reject_toggle(
            "fp16_allreduce", value,
            "gradients are reduced in their own dtype (bf16 under amp "
            "O2); there is no f32 wire format to compress")

    def __repr__(self):
        keys = ("hybrid_configs", "amp", "recompute", "sharding", "pipeline")
        return "DistributedStrategy(" + ", ".join(
            f"{k}={getattr(self, k)}" for k in keys) + ")"
