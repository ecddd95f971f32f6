"""`TensorParallel` (counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py`), the
wrapper `fleet.distributed_model` returns at tensor-parallel degree > 1.

The layers hold their own shards and collectives (`layers/mpu`); the
wrapper makes the replicated state agree: at construction every parameter
that is not `is_distributed`, and every buffer, is broadcast from the
"tp" axis's first rank (and, with dp > 1, everything from the "dp" axis's
first rank, as `DataParallel` does). `sync_gradients` averages gradients
over "dp" as `DataParallel`'s does.
"""
from __future__ import annotations

from ... import mesh as _mesh
from ...parallel import DataParallel
from ..layers.mpu.mp_layers import is_distributed


class TensorParallel(DataParallel):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers)
        self._hcg = hcg
        self._strategy = strategy
        if _mesh.axis_size("tp") > 1:
            self._broadcast_state("tp", skip=is_distributed)
