"""Mixed precision (counterpart of `paddle_tpu/amp/__init__.py`): `decorate`
at level O2. GradScaler and the O1 autocast lists are not ported."""
from __future__ import annotations

import torch

from ..framework.device import torch_dtype


def decorate(models, level="O2", dtype="bfloat16"):
    """O2: cast every floating parameter of the model(s) to `dtype` in
    place and return the model(s). An optimizer built with multi_precision
    takes its f32 master copy at its first step, after the cast."""
    if level != "O2":
        raise NotImplementedError(f"amp level {level!r} is not ported")
    dt = torch_dtype(dtype)
    model_list = list(models) if isinstance(models, (list, tuple)) \
        else [models]
    with torch.no_grad():
        for m in model_list:
            for p in m.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dt)
    return models
