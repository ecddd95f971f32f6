"""Mixed precision (counterpart of `paddle_tpu/amp/__init__.py`):
`auto_cast` (the reference's op lists, `framework.amp_state`), `decorate`
(O2: parameters cast in place), `GradScaler`, the dtype-support queries
and `debugging` (the tensor checker, `check_numerics`, operator stats)."""
from __future__ import annotations

import contextlib

import torch

from ..framework import amp_state as _state
from ..framework.device import torch_dtype
from . import debugging
from .grad_scaler import GradScaler


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """While on, each ported functional on the white list takes its float32
    inputs in `dtype` and each on the black list its float16 / bfloat16
    inputs in float32 (`framework.amp_state.cast_inputs`), the custom lists
    added to the reference's. `level` is recorded; the lists apply at
    every level, as in the reference. `use_promote` is unused."""
    prev = (_state.enabled, _state.amp_dtype, _state.level,
            _state.white_list, _state.black_list)
    _state.enabled = bool(enable)
    _state.amp_dtype = torch_dtype(dtype)
    _state.level = level
    if custom_white_list:
        _state.white_list = _state.white_list | set(custom_white_list)
    if custom_black_list:
        _state.black_list = _state.black_list | set(custom_black_list)
    try:
        yield
    finally:
        (_state.enabled, _state.amp_dtype, _state.level,
         _state.white_list, _state.black_list) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every floating parameter of the model(s) to `dtype` in
    place; other levels leave them as they are. Returns the model(s), or
    (models, optimizers) when optimizers are given. An optimizer built with
    multi_precision takes its f32 master copy at its first step, after the
    cast. `master_weight` and `save_dtype` are accepted and unused, as in
    the reference."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        dt = torch_dtype(dtype)
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(dt)
    out = models if single else model_list
    return out if optimizers is None else (out, optimizers)


def is_float16_supported(device=None):
    return True


def is_bfloat16_supported(device=None):
    return True


__all__ = ["GradScaler", "amp_guard", "auto_cast", "debugging", "decorate",
           "is_bfloat16_supported", "is_float16_supported"]
