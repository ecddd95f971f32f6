"""Numeric-stability tooling (counterpart of `paddle_tpu/amp/debugging.py`):
the tensor checker, `check_numerics` and the operator stats.

The reference guards each op inside its dispatcher (`tensor._apply_op`)
while `FLAGS_check_nan_inf` is on, and counts each op while
`FLAGS_benchmark` is on. The port has no dispatcher of its own, so it uses
PyTorch's: a `TorchDispatchMode` that sees every ATen op (forward and
backward) is pushed on the calling thread while either flag is on
(`set_flags`, the `enable_*` functions, or the environment at import) and
popped when both are off. The checker names the op as ATen does
(`aten.mul.Tensor`); ops that return uninitialised memory (`empty` and its
kin, which the CUDA kernels' wrappers allocate outputs with) are not
checked. The hand-written kernels launch through ctypes, not ATen: a NaN a
kernel writes is named at the first ATen op that reads it. A check reads
the device (one synchronisation an op): a debugging mode.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..framework import config as _config
from ..framework import op_stats

_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "resize_", "empty_permuted"}


class _DebugMode(TorchDispatchMode):
    """Checks each op's floating outputs for NaN/Inf while
    FLAGS_check_nan_inf is on; counts each op while FLAGS_benchmark is
    on."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if _config.get_flag("FLAGS_benchmark"):
            op_stats.record(name)
        if _config.get_flag("FLAGS_check_nan_inf") and \
                func.overloadpacket.__name__ not in _UNINITIALISED:
            for i, o in enumerate(tree_leaves(out)):
                if isinstance(o, torch.Tensor) and (
                        o.is_floating_point() or o.is_complex()) and \
                        not bool(torch.isfinite(o).all()):
                    raise RuntimeError(
                        f"NaN/Inf detected in output {i} of op '{name}' "
                        f"(shape {tuple(o.shape)}, dtype {o.dtype}); set "
                        f"FLAGS_check_nan_inf=0 to disable this check")
        return out


_mode = None


def _sync_mode(_value=None):
    """Push the mode when either flag is on, pop it when both are off."""
    global _mode
    on = bool(_config.get_flag("FLAGS_check_nan_inf")) or \
        bool(_config.get_flag("FLAGS_benchmark"))
    if on and _mode is None:
        _mode = _DebugMode()
        _mode.__enter__()
    elif not on and _mode is not None:
        mode, _mode = _mode, None
        mode.__exit__(None, None, None)


_config.watch_flag("FLAGS_check_nan_inf", _sync_mode)
_config.watch_flag("FLAGS_benchmark", _sync_mode)
_sync_mode()


def enable_tensor_checker(checker_config=None):
    """Turn on the per-op NaN/Inf guard (every op's floating outputs
    checked; a failure names the op). A `TensorCheckerConfig` with
    `enable=False` leaves it off, as in the reference."""
    if checker_config is not None and not getattr(
            checker_config, "enable", True):
        return
    _config.set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    _config.set_flags({"FLAGS_check_nan_inf": False})


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """Raise FloatingPointError (with the counts, `op_type`, `var_name`
    and the shape) if `tensor` holds a NaN or an Inf; else return it."""
    t = tensor.detach()
    n_nan = int(torch.isnan(t).sum())
    n_inf = int(torch.isinf(t).sum())
    if n_nan or n_inf:
        raise FloatingPointError(
            f"check_numerics: {n_nan} NaN / {n_inf} Inf in "
            f"{op_type or 'tensor'} {var_name} (shape {list(t.shape)})")
    return tensor


class TensorCheckerConfig:
    """Accepted as the reference's; only `enable` is read (per-op
    attribution is always on while the checker is)."""

    def __init__(self, enable=True, debug_mode=None, output_dir=None,
                 checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=None):
        self.enable = enable


def enable_operator_stats_collection():
    """Start counting the ops dispatched (from zero) until disabled."""
    op_stats.reset()
    _config.set_flags({"FLAGS_benchmark": True})


def disable_operator_stats_collection(print_summary=True):
    """Stop counting; return {op name: count} and print the table, as the
    reference does."""
    _config.set_flags({"FLAGS_benchmark": False})
    stats = op_stats.snapshot()
    if print_summary and stats:
        width = max(len(k) for k in stats)
        print("operator stats (eager dispatches):")
        for name, n in sorted(stats.items(), key=lambda kv: -kv[1]):
            print(f"  {name:<{width}}  {n}")
    return stats
