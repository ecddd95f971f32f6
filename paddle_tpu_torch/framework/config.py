"""The flags registry (counterpart of `paddle_tpu/framework/config.py`).

One typed in-process registry of `FLAGS_*` values, seeded from the
environment variables of the same names at import and set at run time with
`set_flags`. Only the flags that the port reads are defined here, with the
JAX package's defaults.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

_lock = threading.Lock()


class _Flag:
    __slots__ = ("name", "default", "value", "type", "help")

    def __init__(self, name, default, type_, help_):
        self.name = name
        self.default = default
        self.type = type_
        self.help = help_
        env = os.environ.get(name)
        self.value = default if env is None else _parse(env, type_)


def _parse(text: str, type_):
    if type_ is bool:
        return text.lower() in ("1", "true", "yes", "on")
    return type_(text)


_FLAGS: Dict[str, _Flag] = {}


def define_flag(name: str, default: Any, help_: str = "", type_=None):
    with _lock:
        if name in _FLAGS:
            return _FLAGS[name]
        f = _Flag(name, default, type_ or type(default), help_)
        _FLAGS[name] = f
        return f


def get_flags(names):
    """{name: value} for the named flags that are defined."""
    if isinstance(names, str):
        names = [names]
    return {n: _FLAGS[n].value for n in names if n in _FLAGS}


def set_flags(flags: Dict[str, Any]):
    """Set flags by name; a string is parsed to the flag's type. An unknown
    name defines a new flag with that value."""
    for k, v in flags.items():
        if k not in _FLAGS:
            define_flag(k, v)
        else:
            _FLAGS[k].value = _parse(v, _FLAGS[k].type) \
                if isinstance(v, str) else v


def get_flag(name: str, default=None):
    f = _FLAGS.get(name)
    return f.value if f is not None else default


define_flag("FLAGS_paged_grouped_kernel", False,
            "Route float decode attention over 16-token pages (tables a "
            "multiple of 8 pages wide, head_dim 128) to the grouped-fetch "
            "kernel, which stages 8 pages (128 tokens) at a time in shared "
            "memory, instead of the per-page kernel.")
define_flag("FLAGS_autotune", "off",
            "Measured dispatch (kernels/autotune.py): 'off' (default) keeps "
            "the fixed dispatch; 'on' times the candidates of a shape "
            "bucket on the card at its first call and keeps the winner in "
            "a table on disk; 'readonly' uses the table's winners and never "
            "times anything.")
define_flag("FLAGS_autotune_cache_dir", "",
            "Directory of the tuner's tables (empty: "
            "~/.cache/paddle_tpu_torch).")
define_flag("FLAGS_flash_dropout_kernel", False,
            "Route training SDPA with dropout_p > 0 (no mask, a shape "
            "kernels.flash_attention.supports takes) to the flash dropout "
            "bodies, which drop the softmax weights in the kernels with the "
            "threefry mask and a fresh seed per call. Off (the default): "
            "dropout attention takes the dense reference path with a "
            "bernoulli mask.")
define_flag("FLAGS_prefetch_depth", 2,
            "Batches `models.trainer.prefetch_batches` (and a "
            "DevicePrefetcher given no depth) stages on the card ahead of "
            "the step that uses them; <= 0 stages nothing ahead.")
define_flag("FLAGS_scheduler_policy", "fifo",
            "SchedulerPolicy the serving engine resolves at construction "
            "(inference/scheduler.py registry): 'fifo' (default: head-of-"
            "line admission, youngest-victim recompute preemption, pow2 / "
            "page-multiple prefill buckets, {1, decode_burst} bursts) or "
            "'slo' (TTFT-burn-aware; needs an injected firing_fn in the "
            "port, so resolving it by name raises). An explicit scheduler= "
            "argument to ServingEngine wins over the flag.")
