"""Activation recompute (counterpart of
`paddle_tpu/distributed/fleet/utils/recompute.py`, which wraps
`jax.checkpoint`): `recompute` runs a function under
`torch.utils.checkpoint` (non-reentrant), which keeps none of its
activations and runs it again in the backward.

The port's dropout draws its seeds from its own host generator
(`framework.random`), which `torch.utils.checkpoint`'s
`preserve_rng_state` does not save (it saves torch's default generators).
So `recompute` saves that stream's state before the forward and sets it
again around the replay: the replay draws the first run's dropout masks,
and the stream after the backward is where the forward left it.
"""
from __future__ import annotations

import torch.utils.checkpoint as _ckpt

from ....framework import random as _random


def recompute(function, *args, **kwargs):
    """function(*args, **kwargs), its activations recomputed in the
    backward. `preserve_rng_state` (default True) also keeps torch's own
    generators for the replay; `use_reentrant` is accepted, and the port
    always takes the non-reentrant form."""
    preserve_rng_state = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    state = _random.get_rng_state()
    calls = []

    def run(*a, **k):
        if not calls:  # the forward
            calls.append(1)
            return function(*a, **k)
        after = _random.get_rng_state()
        _random.set_rng_state(state)
        try:
            return function(*a, **k)
        finally:
            _random.set_rng_state(after)

    return _ckpt.checkpoint(run, *args, use_reentrant=False,
                            preserve_rng_state=preserve_rng_state, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Split the layers `functions` into `ctx["segments"]` (default 1)
    consecutive segments of len // segments layers each and run each
    segment under `recompute`."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    per = max(len(layers) // max(segments, 1), 1)
    x = args[0] if len(args) == 1 else args

    def segment(seg):
        def run(inp):
            for layer in seg:
                inp = layer(inp)
            return inp
        return run

    for i in range(0, len(layers), per):
        x = recompute(segment(layers[i:i + per]), x, **kwargs)
    return x
