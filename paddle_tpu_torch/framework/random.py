"""The global random stream (counterpart of
`paddle_tpu/framework/random.py`: `seed`, `get_seed`, `next_key`,
`get_rng_state` / `set_rng_state`).

One explicit host `torch.Generator`, seeded by `seed(s)`, feeds every
random draw of the port that is not given its own generator:

- `next_seed()` draws the int32 seed of one attention-dropout call (the
  counterpart of the `jax.random.randint` draw the reference's attention
  makes from `next_key()`); it is a host int, so handing it to a kernel
  never waits on the device.
- `generator(device)` returns a fresh generator on `device` seeded by one
  such draw (`F.dropout`'s masks, the bernoulli mask of the reference
  attention path, the incubate layers' initial weights).

The stream is PyTorch's, not JAX's: the same seed gives other numbers than
the reference's key stream.
"""
from __future__ import annotations

import torch

_DEFAULT_SEED = 0
_INT32_MAX = 2 ** 31 - 1

_generator = torch.Generator().manual_seed(_DEFAULT_SEED)
_seed = _DEFAULT_SEED


def seed(s: int) -> torch.Generator:
    """`paddle.seed`: restart the global stream from `s`; returns its host
    generator."""
    global _seed
    _seed = int(s)
    _generator.manual_seed(_seed)
    return _generator


def get_seed() -> int:
    return _seed


def next_seed() -> int:
    """The next int32 seed in [0, 2^31 - 1) of the global stream."""
    return int(torch.randint(0, _INT32_MAX, (), generator=_generator))


def generator(device) -> torch.Generator:
    """A new generator on `device` seeded from the global stream."""
    g = torch.Generator(device=device)
    g.manual_seed(next_seed())
    return g


def get_rng_state():
    """The global stream's state, as a one-item list (the reference's
    shape)."""
    return [_generator.get_state()]


def set_rng_state(state):
    _generator.set_state(state[0])
