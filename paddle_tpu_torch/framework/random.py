"""The global random stream (counterpart of
`paddle_tpu/framework/random.py`: `seed`, `get_seed`, `next_key`,
`get_rng_state` / `set_rng_state`, and the tensor-parallel RNG tracker).

One explicit host `torch.Generator`, seeded by `seed(s)`, feeds every
random draw of the port that is not given its own generator:

- `next_seed()` draws the int32 seed of one attention-dropout call (the
  counterpart of the `jax.random.randint` draw the reference's attention
  makes from `next_key()`); it is a host int, so handing it to a kernel
  never waits on the device.
- `generator(device)` returns a fresh generator on `device` seeded by one
  such draw (`F.dropout`'s masks, the bernoulli mask of the reference
  attention path, the incubate layers' initial weights).

Inside `RNGStatesTracker.rng_state(name)` the draws come from that named
stream instead (another host generator), as the reference pushes a named
key stream: tensor-parallel ranks draw their dropout masks from
"local_seed" (a seed per rank) and the rest from "global_seed" (the same
seed on every rank), as `model_parallel_random_seed` sets them up.

The stream is PyTorch's, not JAX's: the same seed gives other numbers than
the reference's key stream.
"""
from __future__ import annotations

import contextlib

import torch

_DEFAULT_SEED = 0
_INT32_MAX = 2 ** 31 - 1

_generator = torch.Generator().manual_seed(_DEFAULT_SEED)
_seed = _DEFAULT_SEED
# the named streams pushed by RNGStatesTracker.rng_state, innermost last
_stack: list = []


def _current() -> torch.Generator:
    return _stack[-1] if _stack else _generator


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
    """The next int32 seed in [0, 2^31 - 1) of the current stream."""
    return int(torch.randint(0, _INT32_MAX, (), generator=_current()))


def generator(device) -> torch.Generator:
    """A new generator on `device` seeded from the current stream."""
    g = torch.Generator(device=device)
    g.manual_seed(next_seed())
    return g


def get_rng_state():
    """The current stream's state, as a one-item list (the reference's
    shape)."""
    return [_current().get_state()]


def set_rng_state(state):
    _current().set_state(state[0])


class RNGStatesTracker:
    """Named random streams for tensor-parallel dropout (the reference's
    `RNGStatesTracker`, Paddle's `fleet/layers/mpu/random.py`): each state
    is a host `torch.Generator`; `rng_state(name)` makes it the current
    stream for the draws inside the block."""

    def __init__(self):
        self.states_ = {}

    def reset(self):
        self.states_ = {}

    def add(self, name, seed_):
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.states_[name] = torch.Generator().manual_seed(int(seed_))

    def get_states_tracker(self):
        """{name: the stream's state} (copies)."""
        return {n: g.get_state() for n, g in self.states_.items()}

    def set_states_tracker(self, states):
        """Restore every stream from `get_states_tracker`'s states."""
        self.states_ = {}
        for n, s in states.items():
            g = torch.Generator()
            g.set_state(s)
            self.states_[n] = g

    @contextlib.contextmanager
    def rng_state(self, name="global_seed"):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        _stack.append(self.states_[name])
        try:
            yield
        finally:
            _stack.pop()


_MODEL_PARALLEL_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _MODEL_PARALLEL_TRACKER


def model_parallel_random_seed(seed_: int, tp_rank: int = 0):
    """The tracker's two streams for tensor-parallel rank `tp_rank`, as
    the reference seeds them: "global_seed" 100003 + seed on every rank,
    "local_seed" seed + 1024 + 100 * tp_rank."""
    global_seed = 100003 + seed_
    local_seed = seed_ + 1024 + tp_rank * 100
    tracker = get_rng_state_tracker()
    tracker.reset()
    tracker.add("global_seed", global_seed)
    tracker.add("local_seed", local_seed)
