"""The tensor-parallel RNG tracker (counterpart of
`paddle_tpu/distributed/fleet/layers/mpu/random.py`); the tracker lives in
`framework.random`."""
from .....framework import random as _random
from .....framework.random import (  # noqa: F401
    RNGStatesTracker,
    get_rng_state_tracker,
    model_parallel_random_seed,
)
from .....nn import functional as F


def determinate_seed(rng_name):
    """The global seed (`paddle_tpu_torch.seed`), as the reference's."""
    return _random.get_seed()


def dropout(x, p=0.5, axis=None, rng_name="local_seed", training=True,
            mode="upscale_in_train", name=None):
    """`F.dropout` drawing its mask from the tracker's `rng_name` stream
    (a seed per tensor-parallel rank for "local_seed"), or from the global
    stream when the tracker has no such state."""
    tracker = get_rng_state_tracker()
    if rng_name in tracker.states_:
        with tracker.rng_state(rng_name):
            return F.dropout(x, p=p, axis=axis, training=training, mode=mode)
    return F.dropout(x, p=p, axis=axis, training=training, mode=mode)
