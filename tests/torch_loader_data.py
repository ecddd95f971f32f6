"""Datasets of the port's DataLoader worker tests (`tests/test_torch_io.py`),
in a module of their own: the "forkserver" and "spawn" start methods send
a worker its dataset by pickle, and the worker imports the module that
defines it (torch and numpy only, not the test file's JAX)."""
import numpy as np


class Pairs:
    """40 samples: (a float32 row filled with i, i)."""

    def __len__(self):
        return 40

    def __getitem__(self, i):
        return np.full((3,), i, np.float32), i


class Poison:
    """Raises at sample 7."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        if i == 7:
            raise ValueError("poison sample")
        return np.zeros((2,), np.float32)


class WhoReads:
    """Each sample says which worker read it (`get_worker_info`)."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        from paddle_tpu_torch.io import get_worker_info

        info = get_worker_info()
        return {"i": i, "worker": -1 if info is None else info.id,
                "n": 0 if info is None else info.num_workers}


class Dies:
    """The worker process exits at sample 3 without a word."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 3:
            import os

            os._exit(3)
        return np.zeros((1,), np.float32)


def sum_collate(samples):
    return float(sum(s[1] for s in samples))
