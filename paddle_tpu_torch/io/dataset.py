"""Datasets (counterpart of `paddle_tpu/io/dataset.py`, the port's own copy
of it). `random_split` draws its permutation from the port's global stream
(`paddle_tpu_torch.seed`), so the same seed splits otherwise than the
reference's `jax.random` key does."""
from __future__ import annotations

import bisect

import numpy as np


class Dataset:
    def __getitem__(self, idx):  # pragma: no cover - abstract
        raise NotImplementedError

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lens = {len(t) for t in tensors}
        if len(lens) != 1:
            raise ValueError("all tensors must have the same first dim")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cum, idx)
        prev = 0 if ds_idx == 0 else self.cum[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    import torch

    from ..framework import random as _random

    if sum(lengths) != len(dataset):
        # fraction support
        if all(0 < l < 1 for l in lengths):
            n = len(dataset)
            lengths = [int(np.floor(n * l)) for l in lengths]
            lengths[0] += n - sum(lengths)
        else:
            raise ValueError("sum of lengths != dataset size")
    perm = torch.randperm(len(dataset),
                          generator=generator or _random.generator("cpu"))
    perm = perm.numpy()
    out = []
    offset = 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset: offset + l].tolist()))
        offset += l
    return out
