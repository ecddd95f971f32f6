"""Counterpart of `paddle_tpu/io`: datasets, samplers and the DataLoader
(read-ahead thread or worker processes over shared memory) with its device
prefetcher."""
from .dataloader import (DataLoader, DevicePrefetcher, WorkerInfo,
                         default_collate_fn, get_worker_info)
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset",
           "ConcatDataset", "DataLoader", "Dataset", "DevicePrefetcher",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "Sampler", "SequenceSampler", "Subset", "SubsetRandomSampler",
           "TensorDataset", "WeightedRandomSampler", "WorkerInfo",
           "default_collate_fn", "get_worker_info", "random_split"]
