"""DataLoader (counterpart of `paddle_tpu/io/dataloader.py`), in process.

- `num_workers == 0`: each batch is read and collated when the loop asks
  for it; `num_workers > 0`: one thread reads and collates ahead into a
  queue of 2 * num_workers batches, as the reference's default transport
  does.
- `default_collate_fn` stacks samples into CPU tensors, in pinned memory
  when a card is present (so a copy to the card can run asynchronously).
- `DevicePrefetcher` stages batches on the card ahead of their use, from a
  thread, on a side CUDA stream; the consumer's stream waits on the
  batch's event and the staged tensors are `record_stream`ed to it.

The reference's worker processes over shared memory (`multiprocess=True`,
`io/shm_queue.py` over a native ring) are not ported: that raises.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from ..framework import config as _config
from .dataset import IterableDataset
from .sampler import BatchSampler


def _pin(t):
    return t.pin_memory() if torch.cuda.is_available() else t


def _stack(batch):
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (bool, int, float, np.number)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: _stack([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return [_stack(list(group)) for group in zip(*batch)]
    return batch


def _pin_all(obj):
    if isinstance(obj, torch.Tensor):
        return _pin(obj)
    if isinstance(obj, dict):
        return {k: _pin_all(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_pin_all(v) for v in obj]
    return obj


def default_collate_fn(batch):
    """Samples -> one batch of the same structure: tensors, numpy arrays
    and numbers stacked along a new first axis into CPU tensors (pinned
    when CUDA is available), dicts and sequences field by field, strings
    kept as lists."""
    return _pin_all(_stack(batch))


class _StageError:
    """An exception raised in a reading or staging thread, re-raised on
    the consumer's stack."""

    def __init__(self, exc):
        self.exc = exc


class _Iter:
    def __init__(self, loader):
        self.loader = loader
        ds = loader.dataset
        self.iterable = isinstance(ds, IterableDataset)
        if self.iterable:
            self._it = iter(ds)
        else:
            self._batches = iter(loader.batch_sampler)
        self._prefetch_q = None
        if loader.num_workers > 0 and not self.iterable:
            self._prefetch_q = queue.Queue(
                maxsize=max(2, loader.num_workers * 2))
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._producer,
                                            daemon=True)
            self._thread.start()

    def _load_batch(self, indices):
        samples = [self.loader.dataset[i] for i in indices]
        return (self.loader.collate_fn or default_collate_fn)(samples)

    def _producer(self):
        try:
            for indices in self._batches:
                if self._stop.is_set():
                    return
                self._prefetch_q.put(self._load_batch(indices))
        except Exception as e:  # noqa: BLE001 - re-raised by __next__
            self._prefetch_q.put(_StageError(e))
        finally:
            self._prefetch_q.put(StopIteration)

    def __next__(self):
        if self.iterable:
            batch = []
            try:
                for _ in range(self.loader.batch_size or 1):
                    batch.append(next(self._it))
            except StopIteration:
                if not batch or self.loader.drop_last:
                    raise
            return (self.loader.collate_fn or default_collate_fn)(batch)
        if self._prefetch_q is not None:
            item = self._prefetch_q.get()
            if item is StopIteration:
                raise StopIteration
            if isinstance(item, _StageError):
                raise item.exc
            return item
        return self._load_batch(next(self._batches))

    def __iter__(self):
        return self

    def __del__(self):
        if self._prefetch_q is not None:
            self._stop.set()


_STAGE_END = object()


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


class DevicePrefetcher:
    """Stages the batches of `it` ahead of their use: a thread pulls the
    next batches and runs `place_fn` on each (a copy to the card), at most
    `depth` (default `FLAGS_prefetch_depth`) ahead; depth <= 0 places each
    batch when it is asked for, with no thread. With a CUDA `device`, the
    copies run on a side stream: each batch carries an event, the stream
    that takes the batch waits on it, and its tensors are
    `record_stream`ed to that stream. An exception in the thread is raised
    where the batch is asked for."""

    def __init__(self, it, place_fn, depth: Optional[int] = None,
                 device=None):
        self._it = iter(it)
        self._place = place_fn
        if depth is None:
            depth = int(_config.get_flag("FLAGS_prefetch_depth", 2))
        self.depth = int(depth)
        dev = torch.device(device) if device is not None else None
        self._device = dev if dev is not None and dev.type == "cuda" \
            else None
        self._stream = torch.cuda.Stream(self._device) \
            if self._device is not None and self.depth > 0 else None
        self._q = None
        if self.depth > 0:
            self._q = queue.Queue(maxsize=self.depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._producer, name="device-prefetch", daemon=True)
            self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _stage(self, batch):
        if self._stream is None:
            return self._place(batch), None
        with torch.cuda.device(self._device), torch.cuda.stream(
                self._stream):
            staged = self._place(batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def _producer(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                if not self._put(self._stage(batch)):
                    return
        except Exception as e:  # noqa: BLE001 - re-raised by __next__
            self._put(_StageError(e))
        finally:
            self._put(_STAGE_END)

    def __next__(self):
        if self._q is None:
            return self._place(next(self._it))
        item = self._q.get()
        if item is _STAGE_END:
            self._q.put(_STAGE_END)  # later calls end too
            raise StopIteration
        if isinstance(item, _StageError):
            raise item.exc
        staged, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in _tensors(staged):
                if t.is_cuda:
                    t.record_stream(stream)
        return staged

    def __iter__(self):
        return self

    def close(self):
        if self._q is None:
            return
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class DataLoader:
    """Batches of `dataset` through `batch_sampler` (or a `BatchSampler` of
    `batch_size`, `shuffle`, `drop_last`) and `collate_fn` (default
    `default_collate_fn`). `num_workers > 0` reads ahead in one thread.
    The reference's other arguments are accepted; `multiprocess=True`
    (worker processes over shared memory) is not ported and raises."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, multiprocess=False,
                 shm_capacity=64 << 20, mp_start_method=None):
        if multiprocess:
            raise NotImplementedError(
                "DataLoader(multiprocess=True): worker processes over "
                "shared memory are not ported; num_workers > 0 reads ahead "
                "in a thread")
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.use_shared_memory = use_shared_memory
        self.multiprocess = multiprocess
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size",
                                      batch_size)
        elif not isinstance(dataset, IterableDataset):
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        else:
            self.batch_sampler = None

    def __iter__(self):
        return _Iter(self)

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        raise TypeError("DataLoader over IterableDataset has no len()")

