"""DataLoader (counterpart of `paddle_tpu/io/dataloader.py`).

- `num_workers == 0`: each batch is read and collated when the loop asks
  for it; `num_workers > 0`: one thread reads and collates ahead into a
  queue of 2 * num_workers batches, as the reference's default transport
  does.
- `num_workers > 0, multiprocess=True` (with `use_shared_memory`, a
  batch sampler): worker processes, started by `mp_start_method`
  (default "forkserver", as the reference's: a trainer that holds CUDA or
  other threads must not fork), each reading every num_workers-th batch of
  the sampler and sending it pickled through a shared-memory ring of its
  own (`io/shm_queue.py` over `native/shm_ring.cc`). Workers collate into
  numpy arrays and never touch CUDA; the trainer turns the arrays into
  tensors (pinned when a card is present) and reads the rings in turn, so
  batches arrive in sampler order. A worker's exception re-raises in the
  trainer with its traceback; a worker that dies without finishing raises.
- `default_collate_fn` stacks samples into CPU tensors, in pinned memory
  when a card is present (so a copy to the card can run asynchronously).
- `DevicePrefetcher` stages batches on the card ahead of their use, from a
  thread, on a side CUDA stream; the consumer's stream waits on the
  batch's event and the staged tensors are `record_stream`ed to it.
"""
from __future__ import annotations

import pickle
import queue
import threading
import time
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


def numpy_collate_fn(batch):
    """`default_collate_fn`'s structure with numpy leaves: the worker
    processes' collate (the trainer makes the tensors)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.stack([s.numpy() for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (bool, int, float, np.number)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: numpy_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return [numpy_collate_fn(list(group)) for group in zip(*batch)]
    return batch


def _tensorize(obj):
    if isinstance(obj, np.ndarray) and obj.dtype != object:
        return _pin(torch.from_numpy(obj))
    if isinstance(obj, dict):
        return {k: _tensorize(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_tensorize(v) for v in obj]
    return obj


class WorkerInfo:
    """The identity of a DataLoader worker process (None in the trainer):
    id, num_workers, dataset."""

    def __init__(self, id, num_workers, dataset):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, "
                f"num_workers={self.num_workers})")


_worker_info = None


def get_worker_info():
    """Inside a worker process its `WorkerInfo`; in the trainer None."""
    return _worker_info


_END = "__pdtpu_worker_end__"
_ERR = "__pdtpu_worker_err__"


def _mp_worker_loop(dataset, batch_lists, ring_name, collate, init_fn,
                    worker_id, num_workers):
    """A worker process: reads its batches, ships each pickled through its
    ring, then the end mark; an exception ships its traceback."""
    global _worker_info
    from .shm_queue import ShmRing

    ring = ShmRing(ring_name, open_existing=True)
    try:
        _worker_info = WorkerInfo(worker_id, num_workers, dataset)
        if init_fn is not None:
            init_fn(worker_id)
        for indices in batch_lists:
            ring.put(collate([dataset[i] for i in indices]))
        ring.put(_END)
    except KeyboardInterrupt:  # the trainer's teardown
        pass
    except Exception:  # noqa: BLE001 - re-raised in the trainer
        import traceback

        try:
            ring.put((_ERR, worker_id, traceback.format_exc()), timeout=5)
        except Exception:  # noqa: BLE001 - the trainer sees the exit
            pass
    finally:
        ring.close()


class _MultiProcessIter:
    """Worker processes over shared-memory rings; batches in sampler
    order (batch i comes from worker i % num_workers)."""

    def __init__(self, loader):
        import multiprocessing as mp

        from .shm_queue import ShmRing, ring_name

        self.loader = loader
        W = loader.num_workers
        batches = list(loader.batch_sampler)
        per_worker = [batches[w::W] for w in range(W)]
        collate = loader.collate_fn or numpy_collate_fn
        self._wrap = loader.collate_fn is None
        cap = max(8 << 20, loader.shm_capacity)
        ctx = mp.get_context(loader.mp_start_method)
        if loader.mp_start_method == "forkserver":
            # the server imports the workers' module (and torch) once;
            # each worker forks from it (no effect once it runs)
            ctx.set_forkserver_preload([__name__])
        self.rings, self.procs = [], []
        try:
            for w in range(W):
                name = ring_name(f"pdtpu_dl{w}")
                self.rings.append(ShmRing(name, capacity=cap))
                p = ctx.Process(
                    target=_mp_worker_loop,
                    args=(loader.dataset, per_worker[w], name, collate,
                          loader.worker_init_fn, w, W),
                    daemon=True)
                p.start()
                self.procs.append(p)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            self.close()
            raise RuntimeError(
                "DataLoader worker start failed to pickle the dataset, "
                "collate_fn or worker_init_fn (the 'forkserver' and 'spawn' "
                "start methods send them by pickle): define them at module "
                "level, or pass mp_start_method='fork' in a process that "
                "holds no CUDA context or other threads") from e
        self._next = 0
        self._done = [False] * W

    def _get(self, w):
        """Worker w's next item; raises if the worker died without its end
        mark, or after the loader's `timeout` seconds (0: no limit)."""
        deadline = None if not self.loader.timeout else \
            time.monotonic() + self.loader.timeout
        while True:
            try:
                return self.rings[w].get(timeout=1.0)
            except TimeoutError:
                if not self.procs[w].is_alive():
                    code = self.procs[w].exitcode
                    self.close()
                    raise RuntimeError(
                        f"DataLoader worker {w} died (exit code {code}) "
                        "without finishing its batches") from None
                if deadline is not None and time.monotonic() > deadline:
                    self.close()
                    raise

    def __next__(self):
        while True:
            if all(self._done):
                raise StopIteration
            w = self._next % len(self.rings)
            if self._done[w]:
                self._next += 1
                continue
            item = self._get(w)
            if isinstance(item, str) and item == _END:
                self._done[w] = True
                self.procs[w].join()
                self._next += 1
                continue
            if isinstance(item, tuple) and len(item) == 3 and \
                    item[0] == _ERR:
                self.close()
                raise RuntimeError(
                    f"DataLoader worker {item[1]} raised:\n{item[2]}")
            self._next += 1
            return _tensorize(item) if self._wrap else item

    def __iter__(self):
        return self

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(timeout=2)
        for r in self.rings:
            r.close()
        self.procs, self.rings = [], []
        self._done = []

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


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
    `default_collate_fn`). `num_workers > 0` reads ahead in one thread, or,
    with `multiprocess=True`, in that many worker processes
    (`mp_start_method`, default "forkserver"; rings of `shm_capacity`
    bytes). The reference's other arguments are accepted."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, multiprocess=False,
                 shm_capacity=64 << 20, mp_start_method=None):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.use_shared_memory = use_shared_memory
        self.multiprocess = multiprocess
        self.shm_capacity = shm_capacity
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.mp_start_method = mp_start_method or "forkserver"
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
        if (self.multiprocess and self.num_workers > 0
                and self.use_shared_memory
                and self.batch_sampler is not None):
            return _MultiProcessIter(self)
        return _Iter(self)

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        raise TypeError("DataLoader over IterableDataset has no len()")
