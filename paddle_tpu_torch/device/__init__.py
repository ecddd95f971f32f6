"""paddle.device (counterpart of `paddle_tpu/device/__init__.py`): the
places and queries of `framework.device`, and CUDA streams and events.

Where the reference's streams and events are no-ops (XLA orders a device's
work itself), the port's are torch's CUDA streams and events on the place
`set_device` chose: work queued inside `stream_guard(s)` runs on `s`.
"""
import contextlib

import torch

from ..framework.device import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
    Place,
    TPUPlace,
    current_place,
    device_count,
    get_device,
    is_compiled_with_cuda,
    is_compiled_with_tpu,
    resolve_device,
    set_device,
    synchronize,
)


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_all_custom_device_type():
    return []


def get_available_device():
    return [f"gpu:{i}" for i in range(device_count("gpu"))] or ["cpu"]


def get_available_custom_device():
    return []


def _cuda_device(device):
    d = resolve_device(None if device is None else device)
    if d.type != "cuda":
        raise RuntimeError(f"streams and events live on a GPU, not {d}")
    return d


class Stream:
    """A CUDA stream on `device` (the current place by default)."""

    def __init__(self, device=None, priority=2):
        self.device = _cuda_device(device)
        # Paddle's priorities are 1 (high) and 2 (normal); CUDA's lower
        # numbers are higher priorities
        self.stream = torch.cuda.Stream(self.device,
                                        priority=-1 if priority == 1 else 0)

    def synchronize(self):
        self.stream.synchronize()

    def wait_event(self, event):
        self.stream.wait_event(event.event)

    def wait_stream(self, stream):
        self.stream.wait_stream(stream.stream)

    def record_event(self, event=None):
        event = event or Event(self.device)
        event.record(self)
        return event

    def query(self):
        return self.stream.query()


class Event:
    """A CUDA event."""

    def __init__(self, device=None, enable_timing=False, blocking=False):
        self.device = _cuda_device(device)
        self.event = torch.cuda.Event(enable_timing=enable_timing,
                                      blocking=blocking)

    def record(self, stream=None):
        self.event.record(stream.stream if stream is not None else None)

    def query(self):
        return self.event.query()

    def synchronize(self):
        self.event.synchronize()

    def elapsed_time(self, end_event):
        return self.event.elapsed_time(end_event.event)


def current_stream(device=None):
    """The current CUDA stream of `device`, as a Stream."""
    d = _cuda_device(device)
    s = Stream.__new__(Stream)
    s.device, s.stream = d, torch.cuda.current_stream(d)
    return s


def set_stream(stream):
    """Make `stream` current; returns the stream that was."""
    prev = current_stream(stream.device)
    torch.cuda.set_stream(stream.stream)
    return prev


def stream_guard(stream):
    """A context in which `stream` is current (None: no change)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream.stream)


class cuda:
    """paddle.device.cuda."""

    Stream = Stream
    Event = Event

    @staticmethod
    def device_count():
        return device_count("gpu")

    @staticmethod
    def current_stream(device=None):
        return current_stream(device)

    @staticmethod
    def synchronize(device=None):
        torch.cuda.synchronize(_cuda_device(device))

    @staticmethod
    def empty_cache():
        torch.cuda.empty_cache()

    @staticmethod
    def max_memory_allocated(device=None):
        return torch.cuda.max_memory_allocated(_cuda_device(device))

    @staticmethod
    def memory_allocated(device=None):
        return torch.cuda.memory_allocated(_cuda_device(device))
