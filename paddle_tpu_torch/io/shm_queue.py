"""The DataLoader's worker-to-trainer transport (counterpart of
`paddle_tpu/io/shm_queue.py`): a single-producer single-consumer ring of
byte blobs in shared memory (`native/shm_ring.cc`, built by `g++` at first
use), with pickling on top."""
from __future__ import annotations

import ctypes
import os
import pickle
import time
from typing import Optional

from ..native import _build

_lib = None


def _native():
    global _lib
    if _lib is None:
        lib = _build.load("shm_ring")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.shm_ring_create.restype = ctypes.c_void_p
        lib.shm_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.shm_ring_open.restype = ctypes.c_void_p
        lib.shm_ring_open.argtypes = [ctypes.c_char_p]
        lib.shm_ring_write.restype = ctypes.c_int
        lib.shm_ring_write.argtypes = [ctypes.c_void_p, u8p,
                                       ctypes.c_uint32, ctypes.c_int]
        lib.shm_ring_read.restype = ctypes.c_int64
        lib.shm_ring_read.argtypes = [ctypes.c_void_p, u8p,
                                      ctypes.c_uint64, ctypes.c_int]
        lib.shm_ring_peek.restype = ctypes.c_int64
        lib.shm_ring_peek.argtypes = [ctypes.c_void_p]
        lib.shm_ring_close.argtypes = [ctypes.c_void_p]
        lib.shm_ring_unlink.argtypes = [ctypes.c_char_p]
        _lib = lib
    return _lib


class ShmRing:
    """SPSC shared-memory blob queue.

    Consumer (creates it):  ring = ShmRing(name, capacity); b = ring.get()
    Producer:               ring = ShmRing(name, open_existing=True);
                            ring.put(b)
    """

    def __init__(self, name: str, capacity: int = 64 << 20,
                 open_existing: bool = False):
        lib = _native()
        self._lib = lib
        self.name = name
        if open_existing:
            self._h = lib.shm_ring_open(name.encode())
        else:
            self._h = lib.shm_ring_create(name.encode(), int(capacity))
        if not self._h:
            raise RuntimeError(
                f"shm ring '{name}' could not be "
                f"{'opened' if open_existing else 'created'}")

    def put_bytes(self, data: bytes, timeout: Optional[float] = None):
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        ms = -1 if timeout is None else max(1, int(timeout * 1000))
        rc = self._lib.shm_ring_write(self._h, buf, len(data), ms)
        if rc == -1:
            raise TimeoutError(f"shm ring '{self.name}' full")
        if rc == -2:
            raise ValueError(
                f"blob of {len(data)} bytes exceeds ring capacity")

    def get_bytes(self, timeout: Optional[float] = None) -> bytes:
        # peek for the blob's size first: a read into a smaller buffer
        # would truncate it
        n = self._lib.shm_ring_peek(self._h)
        deadline = None if timeout is None else time.monotonic() + timeout
        while n < 0:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"shm ring '{self.name}' empty")
            time.sleep(0.0002)
            n = self._lib.shm_ring_peek(self._h)
        out = (ctypes.c_uint8 * n)()
        got = self._lib.shm_ring_read(self._h, out, n, 0)
        if got != n:
            raise RuntimeError(f"shm ring '{self.name}': read {got} of {n} "
                               "bytes")
        return bytes(out)

    def put(self, obj, timeout: Optional[float] = None):
        self.put_bytes(pickle.dumps(obj, protocol=4), timeout)

    def get(self, timeout: Optional[float] = None):
        return pickle.loads(self.get_bytes(timeout))

    def close(self):
        if self._h:
            self._lib.shm_ring_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def ring_name(prefix: str = "pdtpu") -> str:
    return f"/{prefix}_{os.getpid()}_{os.urandom(4).hex()}"
