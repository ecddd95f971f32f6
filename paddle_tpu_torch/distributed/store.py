"""TCPStore: the rendezvous key-value store over the native daemon
(counterpart of `paddle_tpu/distributed/store.py`).

Rank 0 hosts the daemon (`native/tcp_store.cc`, built by `g++` at first
use), every rank connects; set / get / add / wait / delete_key / num_keys
and a reusable `barrier` built on add and wait.
"""
from __future__ import annotations

import ctypes
import socket
from typing import Optional

from ..native import _build

_lib = None


def _native():
    global _lib
    if _lib is None:
        lib = _build.load("tcp_store")
        lib.tcp_store_master_start.restype = ctypes.c_void_p
        lib.tcp_store_master_start.argtypes = [ctypes.c_int]
        lib.tcp_store_master_port.restype = ctypes.c_int
        lib.tcp_store_master_port.argtypes = [ctypes.c_void_p]
        lib.tcp_store_master_stop.argtypes = [ctypes.c_void_p]
        lib.tcp_store_connect.restype = ctypes.c_int
        lib.tcp_store_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                          ctypes.c_int]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.tcp_store_set.restype = ctypes.c_int64
        lib.tcp_store_set.argtypes = [ctypes.c_int, ctypes.c_char_p, u8p,
                                      ctypes.c_uint32]
        lib.tcp_store_get.restype = ctypes.c_int64
        lib.tcp_store_get.argtypes = [ctypes.c_int, ctypes.c_char_p, u8p,
                                      ctypes.c_uint32, u32p]
        lib.tcp_store_add.restype = ctypes.c_int64
        lib.tcp_store_add.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                      ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int64)]
        lib.tcp_store_wait.restype = ctypes.c_int64
        lib.tcp_store_wait.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                       ctypes.c_uint64, u8p, ctypes.c_uint32,
                                       u32p]
        lib.tcp_store_delete.restype = ctypes.c_int64
        lib.tcp_store_delete.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.tcp_store_num_keys.restype = ctypes.c_int64
        lib.tcp_store_num_keys.argtypes = [ctypes.c_int]
        lib.tcp_store_close.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


_MAX_VAL = 1 << 20


class TCPStore:
    """store = TCPStore(host, port, world_size, is_master=rank == 0)

    port=0 with is_master picks a free port (read it from `.port`).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 world_size: int = 1, is_master: bool = False,
                 timeout: float = 30.0):
        lib = _native()
        self._lib = lib
        self._daemon = None
        self._fd = -1
        self.world_size = world_size
        self.is_master = is_master
        if is_master:
            self._daemon = lib.tcp_store_master_start(int(port))
            if not self._daemon:
                raise RuntimeError(f"TCPStore master failed to bind :{port}")
            port = lib.tcp_store_master_port(self._daemon)
        self.host, self.port = host, int(port)
        # the native client takes IPv4 literals only
        try:
            ip = socket.gethostbyname(host)
        except OSError:
            ip = host
        self._fd = lib.tcp_store_connect(
            ip.encode(), self.port, int(timeout * 1000))
        if self._fd < 0:
            self.close()
            raise TimeoutError(
                f"TCPStore could not reach {host}:{self.port} within "
                f"{timeout}s")

    def set(self, key: str, value) -> None:
        data = value if isinstance(value, bytes) else str(value).encode()
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) \
            if data else None
        st = self._lib.tcp_store_set(self._fd, key.encode(), buf, len(data))
        if st != 0:
            raise RuntimeError(f"TCPStore.set({key}) failed: {st}")

    def get(self, key: str, _cap: int = _MAX_VAL) -> Optional[bytes]:
        """The value of `key`, or None when it is not set."""
        out = (ctypes.c_uint8 * _cap)()
        olen = ctypes.c_uint32(0)
        st = self._lib.tcp_store_get(self._fd, key.encode(), out, _cap,
                                     ctypes.byref(olen))
        if st == -1:
            return None
        if st != 0:
            raise RuntimeError(f"TCPStore.get({key}) failed: {st}")
        if olen.value > _cap:  # larger than the probe buffer: read again
            return self.get(key, _cap=olen.value)
        return bytes(out[:olen.value])

    def add(self, key: str, amount: int = 1) -> int:
        result = ctypes.c_int64(0)
        st = self._lib.tcp_store_add(self._fd, key.encode(), int(amount),
                                     ctypes.byref(result))
        if st != 0:
            raise RuntimeError(f"TCPStore.add({key}) failed: {st}")
        return int(result.value)

    def wait(self, key: str, timeout: Optional[float] = None,
             _cap: int = _MAX_VAL) -> bytes:
        """Block until `key` is set (at most `timeout` seconds: then
        TimeoutError); its value."""
        out = (ctypes.c_uint8 * _cap)()
        olen = ctypes.c_uint32(0)
        ms = 0 if timeout is None else max(1, int(timeout * 1000))
        st = self._lib.tcp_store_wait(self._fd, key.encode(), ms, out,
                                      _cap, ctypes.byref(olen))
        if st == -2:
            raise TimeoutError(f"TCPStore.wait({key}) timed out")
        if st != 0:
            raise RuntimeError(f"TCPStore.wait({key}) failed: {st}")
        if olen.value > _cap:  # set now; read again at its size
            return self.wait(key, timeout, _cap=olen.value)
        return bytes(out[:olen.value])

    def delete_key(self, key: str) -> bool:
        return self._lib.tcp_store_delete(self._fd, key.encode()) > 0

    def num_keys(self) -> int:
        return int(self._lib.tcp_store_num_keys(self._fd))

    def barrier(self, name: str, rank: int = 0, timeout: float = 60.0):
        """Block until all `world_size` ranks arrive. Reusable: arrival n
        belongs to epoch (n - 1) // world_size, each epoch with its own
        go-key, so one name can gate every iteration."""
        n = self.add(f"__barrier/{name}/count", 1)
        epoch = (n - 1) // self.world_size
        if n % self.world_size == 0:
            self.set(f"__barrier/{name}/go{epoch}", b"1")
        self.wait(f"__barrier/{name}/go{epoch}", timeout)

    def close(self):
        if self._fd >= 0:
            self._lib.tcp_store_close(self._fd)
            self._fd = -1
        if self._daemon:
            self._lib.tcp_store_master_stop(self._daemon)
            self._daemon = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
