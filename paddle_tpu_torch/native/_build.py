"""Build the host C++ sources of this directory with `g++` and load them by
ctypes (the sibling of `kernels/_build.py`, which builds the CUDA kernels).

    g++ -O2 -std=c++17 -fPIC -shared -pthread \
        -o build/native/<name>-<hash>.so <name>.cc

The library lands in `build/native/` at the repository root (listed in
`.gitignore`), named by a hash of the source and the flags, at first use.
Concurrent processes building the same library each write a file of their
own and rename it into place, so either finished copy may win.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_libs: dict = {}


def library_path(name: str) -> Path:
    h = hashlib.sha256((SRC / f"{name}.cc").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` (`native/<name>.cc`), built first if
    needed; raises with the compiler's output if the build fails."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so = library_path(name)
        if not so.is_file():
            cxx = os.environ.get("CXX") or shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: the port's host runtime "
                                   f"({name}.cc) is built from source")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC / f"{name}.cc")],
                capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"g++ failed on {name}.cc (exit "
                                   f"{proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
        lib = _libs[name] = ctypes.CDLL(str(so))
        return lib
