"""Build the CUDA kernels under `csrc/` with `nvcc` and load them by ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/<name>-<hash>.so <name>.cu

The library lands in `build/kernels/` at the repository root (listed in
`.gitignore`), named by a hash of the source, the sources it includes from
`csrc/` and the flags, so an edited source rebuilds and an unchanged one is
reused. A source may include another whole (`flash_attention_seg.cu`
builds `flash_attention.cu` with one variant's macros) and headers that
include others (`skinny_matmul.cuh` includes `sm90.cuh`). `build()` starts
one `nvcc` per missing library, all at once, and waits for them; `load()`
builds what it needs on first use. Only the sources in this checkout are compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("rms_norm", "paged_attention", "flash_attention",
           "flash_attention_seg", "flash_attention_drop",
           "flash_attention_seg_drop", "quant_matmul", "matmul", "adam")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict = {}
# nvcc's output (ptxas register / spill report) of the last build, by name
build_log: dict = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled from "
                       "source with the CUDA toolkit (set CUDA_HOME)")


_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.M)


def _sources(name: str) -> list:
    """`csrc/<name>.cu` and every file of `csrc/` it includes, directly or
    through another, each once, in the order first met."""
    seen, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        todo += [inc.decode() for inc in
                 _INCLUDE.findall((CSRC / f).read_bytes())]
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in _sources(name):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every named kernel library not yet built, one `nvcc` process
    per source, all running together. Returns the wall seconds taken;
    raises with nvcc's output if any compile fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        so = library_path(name)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, so))
    errors = []
    for name, proc, tmp, so in jobs:
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode:
            errors.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
