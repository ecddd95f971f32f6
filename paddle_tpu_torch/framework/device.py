"""Device and dtype resolution for the port's entry points.

An entry point given `device=None` runs on the current CUDA device. With no
CUDA present it raises rather than running on the CPU: a caller who wants
the CPU (the tests) says so with `device="cpu"`.
"""
from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device (raises without CUDA); a string or
    `torch.device` -> that device, which must be `cpu` or an available
    `cuda` device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: paddle_tpu_torch runs on the "
                "GPU by default; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """A config dtype name ("float32", "bfloat16", ...) or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None
