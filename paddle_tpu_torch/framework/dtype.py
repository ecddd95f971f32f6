"""Paddle's dtype names over torch dtypes (counterpart of
`paddle_tpu/framework/dtype.py`).

`paddle.float32`, `paddle.bfloat16`, `paddle.int64`, `paddle.bool`, ... are
torch's own dtype objects, so a port tensor's `dtype` compares equal to
them and every torch call takes them. Where the reference compares its
`DType` with a string or a numpy dtype, the port converts the other side
first: `to_torch_dtype("float32") == paddle.float32`, and `dtype_name`
gives the reference's name of a torch dtype. `DType` is `torch.dtype`.
A torch dtype does not compare equal to a string (ROADMAP, deliberate
differences).
"""
from __future__ import annotations

import numpy as np
import torch

DType = torch.dtype

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

# the reference's names, in its promotion order, then the fp8 types
_BY_NAME = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
    "float8_e4m3fn": float8_e4m3fn, "float8_e5m2": float8_e5m2,
}
_NAME_OF = {v: k for k, v in _BY_NAME.items()}
_FLOATING = (float16, bfloat16, float32, float64, float8_e4m3fn,
             float8_e5m2)


def dtype_name(dtype) -> str:
    """The reference's name of a dtype-like ("float32", "bfloat16", ...)."""
    return _NAME_OF[to_torch_dtype(dtype)]


def to_torch_dtype(dtype):
    """Any dtype-like (a torch dtype, a name with or without "paddle.", a
    numpy dtype or type, `ml_dtypes.bfloat16`) as a torch dtype; None
    stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype.replace("paddle.", "")
        if name in _BY_NAME:
            return _BY_NAME[name]
        dtype = np.dtype(name)
    nd = np.dtype(dtype)
    if nd.name in _BY_NAME:
        return _BY_NAME[nd.name]
    raise TypeError(f"unsupported dtype {dtype!r}")


def to_np_dtype(dtype) -> np.dtype:
    """A dtype-like as a numpy dtype (bfloat16 and fp8 as ml_dtypes')."""
    if dtype is None:
        return None
    name = dtype_name(dtype)
    if name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, name))
    return np.dtype(name)


def from_np_dtype(np_dtype):
    """A numpy (or ml_dtypes) dtype as a torch dtype."""
    return to_torch_dtype(np_dtype)


def default_dtype():
    from . import config

    return to_torch_dtype(config.get_default_dtype())


def is_floating_dtype(dtype) -> bool:
    return to_torch_dtype(dtype) in _FLOATING
