"""`paddle.save` / `paddle.load` (counterpart of `paddle_tpu/framework/io.py`).

Nested dicts, lists and tuples of tensors are pickled with every tensor as a
`_TensorPayload`: its values as a numpy array, `stop_gradient` (the
tensor's `not requires_grad`) and `name`. The files cross between the two
packages in both directions without either importing the other:

- The payload pickles under the reference's module path and qualname,
  `paddle_tpu.framework.io._TensorPayload`, with the same `__slots__`
  state, so the reference's `load` rebuilds its own payload from a file
  saved here. The C pickler imports the module it names to check a
  class, so `save` uses a subclass of the pure-Python `pickle._Pickler`
  that writes that global itself (`_Pickler.save_global`).
- `load` reads with an unpickler whose `find_class` maps that name to the
  port's payload.
- bfloat16 has no numpy dtype. The reference's arrays are
  `ml_dtypes.bfloat16`; a bfloat16 tensor saved here is written as
  `numpy.ndarray.view(<its uint16 bits>, ml_dtypes.bfloat16)`, which the
  reference's `pickle.load` turns into such an array. Reading either
  file, `load` maps `ml_dtypes.bfloat16` to the 2-byte void dtype, so the
  bits arrive untouched without ml_dtypes, and a payload's 2-byte void
  array becomes a bfloat16 tensor.

A torch tensor's `name` cannot be set: `load` drops the names it reads
(`return_numpy=False`), and `save` writes a tensor's name only where the
object carries one (`getattr(t, "name", None)`, None for plain tensors).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .device import resolve_device

_REF_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")
_ML_BF16 = ("ml_dtypes", "bfloat16")
_BF16_BITS = np.dtype("V2")


class _TensorPayload:
    """Pickle-stable tensor container (numpy values + metadata), the
    reference's slots."""

    __slots__ = ("array", "stop_gradient", "name")

    def __init__(self, t: torch.Tensor):
        self.stop_gradient = not t.requires_grad
        self.name = getattr(t, "name", None)
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            self.array = _Bf16Bits(t.view(torch.int16).numpy()
                                   .view(np.uint16))
        else:
            self.array = t.numpy()

    def to_tensor(self, device) -> torch.Tensor:
        a = np.ascontiguousarray(self.array)
        if not a.flags.writeable:  # torch takes writeable memory only
            a = a.copy()
        if a.dtype == _BF16_BITS:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        t = t.to(device)
        if not self.stop_gradient and t.is_floating_point():
            t.requires_grad_(True)
        return t

    def to_numpy(self):
        a = self.array
        if a.dtype != _BF16_BITS:
            return a
        bits = np.ascontiguousarray(a).view(np.uint16)
        try:
            import ml_dtypes
        except ImportError:  # exact values, widened
            return (bits.astype(np.uint32) << 16).view(np.float32)
        return bits.view(ml_dtypes.bfloat16)


class _Bf16Bits:
    """A bfloat16 array's uint16 bits on their way into a file (a file
    read back holds them as a 2-byte void array)."""

    __slots__ = ("bits",)

    def __init__(self, bits):
        self.bits = bits


class _BF16Token:
    """Stands for `ml_dtypes.bfloat16` in a file written here."""


_BF16_TOKEN = _BF16Token()


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing the payload class and the
    bfloat16 dtype under the reference's names without importing them."""

    _GLOBALS = {id(_TensorPayload): _REF_PAYLOAD, id(_BF16_TOKEN): _ML_BF16}

    def reducer_override(self, obj):
        if isinstance(obj, _Bf16Bits):
            return np.ndarray.view, (obj.bits, _BF16_TOKEN)
        if obj is _BF16_TOKEN:
            return _ML_BF16[1]
        return NotImplemented

    def save_global(self, obj, name=None):
        spec = self._GLOBALS.get(id(obj))
        if spec is None:
            return super().save_global(obj, name)
        module, qualname = spec
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    """Reads files of either package: the reference's payload class is the
    port's, `ml_dtypes.bfloat16` the 2-byte void dtype."""

    def find_class(self, module, name):
        if (module, name) == _REF_PAYLOAD:
            return _TensorPayload
        if (module, name) == _ML_BF16:
            return _BF16_BITS.str
        return super().find_class(module, name)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_pack(v) for v in obj)
    if isinstance(obj, list):
        return [_pack(v) for v in obj]
    return obj


def _unpack(obj, return_numpy, device):
    if isinstance(obj, _TensorPayload):
        return obj.to_numpy() if return_numpy else obj.to_tensor(device)
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        un = [_unpack(v, return_numpy, device) for v in obj]
        return tuple(un) if isinstance(obj, tuple) else un
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle `obj` (nested dicts, lists and tuples; tensors as payloads)
    to `path`, making its directory. `configs` are accepted and unused, as
    in the reference."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_pack(obj))


def load(path, return_numpy=False, **configs):
    """The object `save` (of either package) wrote to `path`: tensors on
    `configs["device"]` (`framework.device.resolve_device`: the card by
    default; `device="cpu"` for the CPU), or numpy arrays with
    `return_numpy=True` (bfloat16 as `ml_dtypes.bfloat16` where ml_dtypes
    is installed, else widened to float32, exactly). Other `configs` are
    accepted and unused, as in the reference."""
    device = None if return_numpy else resolve_device(configs.get("device"))
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy, device)

