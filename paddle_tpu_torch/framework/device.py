"""Places and device resolution (counterpart of
`paddle_tpu/framework/device.py`).

Places are Paddle's GPU places: `CUDAPlace(0)` ("gpu:0"), `CPUPlace()`.
`set_device` chooses what `resolve_device(None)` returns, and so where an
entry point given no device runs and where a tensor made with no place
lands. With nothing set that is the current CUDA device; with no CUDA
present it raises rather than running on the CPU: a caller who wants the
CPU (the tests) says so, with `set_device("cpu")`, `device="cpu"` or a
CPU place. The TPU names keep their signatures: `is_compiled_with_tpu()`
is False and `TPUPlace` raises, naming the card.
"""
from __future__ import annotations

import threading

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

_lock = threading.Lock()
_current_place = None  # set by set_device; None: the current CUDA device


class Place:
    """A device place: a device type ("gpu" or "cpu") and an index."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = device_id

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        if isinstance(other, Place):
            return (self.device_type == other.device_type
                    and self.device_id == other.device_id)
        if isinstance(other, (str, torch.device)):
            try:
                return self == _parse_device(other)
            except ValueError:
                return False
        return NotImplemented

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_gpu_place(self):
        return self.device_type == "gpu"

    def is_tpu_place(self):
        return False

    def torch_device(self) -> torch.device:
        """The torch device of this place (a GPU place needs CUDA)."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(f"{self!r}: CUDA is not available")
        if self.device_id >= torch.cuda.device_count():
            raise ValueError(
                f"device index {self.device_id} out of range for gpu "
                f"({torch.cuda.device_count()} devices)")
        return torch.device("cuda", self.device_id)


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("gpu", device_id)


class TPUPlace(Place):
    """The reference's place; the port runs on NVIDIA GPUs."""

    def __init__(self, device_id: int = 0):
        raise RuntimeError("paddle_tpu_torch runs on NVIDIA GPUs, not TPUs: "
                           "use CUDAPlace(id) or 'gpu:id'")


def _parse_device(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        if device.type == "cuda":
            return Place("gpu", 0 if device.index is None else device.index)
        if device.type == "cpu":
            return CPUPlace()
        raise ValueError(f"unsupported device '{device}' (use 'gpu' or "
                         "'cpu')")
    text = str(device).lower()
    kind, _, idx = text.partition(":")
    idx = int(idx) if idx else 0
    if kind == "cuda":
        kind = "gpu"
    if kind == "tpu":
        TPUPlace(idx)
    if kind not in ("cpu", "gpu"):
        raise ValueError(f"unsupported device '{device}' (use 'gpu' or "
                         "'cpu')")
    return Place(kind, idx)


def set_device(device) -> Place:
    """`paddle.set_device("gpu:0" | "gpu" | "cpu" | a Place)`: where an
    entry point given no device runs from now on. A GPU without CUDA
    raises."""
    global _current_place
    place = _parse_device(device)
    place.torch_device()  # validate now
    with _lock:
        _current_place = place
    return place


def get_device() -> str:
    p = current_place()
    return f"{p.device_type}:{p.device_id}"


def current_place() -> Place:
    """The place `set_device` chose, else the current CUDA device (raises
    without CUDA)."""
    if _current_place is not None:
        return _current_place
    return _parse_device(resolve_device(None))


def device_count(device_type: str = "gpu") -> int:
    if str(device_type).lower() == "cpu":
        return 1
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_custom_device(device_type: str) -> bool:
    return False


def get_cudnn_version():
    """cuDNN's version as an int, None when torch has no cuDNN."""
    return torch.backends.cudnn.version() if \
        torch.backends.cudnn.is_available() else None


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_distribute() -> bool:
    return torch.distributed.is_available()


def synchronize():
    """Wait for the current CUDA device's work (nothing to wait for on a
    CPU place)."""
    if current_place().is_gpu_place():
        torch.cuda.synchronize()


def resolve_device(device=None) -> torch.device:
    """`None` -> the place `set_device` chose, else the current CUDA device
    (raises without CUDA); a string, `torch.device` or Place -> that
    device, which must be `cpu` or an available `cuda` device."""
    if device is None:
        if _current_place is not None:
            return _current_place.torch_device()
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: paddle_tpu_torch runs on the "
                "GPU by default; pass device='cpu' or call "
                "set_device('cpu') to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if isinstance(device, Place):
        return device.torch_device()
    if isinstance(device, str) and device.lower().startswith("gpu"):
        return _parse_device(device).torch_device()
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
