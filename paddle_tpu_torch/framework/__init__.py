from .config import get_flag, get_flags, set_flags
from .device import resolve_device, torch_dtype

__all__ = ["get_flag", "get_flags", "resolve_device", "set_flags",
           "torch_dtype"]
