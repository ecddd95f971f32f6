from .device import resolve_device, torch_dtype

__all__ = ["resolve_device", "torch_dtype"]
