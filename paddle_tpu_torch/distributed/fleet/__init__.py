from . import utils

__all__ = ["utils"]
