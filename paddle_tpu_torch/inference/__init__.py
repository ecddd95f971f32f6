from .scheduler import FifoSchedulerPolicy
from .serving import FinishedRequest, ServingEngine

__all__ = ["FifoSchedulerPolicy", "FinishedRequest", "ServingEngine"]
