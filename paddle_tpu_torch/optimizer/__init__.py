from . import lr
from .optimizer import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                        AdamW, L1Decay, L2Decay, Lamb, Momentum, NAdam,
                        Optimizer, RAdam, RMSProp, Rprop)

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "L1Decay", "L2Decay", "LBFGS", "Lamb", "Momentum", "NAdam",
           "Optimizer", "RAdam", "RMSProp", "Rprop", "SGD", "lr"]
