"""Optimizers, parameter averaging and LR schedulers (counterpart:
``paddle_tpu/optimizer``)."""
from . import lr  # noqa: F401
from .averaging import (ExponentialMovingAverage, LookAhead,  # noqa: F401
                        ModelAverage)
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, DecayedAdagrad, Dpsgd, Ftrl, Lamb, Lars,
                        Momentum, Optimizer, ProximalAdagrad, ProximalGD,
                        RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "Lars", "DecayedAdagrad",
           "ProximalGD", "ProximalAdagrad", "Ftrl", "Dpsgd", "ModelAverage",
           "ExponentialMovingAverage", "LookAhead", "lr"]
