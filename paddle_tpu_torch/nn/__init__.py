"""Layers and functionals (counterpart: ``paddle_tpu/nn``)."""
from . import functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer.activation import ReLU  # noqa: F401
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.container import LayerList, Sequential  # noqa: F401
from .layer.conv import Conv1D, Conv2D, Conv3D  # noqa: F401
from .layer.layers import Layer, ParamAttr  # noqa: F401
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                         BatchNorm3D, LayerNorm, LocalResponseNorm)
from .layer.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                            AdaptiveMaxPool2D, AvgPool1D, AvgPool2D,
                            AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)

__all__ = ["Layer", "ParamAttr", "Linear", "Embedding", "Dropout", "LayerNorm",
           "LayerList", "Sequential", "ReLU", "Conv1D", "Conv2D", "Conv3D",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D", "LocalResponseNorm", "functional", "initializer",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
