"""Pooling layers (counterpart: ``paddle_tpu/nn/layer/pooling.py``). As
in the reference, ``MaxPool1D``, ``MaxPool2D`` and ``AdaptiveMaxPool2D``
take ``return_mask`` and return the pooled output alone; the mask comes
from ``F.max_pool2d(..., return_mask=True)`` or
``F.max_pool2d_with_index``."""
from .. import functional as F
from .layers import Layer


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, name=None):
        super().__init__()
        self.k, self.s, self.p, self.ceil = kernel_size, stride, padding, ceil_mode

    def forward(self, x):
        return F.max_pool1d(x, self.k, self.s, self.p, self.ceil)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p, self.ceil = kernel_size, stride, padding, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, self.ceil,
                            self.data_format)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format="NCDHW", name=None):
        super().__init__()
        self.k, self.s, self.p, self.ceil = kernel_size, stride, padding, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool3d(x, self.k, self.s, self.p, self.ceil,
                            self.data_format)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive, self.ceil = exclusive, ceil_mode

    def forward(self, x):
        return F.avg_pool1d(x, self.k, self.s, self.p, self.exclusive,
                            self.ceil)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive, self.ceil = exclusive, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p, self.exclusive,
                            self.ceil, self.data_format)


class AvgPool3D(AvgPool2D):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, exclusive, ceil_mode,
                         data_format, name)

    def forward(self, x):
        return F.avg_pool3d(x, self.k, self.s, self.p, self.exclusive,
                            self.ceil, self.data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)
