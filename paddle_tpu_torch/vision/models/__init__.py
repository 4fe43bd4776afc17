"""The vision model zoo (counterpart: ``paddle_tpu/vision/models``).
``pretrained=True`` raises: nothing is downloaded."""
from .lenet import LeNet  # noqa: F401
from .resnet import (ResNet, resnet18, resnet34, resnet50,  # noqa: F401
                     resnet101, resnet152)

__all__ = ["LeNet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152"]
