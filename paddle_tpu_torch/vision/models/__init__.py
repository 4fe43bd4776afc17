"""The vision model zoo (counterpart: ``paddle_tpu/vision/models``):
LeNet, the ResNets, VGG and MobileNet V1/V2. ``pretrained=True`` raises:
nothing is downloaded."""
from .lenet import LeNet  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2,  # noqa: F401
                        mobilenet_v1, mobilenet_v2)
from .resnet import (ResNet, resnet18, resnet34, resnet50,  # noqa: F401
                     resnet101, resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401

__all__ = ["LeNet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "VGG", "vgg11", "vgg13", "vgg16",
           "vgg19", "MobileNetV1", "MobileNetV2", "mobilenet_v1",
           "mobilenet_v2"]
