"""Vision (counterpart: ``paddle_tpu/vision``): the model zoo (LeNet, the
ResNets, VGG, MobileNet V1/V2), the datasets (MNIST, FashionMNIST,
Cifar10/100, seeded synthetic sets when no file is given), the host-side
``transforms`` and the detection ops (``ops``: YOLOv3's loss and box
decode, priors and anchors, NMS, RoI pooling, target assignment)."""
from . import datasets, models, ops, transforms  # noqa: F401

__all__ = ["datasets", "models", "ops", "transforms"]
