"""Vision (counterpart: ``paddle_tpu/vision``): the model zoo's LeNet and
ResNets, the MNIST dataset and the detection ops (``ops``: YOLOv3's loss
and box decode, priors and anchors, NMS, RoI pooling, target assignment).
Not ported: ``transforms``, the other datasets and models (ROADMAP item
19)."""
from . import datasets, models, ops  # noqa: F401

__all__ = ["datasets", "models", "ops"]
