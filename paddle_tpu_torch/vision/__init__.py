"""Vision (counterpart: ``paddle_tpu/vision``): the model zoo's LeNet and
ResNets and the MNIST dataset. Not ported: ``transforms``, ``ops``, the
other datasets and models (ROADMAP item 19)."""
from . import datasets, models  # noqa: F401

__all__ = ["datasets", "models"]
