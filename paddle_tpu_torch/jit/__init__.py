"""to_static and the k-step program (counterpart: ``paddle_tpu/jit``)."""
from .to_static import StaticFunction, to_static  # noqa: F401

__all__ = ["to_static", "StaticFunction"]
