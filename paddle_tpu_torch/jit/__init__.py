"""to_static and the k-step program, and the saved-model artifact
(counterpart: ``paddle_tpu/jit``): ``save``/``load`` write and read the
process-independent ``.pdmodel``/``.pdiparams`` pair (``export.py``)."""
from .io import ServedLayer, TranslatedLayer, load, save  # noqa: F401
from .to_static import (InputSpec, StaticFunction, in_tracing,  # noqa: F401
                        not_to_static, to_static)
from .traced_layer import TracedLayer  # noqa: F401

__all__ = ["to_static", "StaticFunction", "InputSpec", "save", "load",
           "TranslatedLayer", "ServedLayer", "in_tracing", "not_to_static",
           "TracedLayer"]
