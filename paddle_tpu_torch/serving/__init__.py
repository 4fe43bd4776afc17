"""Serving (counterpart: ``paddle_tpu/serving``): a bucketed engine with
concurrent dynamic batching over a live model, run eagerly on the card.

Quick start::

    from paddle_tpu_torch import serving

    engine = serving.Engine.from_layer(model, [([None, 1024], "int32")],
                                       bucket_ladder=(1, 4),
                                       passes=("bf16",))
    fut = engine.submit(ids)        # concurrent callers coalesce
    (logits,) = fut.result()        # numpy arrays, rows match the request
    engine.close()
"""
from .batching import (DeadlineExceeded, DynamicBatcher,  # noqa: F401
                       OverloadedError, Request)
from .engine import DEFAULT_BUCKET_LADDER, Engine  # noqa: F401
from .passes import SERVING_PASSES, validate_passes  # noqa: F401

__all__ = ["Engine", "DEFAULT_BUCKET_LADDER", "DynamicBatcher", "Request",
           "OverloadedError", "DeadlineExceeded", "SERVING_PASSES",
           "validate_passes"]
