"""Serving (counterpart: ``paddle_tpu/serving``): a bucketed engine with
concurrent dynamic batching over a saved artifact (or a live layer), one
CUDA graph per bucket on the card.

Quick start::

    from paddle_tpu_torch import jit, serving

    jit.save(model, "out/gpt", input_spec=[jit.InputSpec([None, 1024],
                                                          "int32", "ids")])
    engine = serving.Engine("out/gpt", bucket_ladder=(1, 4))
    fut = engine.submit(ids)        # concurrent callers coalesce
    (logits,) = fut.result()        # numpy arrays, rows match the request
    engine.close()
"""
from .batching import (DeadlineExceeded, DynamicBatcher,  # noqa: F401
                       OverloadedError, Request)
from .engine import (DEFAULT_BUCKET_LADDER, Engine,  # noqa: F401
                     create_engine)
from .passes import (SERVING_PASSES, build_serving_program,  # noqa: F401
                     serving_bf16_cast_pass, validate_passes)

__all__ = ["Engine", "create_engine", "DEFAULT_BUCKET_LADDER",
           "DynamicBatcher", "Request", "OverloadedError", "DeadlineExceeded",
           "SERVING_PASSES", "validate_passes", "build_serving_program",
           "serving_bf16_cast_pass"]
