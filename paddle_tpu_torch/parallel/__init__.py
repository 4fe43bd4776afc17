"""Parallelism primitives (counterpart: ``paddle_tpu/parallel``): ring and
Ulysses attention over an sp group, Switch MoE over an ep group, and the
pipeline schedules over the pipe group."""
from .moe import moe_ffn, switch_route  # noqa: F401
from .pipeline import (pipelined_transformer_step,  # noqa: F401
                       ring_buffer_size, spmd_pipeline, spmd_pipeline_1f1b)
from .ring_attention import ring_attention, ulysses_attention  # noqa: F401

__all__ = ["ring_attention", "ulysses_attention", "moe_ffn", "switch_route",
           "spmd_pipeline", "spmd_pipeline_1f1b", "ring_buffer_size",
           "pipelined_transformer_step"]
