"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package (``paddle_tpu``) stays the reference; this package mirrors
its module layout and public names in PyTorch idiom, and replaces every
Pallas TPU kernel with a kernel written by hand for Hopper
(``kernels/csrc``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.

Paths of this package: ``models.gpt.GPTForCausalLM`` served behind
``serving.Engine.from_layer``, and trained eagerly under ``amp.auto_cast``
with ``optimizer.AdamW`` (float32 masters) and ``nn.ClipGradByGlobalNorm``;
causal attention runs through the CUDA flash-attention kernels, forward and
backward (``kernels.flash_attention``).
"""
from . import amp, nn, optimizer, regularizer  # noqa: F401
from .core.device import resolve_device  # noqa: F401
from .core.dtype import bfloat16, convert_dtype, float32, int32  # noqa: F401
from .core.random import default_generator, seed  # noqa: F401

__all__ = ["seed", "default_generator", "resolve_device", "convert_dtype",
           "float32", "bfloat16", "int32", "amp", "nn", "optimizer",
           "regularizer"]
