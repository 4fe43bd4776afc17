"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package (``paddle_tpu``) stays the reference; this package mirrors
its module layout and public names in PyTorch idiom, and replaces every
Pallas TPU kernel with a kernel written by hand for Hopper
(``kernels/csrc``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.

Paths of this package: ``models.bert.BertForPretraining`` (the JAX
package's ``bench.py`` step) and ``models.gpt.GPTForCausalLM`` trained under
``amp.auto_cast`` with ``optimizer.AdamW`` (float32 masters), eagerly or as
the k-step program ``jit.to_static(one_step, scan_steps=k)`` (a CUDA graph
on the card); GPT also served behind ``serving.Engine.from_layer``. Causal
attention at ``seq_len >= 1024`` runs through the CUDA flash-attention
kernels, forward and backward (``kernels.flash_attention``).
"""
from . import amp, jit, nn, optimizer, regularizer  # noqa: F401
from .core.device import resolve_device  # noqa: F401
from .core.dtype import bfloat16, convert_dtype, float32, int32  # noqa: F401
from .core.random import default_generator, seed  # noqa: F401

__all__ = ["seed", "default_generator", "resolve_device", "convert_dtype",
           "float32", "bfloat16", "int32", "amp", "jit", "nn", "optimizer",
           "regularizer"]
