"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package (``paddle_tpu``) stays the reference; this package mirrors
its module layout and public names in PyTorch idiom, and replaces every
Pallas TPU kernel with a kernel written by hand for Hopper
(``kernels/csrc``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.

Paths of this package: ``models.BertForPretraining`` (the JAX package's
``bench.py`` step) and ``models.GPTForCausalLM`` trained under
``amp.auto_cast`` with ``optimizer.AdamW`` (float32 masters), eagerly or as
the k-step program ``jit.to_static(one_step, scan_steps=k)`` (a CUDA graph
on the card), data-parallel over a ``torch.distributed`` group with ZeRO-1/2/3
(``dp_axis``, ``optimizer._zero_enable``, ``distributed``), with
accumulation windows (``accumulate_steps``) and activation recompute
(``recompute``, ``Layer.enable_recompute``), with crash-consistent step
checkpoints of the whole training state that resume bit for bit, at
another dp degree too, and move between this package and the reference
(``checkpoint``, ``save``/``load``); GPT also served behind
``serving.Engine.from_layer``, and from the artifact that ``jit.save``
writes (``jit.load``, ``inference.Predictor``, ``serving.Engine(path)``,
one CUDA graph per bucket on the card). GPT-3 1.3B (``models.gpt3_1p3b``) and BERT
train under the fleet's hybrid parallelism (``distributed.fleet``: dp x pp
x sharding x mp process groups, tensor-parallel layers, ``PipelineLayer``
with the 1F1B schedules), with ring and Ulysses attention and Switch MoE
over their own groups (``parallel``). Causal attention at ``seq_len >= 1024``
runs through the CUDA flash-attention kernels, forward and backward
(``kernels.flash_attention``). Convolutional networks (``vision.models``:
LeNet, the ResNets) train with ``optimizer.Momentum`` and
``optimizer.lr.PiecewiseDecay`` through ``nn.Conv2D``, ``nn.BatchNorm2D``
and the pooling layers (torch's convolutions, cuDNN on the card), eagerly
or as the k-step program, and are served behind ``Engine.from_layer``.
"""
import numpy as np
import torch

from . import (amp, checkpoint, distributed, incubate,  # noqa: F401
               inference, jit, monitor, nn, optimizer, parallel, recompute,
               regularizer, serving)
from .core.device import resolve_device
from .distributed.parallel import DataParallel  # noqa: F401
from .nn.layer.layers import ParamAttr  # noqa: F401
from .core.dtype import bfloat16, convert_dtype, float32, int32  # noqa: F401
from .core.random import default_generator, seed  # noqa: F401
from .ops import flatten, reshape, unstack  # noqa: F401
from .regularizer import L1Decay, L2Decay  # noqa: F401
from .serialization import load, save  # noqa: F401


# The model zoos load on first use (``paddle_tpu_torch.models``), so a
# process that serves an exported artifact imports no model's module.
_LAZY = ("models", "vision")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``data`` (a tensor, numpy array, scalar or nested list) as a tensor
    on the card, unless ``place`` asks for the CPU (``"cpu"``); numpy's
    dtype is kept unless ``dtype`` names another. ``stop_gradient=False``
    makes it require grad."""
    where = resolve_device(place)
    if isinstance(data, torch.Tensor):
        t = data.detach()
    else:
        t = torch.from_numpy(np.array(data, copy=True))
    t = t.to(device=where, dtype=convert_dtype(dtype) if dtype else None,
             copy=True)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


__all__ = ["seed", "default_generator", "resolve_device", "convert_dtype",
           "DataParallel", "ParamAttr", "to_tensor", "flatten", "reshape", "unstack",
           "float32", "bfloat16", "int32", "L1Decay", "L2Decay",
           "save", "load", "amp", "checkpoint", "distributed", "incubate",
           "inference", "jit", "models", "monitor", "nn", "optimizer", "parallel",
           "recompute", "regularizer", "serving", "vision"]
