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
YOLOv3 detection (``vision.ops``) trains and serves. The reference's
imperative surface is here too: ``Tensor`` and ``Parameter``
(``core.tensor``: how they meet torch, and where their names keep
torch's meaning), ``to_tensor``, ``grad`` with ``create_graph``,
``no_grad``, ``autograd.PyLayer``, the op library behind the ``Tensor``
methods (``ops``), the RNG state (``get_rng_state``/``set_rng_state``),
``set_flags``/``get_flags``, and sparse embeddings
(``nn.Embedding(sparse=True)``: ``SelectedRows`` gradients that ``SGD``,
``Momentum``, ``Adam`` and ``AdamW`` apply row by row). The runtime
services: the op observers at ``core.dispatch`` (``call_op``; the
``FLAGS_check_nan_inf`` check, the ``profiler`` with ``torch.profiler``'s
device trace merged in, the sampled dispatch telemetry of
``observability``), the crash flight recorder, memory accounting, the
lock-order watchdog (``analysis.lockwatch``), and the pod runtime with
elastic restart (``distributed.pod``, ``testing.virtual_pod``). CTR trains
through the parameter server (``distributed.ps``: the native service
built with g++ at first use, its client and communicators, a
device-resident embedding cache with prefetched k-step windows;
``fleet.init(is_collective=False)``; ``models.WideAndDeep``).
"""
from . import ops  # noqa: F401  (first: it sets the Tensor methods)
from . import (amp, autograd, checkpoint, distributed, incubate,  # noqa: F401
               inference, jit, linalg, monitor, nn, observability,
               optimizer, parallel, profiler, recompute, regularizer,
               serving, testing)
from .core.dispatch import call_op, call_op_nograd, unwrap  # noqa: F401
from .core.autograd import enable_grad, grad, no_grad  # noqa: F401
from .core.device import resolve_device
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from .distributed.parallel import DataParallel  # noqa: F401
from .nn.layer.layers import ParamAttr  # noqa: F401
from .core.dtype import bfloat16, convert_dtype, float32, int32  # noqa: F401
from .core.random import (default_generator, get_rng_state,  # noqa: F401
                          seed, set_rng_state)
from .ops import *  # noqa: F401,F403
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


__all__ = ["seed", "default_generator", "get_rng_state", "set_rng_state",
           "resolve_device", "convert_dtype", "DataParallel", "ParamAttr",
           "Tensor", "Parameter", "to_tensor", "grad", "no_grad",
           "enable_grad", "set_flags", "get_flags", "call_op",
           "call_op_nograd", "unwrap", "float32", "bfloat16",
           "int32", "L1Decay", "L2Decay", "save", "load", "amp", "autograd",
           "checkpoint", "distributed", "incubate", "inference", "jit",
           "linalg", "models", "monitor", "nn", "observability", "ops",
           "optimizer", "parallel", "profiler", "recompute", "regularizer",
           "serving", "testing",
           "vision"] + ops.__all__
