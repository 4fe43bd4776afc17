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
YOLOv3 detection (``vision.ops``) trains and serves. The high-level
loop: ``Model(net).prepare(opt, loss, metrics).fit(dataset, num_workers=W)``
(``hapi``, its train and eval steps CUDA graphs on the card) over ``io``'s
``DataLoader``, whose forked workers run ``vision.transforms`` and send
their batches through shared-memory rings; ``metric``; VGG and MobileNet;
``nn.SyncBatchNorm`` with ``SGD``/``Momentum`` under ZeRO. The reference's
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
``fleet.init(is_collective=False)``; ``models.WideAndDeep``). The
smaller modules: ``quantization`` (QAT through fake-quant wrappers, PTQ,
the quantized artifact and its sidecar), ``onnx`` (export through
``torch.export``), ``linalg``, the op tail (``ops.misc_tail``),
``incubate``'s fused softmaxes, segment reductions and custom C ops,
``distribution``, ``text`` (the synthetic datasets and the CRF ops) and
``dataset`` (the classic readers).
"""
from . import ops  # noqa: F401  (first: it sets the Tensor methods)
from . import (amp, autograd, checkpoint, distributed,  # noqa: F401
               distribution, hapi, incubate, inference, io, jit, linalg,
               metric, monitor, nn, observability, onnx, optimizer, parallel,
               profiler, quantization, recompute, regularizer, serving,
               static, testing)
from .core.dispatch import call_op, call_op_nograd, unwrap  # noqa: F401
from .core.autograd import enable_grad, grad, no_grad  # noqa: F401
from .core.device import (CPUPlace, Place, TPUPlace,  # noqa: F401
                          device_count, get_device, is_compiled_with_tpu,
                          resolve_device, set_device)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from .distributed.parallel import DataParallel  # noqa: F401
from .hapi import Model, flops, summary  # noqa: F401
from .nn.layer.layers import ParamAttr  # noqa: F401
from .core.dtype import (bfloat16, bool_, complex64,  # noqa: F401
                         complex128, convert_dtype, float16, float32,
                         float64, int8, int16, int32, int64, uint8)
from .core.random import (default_generator, get_rng_state,  # noqa: F401
                          seed, set_rng_state)
from .ops import *  # noqa: F401,F403
from .regularizer import L1Decay, L2Decay  # noqa: F401
from .serialization import load, save  # noqa: F401


from . import sparsity  # noqa: F401


def get_default_dtype():
    return "float32"


def set_default_dtype(dtype):
    """Raises, as the reference does: float32 is the fixed default."""
    raise NotImplementedError("float32 is the fixed default; cast per-tensor")


def is_grad_enabled():
    import torch
    return torch.is_grad_enabled()


def set_grad_enabled(flag):
    """Turn gradient recording on or off for this thread (the reference's
    switch, not a context manager)."""
    import torch
    torch.set_grad_enabled(bool(flag))


def in_dynamic_mode():
    """False after :func:`enable_static` (a flag the reference's static
    scripts set; ops run eagerly all the same: Programs record under
    ``static.program_guard``)."""
    return not static._static_mode()


def enable_static(flag=True):
    static._enable_static(flag)


def disable_static(*args, **kwargs):
    """Back to dygraph mode (the reference's is a no-op)."""
    static._enable_static(False)


# The model zoos and the datasets load on first use
# (``paddle_tpu_torch.models``), so a process that serves an exported
# artifact imports no model's module.
_LAZY = ("models", "vision", "text", "dataset")


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
           "checkpoint", "distributed", "hapi", "incubate", "inference",
           "io", "jit", "linalg", "metric", "models", "monitor", "nn",
           "observability", "ops", "distribution", "onnx", "quantization",
           "text", "dataset", "Model", "summary", "flops",
           "optimizer", "parallel", "profiler", "recompute", "regularizer",
           "serving", "testing", "sparsity", "vision", "Place", "CPUPlace",
           "TPUPlace", "set_device", "get_device", "device_count",
           "is_compiled_with_tpu", "bool_", "uint8", "int8", "int16",
           "int64", "float16", "float64", "complex64", "complex128",
           "get_default_dtype", "set_default_dtype", "is_grad_enabled",
           "set_grad_enabled", "in_dynamic_mode", "static",
           "enable_static", "disable_static"] + ops.__all__
