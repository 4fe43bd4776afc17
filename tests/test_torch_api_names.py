"""The public names of the ported modules resolve under the port (a
repaired fault: ``bench.py``'s model import and ``to_tensor`` did not).

A name of ``API.spec`` (the reference's frozen surface) belongs to a
ported module when the reference defines its function or class in a module
that the port has ported (the module's whole surface), or it is one of the
ported classes of a module ported in part (the optimizers, the schedulers,
``Layer``); a method counts with its class. Each such name must resolve at
the same path under ``paddle_tpu_torch``, except the names listed in
``NOT_PORTED``, which must not (a name ported later leaves the list).
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (resolves the reference's names)
import paddle_tpu_torch

ROOT = Path(__file__).resolve().parent.parent

PORTED_MODULES = {
    "paddle_tpu.models.bert", "paddle_tpu.models.gpt", "paddle_tpu.recompute",
    "paddle_tpu.jit.to_static", "paddle_tpu.distributed.parallel_env",
    "paddle_tpu.distributed.collective", "paddle_tpu.distributed.bucketing",
    "paddle_tpu.amp.auto_cast", "paddle_tpu.nn.clip",
    "paddle_tpu.regularizer", "paddle_tpu.core.random",
    "paddle_tpu.observability.step",
    # step checkpoints and what they stand on
    "paddle_tpu.checkpoint", "paddle_tpu.checkpoint.core",
    "paddle_tpu.checkpoint.state", "paddle_tpu.checkpoint.multihost",
    "paddle_tpu.amp.grad_scaler", "paddle_tpu.serialization",
    "paddle_tpu.incubate.auto_checkpoint", "paddle_tpu.monitor",
    "paddle_tpu.testing.faults", "paddle_tpu.observability.tracing",
    "paddle_tpu.observability.runlog",
    "paddle_tpu.distributed.fleet.utils.fs",
    # hybrid parallelism
    "paddle_tpu.distributed.parallel",
    "paddle_tpu.distributed.fleet.base.topology",
    "paddle_tpu.distributed.fleet.base.distributed_strategy",
    "paddle_tpu.distributed.fleet.base.fleet_base",
    "paddle_tpu.distributed.fleet.meta_parallel.mp_layers",
    "paddle_tpu.distributed.fleet.meta_parallel.random",
    "paddle_tpu.distributed.fleet.meta_parallel.tensor_parallel",
    "paddle_tpu.distributed.fleet.meta_parallel.sharding_parallel",
    "paddle_tpu.distributed.fleet.meta_parallel.pp_layers",
    "paddle_tpu.distributed.fleet.meta_parallel.pipeline_parallel",
    "paddle_tpu.parallel.pipeline", "paddle_tpu.parallel.ring_attention",
    "paddle_tpu.parallel.moe", "paddle_tpu.incubate.moe",
    # the convolutional path, and detection
    "paddle_tpu.vision.models.lenet", "paddle_tpu.vision.models.resnet",
    "paddle_tpu.vision.ops",
    # serving from a saved artifact
    "paddle_tpu.jit.io", "paddle_tpu.jit.export", "paddle_tpu.inference",
    "paddle_tpu.serving.engine", "paddle_tpu.serving.passes",
    "paddle_tpu.core.op_version",
    # the imperative surface: Tensor and Parameter, autograd, PyLayer, the
    # op library, SelectedRows, the state registry, enforce, the vision
    # functionals
    "paddle_tpu.core.tensor", "paddle_tpu.core.autograd",
    "paddle_tpu.autograd.py_layer", "paddle_tpu.ops.math",
    "paddle_tpu.ops.manipulation", "paddle_tpu.ops.extras",
    "paddle_tpu.ops.random", "paddle_tpu.core.selected_rows",
    "paddle_tpu.core.state", "paddle_tpu.core.enforce",
    "paddle_tpu.nn.functional.vision",
    # runtime services: the op observer and the NaN check, the profiler,
    # the flight recorder, memory accounting, the gate, lockwatch, and the
    # pod with elastic restart
    "paddle_tpu.core.dispatch", "paddle_tpu.core.flags",
    "paddle_tpu.profiler", "paddle_tpu.observability",
    "paddle_tpu.observability.flight", "paddle_tpu.observability.memory",
    "paddle_tpu.observability.gate", "paddle_tpu._lockwatch",
    "paddle_tpu.distributed.restart", "paddle_tpu.distributed.spawn",
    "paddle_tpu.distributed.launch", "paddle_tpu.distributed.pod",
    "paddle_tpu.distributed.fleet.elastic",
    "paddle_tpu.testing.virtual_pod",
    # CTR and the parameter server, with the graph client, the
    # heterogeneous channel, the TDM tree index and ops and the CTR op tail
    "paddle_tpu.distributed.ps", "paddle_tpu.distributed.ps.client",
    "paddle_tpu.distributed.ps.server", "paddle_tpu.distributed.ps.retry",
    "paddle_tpu.distributed.ps.communicator",
    "paddle_tpu.distributed.ps.embedding",
    "paddle_tpu.distributed.ps.hbm_cache",
    "paddle_tpu.distributed.ps.async_cache",
    "paddle_tpu.distributed.ps.trainer",
    "paddle_tpu.distributed.fleet.dataset",
    "paddle_tpu.distributed.fleet.base.role_maker", "paddle_tpu.models.ctr",
    "paddle_tpu.distributed.ps.heter", "paddle_tpu.distributed.ps.graph",
    "paddle_tpu.ops.ctr_tail", "paddle_tpu.ops.tdm",
    "paddle_tpu.distributed.fleet.index_dataset",
    # the nn layer library: activations, the common layers, containers,
    # losses, the RNNs and beam search, the Transformer, the layer tail,
    # their functionals and initializers, the schedulers, and the LoD
    # sequence ops
    "paddle_tpu.nn.layer.activation", "paddle_tpu.nn.layer.common",
    "paddle_tpu.nn.layer.container", "paddle_tpu.nn.layer.loss",
    "paddle_tpu.nn.layer.rnn", "paddle_tpu.nn.layer.transformer",
    "paddle_tpu.nn.layer.extras", "paddle_tpu.nn.functional.activation",
    "paddle_tpu.nn.functional.common", "paddle_tpu.nn.functional.loss",
    "paddle_tpu.nn.functional.norm", "paddle_tpu.nn.initializer",
    "paddle_tpu.optimizer.lr", "paddle_tpu.ops.sequence",
    # the high-level training loop: hapi, io's DataLoader over shared-memory
    # workers, metric, vision's transforms, datasets, VGG and MobileNet, and
    # the convolution, norm and pooling modules whole (the transposed
    # convolutions, SyncBatchNorm, the max-pool indices)
    "paddle_tpu.hapi.model", "paddle_tpu.hapi.callbacks",
    "paddle_tpu.hapi.hub", "paddle_tpu.io.dataset", "paddle_tpu.io.sampler",
    "paddle_tpu.io.dataloader", "paddle_tpu.io.shm_worker",
    "paddle_tpu.metric", "paddle_tpu.vision.transforms",
    "paddle_tpu.vision.datasets", "paddle_tpu.vision.models.vgg",
    "paddle_tpu.vision.models.mobilenet", "paddle_tpu.nn.layer.conv",
    "paddle_tpu.nn.layer.norm", "paddle_tpu.nn.layer.pooling",
    "paddle_tpu.nn.functional.conv", "paddle_tpu.nn.functional.pooling",
    # the optimizer breadth: parameter averaging, sparsity, the top level's
    # devices and the fleet's meta-optimizers
    "paddle_tpu.optimizer.averaging", "paddle_tpu.sparsity",
    "paddle_tpu.core.device",
    "paddle_tpu.distributed.fleet.meta_optimizers.amp",
    "paddle_tpu.distributed.fleet.meta_optimizers.asp",
    "paddle_tpu.distributed.fleet.meta_optimizers.dgc",
    "paddle_tpu.distributed.fleet.meta_optimizers.fp16_allreduce",
    "paddle_tpu.distributed.fleet.meta_optimizers.gradient_merge",
    "paddle_tpu.distributed.fleet.meta_optimizers.localsgd",
    "paddle_tpu.distributed.fleet.meta_optimizers.recompute",
    "paddle_tpu.distributed.fleet.meta_optimizers.sharding",
    "paddle_tpu.distributed.fleet.meta_optimizers.strategy_compiler",
    # the smaller modules: quantization, ONNX export, linalg, the op tail,
    # text, incubate's own ops and its custom C ops
    "paddle_tpu.quantization", "paddle_tpu.ops.misc_tail",
    "paddle_tpu.linalg", "paddle_tpu.text", "paddle_tpu.incubate",
    "paddle_tpu.incubate.custom_op", "paddle_tpu.onnx",
    "paddle_tpu.onnx._proto",
    # the static graph: Program and Executor, the passes, the transpiler
    # and the fleet 1.x facade, control flow, dy2static, TracedLayer and
    # the fleet's recompute
    "paddle_tpu.static", "paddle_tpu.static.program",
    "paddle_tpu.static.passes", "paddle_tpu.static.transpiler",
    "paddle_tpu.incubate.fleet", "paddle_tpu.nn.control_flow",
    "paddle_tpu.jit.dy2static", "paddle_tpu.jit.traced_layer",
    "paddle_tpu.distributed.fleet.utils.recompute"}
PORTED_CLASSES = {
    "paddle_tpu.optimizer.optimizer": {
        "Optimizer", "Adam", "AdamW", "SGD", "Momentum", "Adagrad",
        "RMSProp", "Adadelta", "Adamax", "Lamb", "Lars", "DecayedAdagrad",
        "ProximalGD", "ProximalAdagrad", "Ftrl", "Dpsgd"},
    "paddle_tpu.nn.layer.layers": {"Layer"},
    # the package's own flops (hapi's)
    "paddle_tpu": {"flops"}}

NOT_PORTED = {
    # the reference's compiled-program introspection (XLA HLO, memory and
    # collective analyses): ROADMAP item 18
    "paddle_tpu.jit.StaticFunction.code",
    "paddle_tpu.jit.StaticFunction.collective_stats",
    "paddle_tpu.jit.StaticFunction.concrete_program",
    "paddle_tpu.jit.StaticFunction.export_collective_bytes",
    "paddle_tpu.jit.StaticFunction.export_overlap_stats",
    "paddle_tpu.jit.StaticFunction.hlo_text",
    "paddle_tpu.jit.StaticFunction.overlap_stats",
    "paddle_tpu.jit.StaticFunction.schedulable_stats",
    "paddle_tpu.jit.StaticFunction.traced_memory_stats",
    "paddle_tpu.jit.StaticFunction.verify",
    "paddle_tpu.jit.StaticFunction.xla_flags",
    # memory attribution that reads XLA HLO or compiles a recorded
    # program's twin (with traced_memory_stats above): ROADMAP item 18
    "paddle_tpu.observability.memory.top_buffers",
    "paddle_tpu.observability.memory.compile_program_twin",
    "paddle_tpu.observability.memory.attribute_program",
    # the static analyzer's verification of a Program (the reference's
    # analysis.verify, which reads its op records): ROADMAP item 18
    "paddle_tpu.static.Program.verify",
    # the reference's device hop between pipeline stages (jax.device_put);
    # the port's stages exchange point to point
    "paddle_tpu.distributed.p2p_transfer",
    # the batch's GSPMD PartitionSpec; a port rank takes its slice instead
    "paddle_tpu.DataParallel.batch_pspec",
    "paddle_tpu.distributed.DataParallel.batch_pspec",
}
# Names under a module that re-export a ported one's, by prefix: held back
# (absent under the port) until their module lands, then present as the
# port's own. (prefix: (the item that ports the module, whether it landed))
REEXPORTS = {
    # the reference's Tensor class as metric.Tensor: the metric module
    # landed with the high-level training loop
    "paddle_tpu.metric.Tensor": ("ROADMAP item 17", True),
}
NOT_PORTED_REEXPORTS = {p: item for p, (item, landed) in REEXPORTS.items()
                        if not landed}


def _held_back(name):
    return any(name == p or name.startswith(p + ".")
               for p in NOT_PORTED_REEXPORTS)


def _get(root, name):
    parts = name.split(".")
    parts[0] = root
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr, None)
            if obj is None:
                return None
        return obj
    return None


def _in_scope(name):
    ref = _get("paddle_tpu", name)
    if ref is None:
        return False
    if not (isinstance(ref, type) or (callable(ref) and "." not in getattr(
            ref, "__qualname__", "."))):
        ref = _get("paddle_tpu", name.rsplit(".", 1)[0])  # a member
    module = getattr(ref, "__module__", None)
    return (module in PORTED_MODULES or getattr(ref, "__name__", None)
            in PORTED_CLASSES.get(module, ()))


def _spec_names():
    return [line.split()[0] for line in (ROOT / "API.spec").read_text()
            .splitlines() if line.strip() and not line.startswith("#")]


def test_every_name_of_a_ported_module_resolves():
    scope = [n for n in _spec_names() if _in_scope(n)]
    missing = sorted(n for n in scope if n not in NOT_PORTED
                     and not _held_back(n)
                     and _get("paddle_tpu_torch", n) is None)
    listed_but_present = sorted(n for n in NOT_PORTED
                                if _get("paddle_tpu_torch", n) is not None)
    assert len(scope) > 250
    assert missing == []
    assert listed_but_present == []
    assert NOT_PORTED <= set(scope)


@pytest.mark.parametrize("prefix", sorted(REEXPORTS))
def test_reexports_of_unported_modules_stay_absent(prefix):
    """Absent while their module waits; once it lands, every name resolves
    to the port's own object (``metric.Tensor`` is the port's ``Tensor``)."""
    names = [n for n in _spec_names()
             if n == prefix or n.startswith(prefix + ".")]
    assert names and all(_get("paddle_tpu", n) is not None for n in names)
    present = [n for n in names if _get("paddle_tpu_torch", n) is not None]
    if prefix in NOT_PORTED_REEXPORTS:
        assert present == []
    else:
        assert present == names
        ref = _get("paddle_tpu", prefix)
        port = _get("paddle_tpu_torch", prefix)
        assert port is _get("paddle_tpu_torch",
                            f"{ref.__module__}.{ref.__name__}")


def test_bench_model_import_works_against_the_port():
    line = next(l.strip() for l in (ROOT / "bench.py").read_text()
                .splitlines() if re.match(r"\s*from paddle_tpu\.models "
                                          r"import", l))
    namespace = {}
    exec(line.replace("paddle_tpu", "paddle_tpu_torch", 1), namespace)
    assert {"BertConfig", "BertForPretraining",
            "synthetic_mlm_batch"} <= set(namespace)
    assert namespace["BertConfig"] is paddle_tpu_torch.models.BertConfig


def test_top_level_modules():
    for name in ("models", "serving", "distributed", "recompute", "jit",
                 "optimizer", "amp", "nn", "vision", "io", "hapi", "metric"):
        assert isinstance(getattr(paddle_tpu_torch, name), type(importlib))


def test_to_tensor_places_data_on_the_card_unless_asked():
    t = paddle_tpu_torch.to_tensor(np.arange(6, dtype="int32").reshape(2, 3),
                                   place="cpu")
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    f = paddle_tpu_torch.to_tensor([1.5, 2.5], dtype="bfloat16", place="cpu",
                                   stop_gradient=False)
    assert f.dtype == torch.bfloat16 and f.requires_grad
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            paddle_tpu_torch.to_tensor([1, 2])


def test_to_static_takes_the_reference_signature():
    from paddle_tpu_torch import jit
    step = jit.to_static(lambda x: x * 2, xla_flags="latency-hiding",
                         donate_state=False)
    assert torch.equal(step(torch.ones(2)), torch.full((2,), 2.0))
