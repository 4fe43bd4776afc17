"""The port stands alone: ``paddle_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the reference package ``paddle_tpu``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    __import__(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(len([n for n in sys.modules if n.startswith("paddle_tpu_torch")]))
print(bad)
print(sorted(n for n in sys.modules if n.count(".") == 1
             and n.startswith("paddle_tpu_torch.")))
print(sorted(n for n in sys.modules if n.startswith("paddle_tpu_torch.")))
sys.exit(1 if bad else 0)
"""
# the training slice's modules, besides the served slice's
_TRAINING = ("amp", "optimizer", "observability", "regularizer")
# BERT and the k-step program
_BERT_KSTEP = ("paddle_tpu_torch.models.bert", "paddle_tpu_torch.jit",
               "paddle_tpu_torch.jit.to_static")
# data parallelism (ZeRO) and recompute
_DP_RECOMPUTE = ("paddle_tpu_torch.distributed",
                 "paddle_tpu_torch.distributed.parallel_env",
                 "paddle_tpu_torch.distributed.collective",
                 "paddle_tpu_torch.distributed.bucketing",
                 "paddle_tpu_torch.optimizer.zero", "paddle_tpu_torch.recompute")
# step checkpoints and the modules they stand on
_CHECKPOINT = ("paddle_tpu_torch.checkpoint", "paddle_tpu_torch.checkpoint.core",
               "paddle_tpu_torch.checkpoint.state",
               "paddle_tpu_torch.checkpoint.multihost",
               "paddle_tpu_torch.amp.grad_scaler",
               "paddle_tpu_torch.serialization",
               "paddle_tpu_torch.incubate.auto_checkpoint",
               "paddle_tpu_torch.monitor", "paddle_tpu_torch.testing.faults",
               "paddle_tpu_torch.observability.tracing",
               "paddle_tpu_torch.observability.runlog",
               "paddle_tpu_torch.distributed.fleet.utils.fs")

# hybrid parallelism: the fleet, its meta-parallel layers, the parallel
# primitives and MoE
_HYBRID = ("paddle_tpu_torch.distributed.parallel",
           "paddle_tpu_torch.distributed.fleet",
           "paddle_tpu_torch.distributed.fleet.base.topology",
           "paddle_tpu_torch.distributed.fleet.base.distributed_strategy",
           "paddle_tpu_torch.distributed.fleet.base.fleet_base",
           "paddle_tpu_torch.distributed.fleet.meta_parallel",
           "paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers",
           "paddle_tpu_torch.distributed.fleet.meta_parallel.random",
           "paddle_tpu_torch.distributed.fleet.meta_parallel.tensor_parallel",
           "paddle_tpu_torch.distributed.fleet.meta_parallel"
           ".sharding_parallel",
           "paddle_tpu_torch.distributed.fleet.meta_parallel.pp_layers",
           "paddle_tpu_torch.distributed.fleet.meta_parallel"
           ".pipeline_parallel",
           "paddle_tpu_torch.parallel", "paddle_tpu_torch.parallel.pipeline",
           "paddle_tpu_torch.parallel.ring_attention",
           "paddle_tpu_torch.parallel.moe", "paddle_tpu_torch.incubate.moe")

# serving from a saved artifact
_ARTIFACT = ("paddle_tpu_torch.jit.io", "paddle_tpu_torch.jit.export",
             "paddle_tpu_torch.inference", "paddle_tpu_torch.serving.engine",
             "paddle_tpu_torch.serving.passes",
             "paddle_tpu_torch.core.op_version",
             "paddle_tpu_torch.observability.export")


# runtime services: the op seam, the profiler, the flight recorder, memory
# accounting, the gate, lockwatch, the pod with elastic restart
_RUNTIME = ("paddle_tpu_torch.core.dispatch", "paddle_tpu_torch.core.flags",
            "paddle_tpu_torch.profiler", "paddle_tpu_torch._lockwatch",
            "paddle_tpu_torch.analysis", "paddle_tpu_torch.analysis.lockwatch",
            "paddle_tpu_torch.observability.flight",
            "paddle_tpu_torch.observability.memory",
            "paddle_tpu_torch.observability.gate",
            "paddle_tpu_torch.observability.step",
            "paddle_tpu_torch.distributed.restart",
            "paddle_tpu_torch.distributed.spawn",
            "paddle_tpu_torch.distributed.launch",
            "paddle_tpu_torch.distributed.pod",
            "paddle_tpu_torch.distributed.fleet.elastic",
            "paddle_tpu_torch.testing.virtual_pod",
            "paddle_tpu_torch.testing.pod_fixture")


# CTR and the parameter server: the native service's binding, the PS
# stack, the fleet's role makers and datasets, the CTR model, the fixture
_PS = ("paddle_tpu_torch._native", "paddle_tpu_torch.distributed.ps",
       "paddle_tpu_torch.distributed.ps.client",
       "paddle_tpu_torch.distributed.ps.server",
       "paddle_tpu_torch.distributed.ps.retry",
       "paddle_tpu_torch.distributed.ps.communicator",
       "paddle_tpu_torch.distributed.ps.embedding",
       "paddle_tpu_torch.distributed.ps.hbm_cache",
       "paddle_tpu_torch.distributed.ps.async_cache",
       "paddle_tpu_torch.distributed.ps.trainer",
       "paddle_tpu_torch.distributed.fleet.base.role_maker",
       "paddle_tpu_torch.distributed.fleet.dataset",
       "paddle_tpu_torch.models.ctr", "paddle_tpu_torch.testing.ps_fixture")


def _forbidden(name):
    return name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")


def test_import_pulls_in_no_jax_and_no_reference():
    # a fresh interpreter: this process already holds jax (conftest)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules, bad, top, every = res.stdout.split("\n")[:4]
    assert int(n_modules) >= 20 and bad == "[]"
    for name in _TRAINING:
        assert f"'paddle_tpu_torch.{name}'" in top, (name, top)
    for name in _BERT_KSTEP + _DP_RECOMPUTE + _CHECKPOINT + _HYBRID \
            + _ARTIFACT + _RUNTIME + _PS:
        assert f"'{name}'" in every, (name, every)


def test_package_import_brings_its_top_level_modules():
    """``import paddle_tpu_torch`` alone (no walk) imports the modules the
    package's top level names, the new ones included, still without JAX."""
    probe = ("import sys, paddle_tpu_torch as pt\n"
             "print(all(hasattr(pt, n) for n in ('models', 'serving', "
             "'distributed', 'recompute', 'to_tensor', 'checkpoint', "
             "'save', 'load', 'incubate', 'parallel', 'inference', "
             "'profiler', 'observability', 'testing', 'call_op')))\n"
             "print(sorted(n for n in sys.modules if n.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[:2] == ["True", "[]"], res.stdout


def test_no_file_imports_jax_or_reference():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert len(files) > 20
    assert not offenders, offenders


def test_imports_build_no_native_library():
    """Importing every module of the package (the PS stack included)
    neither builds nor loads the native PS service: it builds at first
    use."""
    probe = ("import pkgutil, paddle_tpu_torch\n"
             "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "
             "'paddle_tpu_torch.'):\n"
             "    __import__(m.name)\n"
             "from paddle_tpu_torch import _native\n"
             "print(_native.loaded(), _native.build_seconds)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "None"], res.stdout
