"""Inference API (counterpart: ``paddle_tpu/inference``; the reference's
``paddle/fluid/inference/api/analysis_predictor.cc`` and
``python/paddle/inference/``).

The Predictor serves the ``.pdmodel``/``.pdiparams`` pair that
``jit.save(..., input_spec=...)`` writes: it loads the exported
``torch.export`` program and its parameters (``jit.export.ServedProgram``)
and runs it, never needing the model's Python class (as
``analysis_predictor.cc``'s Run serves from ``__model__`` alone). A
same-codebase artifact (the pickled layer) serves through ``jit.load``.

The device follows the package's rule: ``cuda`` unless the config asks for
the CPU (``Config.disable_gpu()``); ``enable_use_gpu(memory_pool_mb,
device_id)`` selects ``cuda:<device_id>``. ``inference.Tensor`` is the
package's ``Tensor`` (``core.tensor``), as the reference re-exports its
own.
"""
import re
import warnings

import numpy as np
import torch

from ..core.tensor import Tensor  # noqa: F401

__all__ = ["Config", "Predictor", "create_predictor", "Tensor"]


class Config:
    """AnalysisConfig's counterpart: the artifact's paths, the device and
    the serving engine's settings. The IR and memory knobs are recorded."""

    def __init__(self, model_path=None, params_path=None):
        self.model_path = model_path
        self.params_path = params_path
        self._device = None  # the package's default: cuda
        self._ir_optim = True
        self._memory_optim = False
        self._cpu_math_threads = 1
        self._serving_cfg = None  # enable_serving_engine kwargs

    def enable_serving_engine(self, **engine_kwargs):
        """Route run() through a ``serving.Engine`` (one CUDA graph per
        bucket captured at load on the card, concurrent dynamic batching,
        SLO telemetry). kwargs go to ``serving.Engine`` (``bucket_ladder``,
        ``batch_timeout_ms``, ``outputs``, ...). Each Predictor built from
        this config owns one engine, released by ``Predictor.close()``;
        engines are thread-safe, so share one predictor across caller
        threads and their requests coalesce into shared device steps."""
        self._serving_cfg = dict(engine_kwargs)
        return self

    def prog_file(self):
        return self.model_path

    def params_file(self):
        return self.params_path

    def enable_use_gpu(self, memory_pool_mb=100, device_id=0):
        """Serve on ``cuda:<device_id>``. ``memory_pool_mb`` is recorded:
        torch's caching allocator sizes its own pool."""
        self._device = torch.device("cuda", int(device_id))
        self._memory_pool_mb = memory_pool_mb

    def disable_gpu(self):
        """Serve on the CPU."""
        self._device = torch.device("cpu")

    def switch_ir_optim(self, flag=True):
        """Recorded. The exported program runs as recorded; there is no
        separate IR-pass pipeline to switch, so turning it off warns."""
        if not flag:
            warnings.warn(
                "switch_ir_optim(False) has no effect: the exported "
                "program runs as recorded (there is no separate IR-pass "
                "pipeline to disable)", stacklevel=2)
        self._ir_optim = flag

    def enable_memory_optim(self):
        """Recorded only: the caching allocator (and, behind the serving
        engine, the shared CUDA-graph pool) already reuses memory."""
        self._memory_optim = True

    def set_cpu_math_library_num_threads(self, n):
        """Recorded only: torch's intra-op thread pool is process-global
        (``torch.set_num_threads``)."""
        if n != 1:
            warnings.warn(
                "set_cpu_math_library_num_threads is recorded but not "
                "applied: torch's thread pool is process-global (call "
                "torch.set_num_threads instead)", stacklevel=2)
        self._cpu_math_threads = n


class Predictor:
    """Serves a saved artifact. Handle-based I/O as the reference's
    ZeroCopyTensor flow: get_input_handle().copy_from_cpu(); run();
    get_output_handle().copy_to_cpu(). Outputs are numpy arrays
    (bfloat16 widened to float32)."""

    def __init__(self, config):
        from ..jit.export import ServedProgram, has_artifact
        path = config.model_path
        if path and path.endswith(".pdmodel"):
            path = path[:-len(".pdmodel")]
        self._layer = None
        if has_artifact(path, params_path=config.params_path):
            self._served = ServedProgram(path, params_path=config.params_path,
                                         device=config._device)
            self._input_names = self._served.input_names
            self._output_names = self._served.output_names
            self._runner = self._served
        else:  # same-codebase artifact
            from ..jit.io import load as jit_load
            layer = jit_load(path)
            self._served = None
            self._layer = layer
            self._input_names = []
            self._output_names = []
            device = next((p.device for p in layer._layer.parameters()),
                          torch.device("cpu"))
            self._runner = lambda *xs: _as_list(layer(
                *[torch.from_numpy(np.asarray(x)).to(device) for x in xs]))
        self._inputs = {}
        self._declared_shapes = {}  # name -> reshape()-declared shape
        self._outputs = None
        self._engine = None
        if config._serving_cfg is not None:
            self._engine = self.as_engine(**config._serving_cfg)
            # the engine decides the served surface: an outputs= subset
            # must show here, or output handles would index wrong results
            self._input_names = self._engine.input_names
            self._output_names = self._engine.output_names

    def as_engine(self, **engine_kwargs):
        """A ``serving.Engine`` over this predictor's loaded model.
        Same-codebase artifacts record no input specs: pass
        ``input_specs=[InputSpec(...)]`` for those."""
        from ..serving import Engine
        specs = engine_kwargs.pop("input_specs", None)
        if self._served is not None:
            if specs is not None:
                warnings.warn(
                    "as_engine(input_specs=...) ignored: this exported "
                    "artifact records its own input specs", stacklevel=2)
            return Engine(self._served, **engine_kwargs)
        if specs is None:
            raise ValueError(
                "same-codebase artifacts carry no input specs; pass "
                "as_engine(input_specs=[InputSpec([None, ...], dtype)]) "
                "(exported artifacts record them — re-save with "
                "jit.save(..., input_spec=...))")
        layer = self._layer._layer
        device = next((p.device for p in layer.parameters()), None)
        engine_kwargs.setdefault("device", device)
        return Engine.from_layer(layer, specs, **engine_kwargs)

    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name):
        return _IOHandle(self._inputs, name, self._declared_shapes)

    def get_output_names(self):
        if self._output_names:
            return list(self._output_names)
        # same-codebase artifact before a run: one output at least
        return ["output_0"] if self._outputs is None else [
            f"output_{i}" for i in range(len(self._outputs))]

    def get_output_handle(self, name):
        valid = self.get_output_names()
        if self._output_names:
            if name in self._output_names:
                return _OutHandle(self, self._output_names.index(name))
            # positional "output_<i>" stays accepted against artifacts
            # with custom names, unless a real name has that form (where
            # the alias would shadow another output)
            m = re.fullmatch(r"output_(\d+)", name)
            if m and int(m.group(1)) < len(self._output_names) and \
                    not any(re.fullmatch(r"output_\d+", n)
                            for n in self._output_names):
                return _OutHandle(self, int(m.group(1)))
            raise ValueError(
                f"unknown output {name!r}; valid output names: {valid}")
        m = re.fullmatch(r"output_(\d+)", name)
        if m is None or (self._outputs is not None
                         and int(m.group(1)) >= len(self._outputs)):
            raise ValueError(
                f"unknown output {name!r}; valid output names: {valid}")
        return _OutHandle(self, int(m.group(1)))

    def run(self, inputs=None):
        if inputs is None:
            order = self._input_names or sorted(self._inputs)
            missing = [n for n in order if n not in self._inputs]
            if missing:
                raise ValueError(
                    f"missing inputs {missing}; expected {order}")
            inputs = [self._inputs[k] for k in order]
        if self._engine is not None:
            self._outputs = self._engine.predict(*inputs)
            return self._outputs
        outs = self._runner(*[np.asarray(x) for x in inputs])
        self._outputs = [_to_numpy(o) for o in _as_list(outs)]
        return self._outputs

    def close(self):
        """Release the serving engine (its thread and graphs), if one is
        attached. Long-lived processes that churn Predictors call this or
        use the Predictor as a context manager."""
        if self._engine is not None:
            self._engine.close()
            self._engine = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _as_list(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _to_numpy(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


class _IOHandle:
    def __init__(self, store, name, declared):
        self.store = store
        self.name = name
        # shared with the predictor: a later handle sees shapes declared
        # through an earlier one
        self.declared = declared

    def copy_from_cpu(self, arr):
        a = np.asarray(arr)
        want = self.declared.get(self.name)
        if want is not None and not _shape_matches(want, a.shape):
            raise ValueError(
                f"input {self.name!r}: fed array shape {tuple(a.shape)} "
                f"does not match the shape {tuple(want)} declared via "
                "reshape(); re-declare or feed a matching array")
        self.store[self.name] = a

    def reshape(self, shape):
        """Declare the shape the next copy_from_cpu must match (the
        reference's ZeroCopyTensor::Reshape sizes the feed buffer; here
        the array carries its storage, so the declaration is enforced).
        -1/None dims are wildcards."""
        self.declared[self.name] = tuple(shape)


def _shape_matches(declared, got):
    if len(declared) != len(got):
        return False
    return all(d in (None, -1) or int(d) == g
               for d, g in zip(declared, got))


class _OutHandle:
    def __init__(self, predictor, idx):
        self.predictor = predictor
        self.idx = idx

    def copy_to_cpu(self):
        return self.predictor._outputs[self.idx]


def create_predictor(config):
    return Predictor(config)
