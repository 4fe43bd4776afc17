"""Program export: the process-independent model artifact (counterpart:
``paddle_tpu/jit/export.py``).

The reference writes its forward as StableHLO; the port writes it as a
``torch.export`` program. The forward is traced as a pure function of
``(params_list, *inputs)`` (``torch.func.functional_call`` over the
layer's parameters and buffers), so the program holds no weights and a
process that serves it needs neither the model's class nor its module.

Artifact layout (the reference's two files):

- ``{prefix}.pdmodel``: a zip of ``program.pt2`` (``torch.export.save``
  bytes, without example inputs) and ``meta.json`` (format version, op
  versions, parameter names and dtypes, input names and specs, output
  names, ``"backend": "torch"``);
- ``{prefix}.pdiparams``: an npz of ``p0..pN`` in the meta's parameter
  order. numpy has no bfloat16, so a bfloat16 parameter is stored as its
  uint16 bit pattern and the meta's dtype restores it.

Batch polymorphism: ``InputSpec`` dims that are None or -1 become
``torch.export.Dim`` s. Axis 0 of every input shares one ``Dim("batch")``,
bounded to ``1..BATCH_MAX`` (so the flash gate's grid check, B x heads <=
65535, stays decided for up to 63 heads); other dynamic dims get a
``Dim`` each.

The two packages' artifacts do not cross: torch cannot run StableHLO, so a
``.pdmodel`` holding the reference's ``program.bin`` raises
:class:`ForeignArtifactError`. A program exported on one device serves on
the other (``torch.export.passes.move_to_device_pass`` moves the devices
baked into the graph, such as a causal mask's).
"""
import io as _io
import json
import os
import zipfile

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.export.passes import move_to_device_pass

from ..core import op_version
from ..core.device import resolve_device
from ..core.dtype import convert_dtype
# the exported programs call the package's operators: registered before
# any program loads
from ..kernels import flash_attention as _flash  # noqa: F401

__all__ = ["export_callable", "write_artifact", "save_exported",
           "has_artifact", "ServedProgram", "ForeignArtifactError",
           "BATCH_MAX"]

_FORMAT_VERSION = 1
_SUFFIX_PARAMS = ".pdiparams"
_SUFFIX_MODEL = ".pdmodel"
_PROGRAM = "program.pt2"
_FOREIGN_PROGRAM = "program.bin"  # the reference's StableHLO
BATCH_MAX = 1024
_TRACE_BATCH = 2  # the example batch the program is traced at


class ForeignArtifactError(ValueError):
    """A ``.pdmodel`` written by the JAX package (StableHLO)."""


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _dynamic(d):
    return d is None or (isinstance(d, int) and d < 0)


def _examples(input_specs):
    """InputSpec / (shape, dtype[, name]) / tensor / array list -> example
    tensors, their ``dynamic_shapes`` entries, names and meta specs."""
    from .to_static import InputSpec
    batch = torch.export.Dim("batch", min=1, max=BATCH_MAX)
    examples, dynamic, names, specs = [], [], [], []
    n_dyn = 0
    for i, spec in enumerate(input_specs):
        if isinstance(spec, (torch.Tensor, np.ndarray)):
            t = spec.detach() if isinstance(spec, torch.Tensor) \
                else torch.from_numpy(np.asarray(spec))
            shape, dtype = list(t.shape), t.dtype
            name = None
        else:
            if not isinstance(spec, InputSpec):
                spec = InputSpec(spec[0], spec[1] if len(spec) > 1
                                 else "float32",
                                 spec[2] if len(spec) > 2 else None)
            shape = [None if _dynamic(d) else int(d) for d in spec.shape]
            dtype = convert_dtype(spec.dtype) or torch.float32
            name = spec.name
        dims = {}
        for ax, d in enumerate(shape):
            if d is None:
                if ax == 0:
                    dims[ax] = batch
                else:
                    dims[ax] = torch.export.Dim(f"dyn{n_dyn}", min=1)
                    n_dyn += 1
        size = [_TRACE_BATCH if d is None else d for d in shape]
        examples.append(torch.zeros(size, dtype=dtype))
        dynamic.append(dims or None)
        names.append(name or f"x{i}")
        specs.append({"shape": shape, "dtype": _dtype_name(dtype)})
    return examples, dynamic, names, specs


def _module_of(fn):
    if isinstance(fn, torch.nn.Module):
        return fn
    owner = getattr(fn, "__self__", None)
    if isinstance(owner, torch.nn.Module) and getattr(
            fn, "__name__", None) == "forward":
        return owner
    raise TypeError("export_callable takes a layer or its bound forward, "
                    f"got {fn!r}")


class _Pure(torch.nn.Module):
    """``forward(params, *inputs)``: the layer's forward with ``params``
    in place of its parameters and buffers, outputs flattened to a tuple.
    The layer is held outside the module tree, so the program lifts no
    weight of its own."""

    def __init__(self, layer, names, out_info):
        super().__init__()
        self.__dict__["_layer"] = layer
        self._names = list(names)
        self._out_info = out_info

    def forward(self, params, *inputs):
        out = torch.func.functional_call(
            self._layer, dict(zip(self._names, params)), tuple(inputs))
        leaves = pytree.tree_leaves(out)
        self._out_info["n"] = len(leaves)
        return tuple(leaves)


def export_callable(fn, state_items, input_specs, output_names=None):
    """Export ``fn`` (a layer or its bound ``forward``) as a
    ``torch.export`` program of ``(params_list, *inputs)``.

    ``state_items``: ``[(name, tensor)]``, the parameters and buffers the
    forward reads, by their names in the layer (they become the leading
    ``params`` argument). Returns (ExportedProgram, params, meta)."""
    layer = _module_of(fn)
    names = [n for n, _ in state_items]
    params = [t.detach() for _, t in state_items]
    device = params[0].device if params else torch.device("cpu")
    examples, dynamic, input_names, specs = _examples(input_specs)
    examples = [x.to(device) for x in examples]
    out_info = {}
    with torch.no_grad():
        program = torch.export.export(
            _Pure(layer, names, out_info), (params, *examples),
            dynamic_shapes=([None] * len(params), tuple(dynamic)))
    n_out = out_info.get("n", 1)
    if output_names is None:
        output_names = [f"output_{i}" for i in range(n_out)]
    meta = {
        "format_version": _FORMAT_VERSION,
        "backend": "torch",
        "torch_version": torch.__version__,
        "op_versions": op_version.snapshot(),
        "param_names": names,
        "param_dtypes": [_dtype_name(p.dtype) for p in params],
        "input_names": input_names,
        "input_specs": specs,
        "output_names": list(output_names)[:n_out],
    }
    return program, params, meta


def _to_npz_array(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_npz_array(a, dtype_name):
    dtype = convert_dtype(dtype_name)
    a = np.asarray(a).copy(order="C")  # a 0-d array (a scale) stays 0-d
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a).to(dtype)


def write_artifact(path_prefix, program, params, meta):
    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    program.example_inputs = None  # the program holds no tensor of data
    buf = _io.BytesIO()
    torch.export.save(program, buf)
    with zipfile.ZipFile(path_prefix + _SUFFIX_MODEL, "w") as z:
        z.writestr(_PROGRAM, buf.getvalue())
        z.writestr("meta.json", json.dumps(meta))
    buf = _io.BytesIO()
    np.savez(buf, **{f"p{i}": _to_npz_array(p) for i, p in enumerate(params)})
    with open(path_prefix + _SUFFIX_PARAMS, "wb") as f:
        f.write(buf.getvalue())


def save_exported(path_prefix, fn, state_items, input_specs,
                  output_names=None):
    program, params, meta = export_callable(fn, state_items, input_specs,
                                            output_names)
    write_artifact(path_prefix, program, params, meta)


def _members(path):
    try:
        with zipfile.ZipFile(path) as z:
            return z.namelist()
    except zipfile.BadZipFile:
        return []  # a pickled layer (jit.save's same-codebase file)


def has_artifact(path_prefix, params_path=None):
    """True when ``path_prefix`` names an exported artifact pair. A
    reference (StableHLO) ``.pdmodel`` counts, so that loading it raises
    :class:`ForeignArtifactError` rather than falling through to the
    pickle path."""
    p = path_prefix + _SUFFIX_MODEL
    params = params_path or (path_prefix + _SUFFIX_PARAMS)
    if not (os.path.exists(p) and os.path.exists(params)):
        return False
    names = _members(p)
    return _PROGRAM in names or _FOREIGN_PROGRAM in names


class ServedProgram:
    """A loaded model artifact: the exported program and its parameters on
    ``device`` (default ``cuda``; ``"cpu"`` on request). Serves without
    the model's class (reference: AnalysisPredictor::Run, which loads
    ``__model__`` and runs it)."""

    def __init__(self, path_prefix, params_path=None, device=None):
        model = path_prefix + _SUFFIX_MODEL
        with zipfile.ZipFile(model) as z:
            names = z.namelist()
            if _PROGRAM not in names:
                raise ForeignArtifactError(
                    f"{model} is not a torch.export artifact"
                    + (" (it holds the JAX package's StableHLO program, "
                       "which torch cannot run; save the model with "
                       "paddle_tpu_torch.jit.save instead)"
                       if _FOREIGN_PROGRAM in names else ""))
            blob = z.read(_PROGRAM)
            self.meta = json.loads(z.read("meta.json"))
        op_version.check_compatible(self.meta.get("op_versions"))
        params_file = params_path or (path_prefix + _SUFFIX_PARAMS)
        if not os.path.exists(params_file):
            raise FileNotFoundError(
                f"params file not found: {params_file} (model: {model})")
        self.device = resolve_device(device)
        data = np.load(params_file)
        self.params = [
            _from_npz_array(data[f"p{i}"], dt).to(self.device)
            for i, dt in enumerate(self.meta["param_dtypes"])]
        program = torch.export.load(_io.BytesIO(blob))
        self._program = move_to_device_pass(program, str(self.device))
        self._module = self._program.module()

    @property
    def input_names(self):
        return list(self.meta["input_names"])

    @property
    def output_names(self):
        return list(self.meta["output_names"])

    @property
    def input_specs(self):
        """``[(shape with None for dynamic dims, torch dtype)]``."""
        return [(tuple(s["shape"]), convert_dtype(s["dtype"]))
                for s in self.meta["input_specs"]]

    def graph_module(self):
        """A fresh callable ``(params, *inputs) -> tuple(outputs)`` of the
        program (``ExportedProgram.module()``), for passes that rewrite
        its graph."""
        return self._program.module()

    def feeds(self, inputs):
        """Tensors of the declared dtypes on the program's device."""
        out = []
        for x, (_shape, dtype) in zip(inputs, self.input_specs):
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.asarray(x))
            out.append(t.to(device=self.device, dtype=dtype))
        return out

    def __call__(self, *inputs):
        with torch.inference_mode():
            return list(self._module(self.params, *self.feeds(inputs)))

    def state_dict(self):
        return dict(zip(self.meta["param_names"], self.params))
