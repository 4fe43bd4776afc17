"""ONNX export (counterpart: ``paddle_tpu/onnx/__init__.py``; the reference
framework's `python/paddle/onnx/export.py`, which hands a ProgramDesc to
paddle2onnx).

The layer's eval forward is exported with ``torch.export`` at the traced
sizes, decomposed to core ATen operators and mapped onto opset-13 ONNX
operators (``_export.py``); the file is written by the reference's
self-contained protobuf wire-format writer (``_proto.py``), so no ``onnx``
package is needed. ``jit.save``'s artifact stays the native serving format
(batch-polymorphic).
"""
__all__ = ["export", "read_model"]

from ._export import UnsupportedPrimitive  # noqa: F401,E402
from ._proto import read_model  # noqa: F401,E402  (verification reader)


def _fixed(shape):
    return [1 if d is None or d == -1 else int(d) for d in shape]


def export(layer, path, input_spec=None, opset_version=13, **configs):
    """Write ``<path>.onnx`` (``path`` as is when it ends in ``.onnx``)
    and return its path.

    Shapes are exported fixed at the traced sizes (None dims trace as 1):
    the shape constants of the trace are baked into the nodes, so a
    symbolic batch dim would be a contract they cannot honour. Export once
    per batch size, or serve ``jit.save``'s artifact. ``opset_version``
    below 13 raises; an operator with no mapping raises
    ``UnsupportedPrimitive`` naming it."""
    import torch

    from ..core.dtype import convert_dtype
    from ..jit.to_static import InputSpec
    from . import _export as E
    from . import _proto as P

    if opset_version < 13:
        raise ValueError(
            f"opset_version {opset_version} < 13: the emitted op "
            "signatures (Slice/ReduceSum with axes inputs) are opset-13 "
            "forms")
    if input_spec is None:
        raise ValueError("paddle_tpu_torch.onnx.export requires input_spec")
    specs = []
    for i, s in enumerate(input_spec):
        if isinstance(s, InputSpec):
            specs.append((s.name or f"x{i}", _fixed(s.shape),
                          convert_dtype(s.dtype) or torch.float32))
        else:  # a template tensor
            specs.append((f"x{i}", _fixed(s.shape), s.dtype))

    state = list(layer.parameters()) + list(layer.buffers())
    device = state[0].device if state else torch.device("cpu")
    examples = tuple(torch.zeros(shape, dtype=dtype, device=device)
                     for _, shape, dtype in specs)
    modes = [(m, m.training) for m in layer.modules()]
    layer.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(layer, examples)
            # an operator of another namespace (a custom op) survives any
            # decomposition: refused before decomposing
            foreign = [n for n in E.unsupported_ops(program.graph)
                       if not n.startswith("aten::")]
            if foreign:
                raise E.UnsupportedPrimitive(
                    "no ONNX mapping for " + ", ".join(map(repr, foreign)))
            program = program.run_decompositions()
    finally:
        for m, mode in modes:
            m.training = mode

    in_names = [name for name, _, _ in specs]
    g, out_names, out_specs = E.convert_program(program, in_names)
    inputs = [P.value_info(name, E._DTYPE[dtype], shape)
              for name, shape, dtype in specs]
    outputs = [P.value_info(name, E._DTYPE[dtype], shape)
               for name, (shape, dtype) in zip(out_names, out_specs)]
    g.prune(out_names)
    nodes, inits = g.serialize()
    graph = P.graph_proto(nodes, "paddle_tpu_torch_graph", inits, inputs,
                          outputs)
    model = P.model_proto(graph, opset=opset_version,
                          producer="paddle_tpu_torch")
    out_path = path if path.endswith(".onnx") else path + ".onnx"
    with open(out_path, "wb") as f:
        f.write(model)
    return out_path

