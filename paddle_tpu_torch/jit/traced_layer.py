"""``TracedLayer`` (counterpart: ``paddle_tpu/jit/traced_layer.py``; the
reference's ``dygraph/jit.py:1136``): a layer's forward traced once into
a program, run again, and saved as an inference model with a chosen
feed/fetch subset.

The program is ``to_static``'s: on the card one CUDA graph per input
signature, on the CPU the eager forward. :meth:`save_inference_model`
writes ``jit.save``'s ``.pdmodel`` pair of the selected inputs and
outputs, the others frozen at their traced values.
"""
from ..core.tensor import Tensor
from ..nn.layer.layers import Layer

__all__ = ["TracedLayer"]


class _FeedFetchWrapper(Layer):
    """The forward over the fed subset of the traced inputs (the rest at
    their traced values), returning the fetched outputs."""

    def __init__(self, inner, examples, feed_idx, fetch_idx):
        super().__init__()
        self.inner = inner
        self._examples = list(examples)
        self._feed_idx = list(feed_idx)
        self._fetch_idx = list(fetch_idx)

    def forward(self, *fed):
        full = list(self._examples)
        for i, t in zip(self._feed_idx, fed):
            full[i] = t
        outs = self.inner(*full)
        flat = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        sel = [flat[i] for i in self._fetch_idx]
        return sel[0] if len(sel) == 1 else tuple(sel)


class TracedLayer:
    """Made by :meth:`trace`, not by its constructor."""

    def __init__(self, layer, static_fn, examples, n_outs):
        self._layer = layer
        self._static = static_fn
        self._examples = examples
        self._n_outs = n_outs

    @staticmethod
    def trace(layer, inputs):
        """``(outputs, traced_layer)``: the outputs of one run of the
        program and the TracedLayer that runs it again."""
        from .to_static import to_static
        if not isinstance(layer, Layer):
            raise TypeError(
                f"TracedLayer.trace expects a Layer, got {type(layer)}")
        if isinstance(inputs, Tensor) or not isinstance(inputs,
                                                        (list, tuple)):
            inputs = [inputs]
        examples = list(inputs)

        def forward(*xs):
            return layer(*xs)
        static_fn = to_static(forward)
        outs = static_fn(*examples)
        n_outs = len(outs) if isinstance(outs, (list, tuple)) else 1
        return outs, TracedLayer(layer, static_fn, examples, n_outs)

    def __call__(self, inputs):
        if isinstance(inputs, Tensor) or not isinstance(inputs,
                                                        (list, tuple)):
            inputs = [inputs]
        return self._static(*inputs)

    def set_strategy(self, build_strategy=None, exec_strategy=None):
        """Stored for the reference's signature: a CUDA graph has no build
        or executor strategy to set."""
        self._build_strategy = build_strategy
        self._exec_strategy = exec_strategy

    def save_inference_model(self, path, feed=None, fetch=None, **config):
        """``jit.save``'s artifact of the inputs ``feed`` and outputs
        ``fetch`` (indices; default all). With every input fed, axis 0 of
        each is the artifact's batch axis."""
        from . import io as jit_io
        from .to_static import InputSpec
        feed_idx = (list(feed) if feed is not None
                    else list(range(len(self._examples))))
        fetch_idx = (list(fetch) if fetch is not None
                     else list(range(self._n_outs)))
        for i in feed_idx:
            if not 0 <= i < len(self._examples):
                raise ValueError(
                    f"feed index {i} outside [0, {len(self._examples)})")
        for i in fetch_idx:
            if not 0 <= i < self._n_outs:
                raise ValueError(
                    f"fetch index {i} outside [0, {self._n_outs})")
        wrapper = _FeedFetchWrapper(self._layer, self._examples, feed_idx,
                                    fetch_idx)
        full = len(feed_idx) == len(self._examples)
        specs = []
        for i in feed_idx:
            ex = self._examples[i]
            shape = list(ex.shape)
            if full and shape:
                shape[0] = None
            specs.append(InputSpec(shape, dtype=ex.dtype,
                                   name=f"x{i}"))
        return jit_io.save(wrapper, path, input_spec=specs, **config)
