"""Quantization: QAT (fake-quant training) and PTQ (post-training
calibration) (counterpart: ``paddle_tpu/quantization/__init__.py``; the
reference framework's `python/paddle/fluid/contrib/slim/quantization/`:
`imperative/qat.py`, `post_training_quantization.py` and the fake-quant
ops of `operators/fake_quantize_op.cc`).

``fake_quant`` is a ``torch.autograd.Function``: round to the symmetric
``bits``-bit grid and clip forward, a straight-through gradient inside
``|x| <= scale`` (zero outside, none for the scale). It computes in the
promotion of ``x``'s and the scale's dtypes as JAX promotes them: a bf16
activation against the float32 activation scale gives float32, as in the
reference (torch would keep bf16), and ``F.linear``'s ``auto_cast`` brings
it back to bf16.

The wrappers (``QuantizedLinear``, ``QuantizedConv2D``,
``QuantizedEmbedding``) keep the wrapped layer's parameters under the same
names, so ``state_dict`` names stay the reference's before and after
``quantize``. Their scales are non-persistent buffers on the weight's
device, out of ``state_dict``:

- the activation scale (the reference's Python float) is float64 and
  moves by the reference's moving average in place, ``m * s`` and then
  ``+ (1 - m) * cur`` as two operations (a fused multiply-add would round
  once), with a device flag for the first call, so a QAT step reads no
  scale on the host;
- the output scale is float32 and moves in the output's dtype with the
  momentum rounded to it, as JAX computes it with a weakly typed Python
  float;
- weight scales are computed from the weight at every forward (abs-max, or
  one per output channel with ``channel_wise``).

A dtype change of the layer (``to("bfloat16")``) moves the scale buffers'
device only, never their dtype. QAT is eager, as in the reference (whose
activation scale is read on the host); a frozen model (``freeze``, after
``PTQ`` or ``save_quantized_model``) traces and exports through
``jit.save``. ``PTQ``'s ``percentile`` calibration copies each layer's
activation samples to the host and takes ``np.quantile``, as the reference
does (``torch.quantile`` refuses inputs of more than 2^24 elements).
"""
import json

import numpy as np
import torch

from ..core.dispatch import call_op, unwrap
from ..nn import functional as F
from ..nn.layer.common import Embedding, Linear
from ..nn.layer.conv import Conv2D
from ..nn.layer.layers import Layer

__all__ = [
    "fake_quant", "QuantizedLinear", "QuantizedConv2D",
    "QuantizedEmbedding", "ImperativeQuantAware", "PTQ",
    "quant_post_static", "load_quant_scales",
]


def _fq_dtype(x, scale):
    """The dtype JAX computes ``x / scale`` in: the wider float type."""
    return torch.promote_types(x.dtype, scale.dtype)


def _fake_quant_math(x, scale, qmax):
    dt = _fq_dtype(x, scale)
    s = scale.to(dt) / qmax
    return torch.clamp(torch.round(x.to(dt) / s), -qmax, qmax) * s


class _FakeQuantSTE(torch.autograd.Function):
    """Round-and-clip forward, straight-through backward."""

    @staticmethod
    def forward(ctx, x, scale, qmax):
        ctx.save_for_backward(x, scale)
        return _fake_quant_math(x, scale, qmax)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        # the comparison in the wider of the two dtypes (JAX promotes;
        # torch would round a float32 scale to a bf16 x's dtype)
        wide = torch.promote_types(_fq_dtype(x, scale), torch.float32)
        inside = x.to(wide).abs() <= scale.to(wide)
        return (g * inside.to(g.dtype)).to(x.dtype), None, None


def _fake_quant_ste(x, scale, qmax):
    scale = scale.detach()
    if torch.is_grad_enabled() and x.requires_grad:
        return _FakeQuantSTE.apply(x, scale, qmax)
    return _fake_quant_math(x, scale, qmax)  # no graph: export traces it


def _quantize(x, scale, bits):
    """:func:`fake_quant` over plain tensors (the wrappers' insides)."""
    return _fake_quant_ste(x, scale, float(2 ** (bits - 1) - 1))


def fake_quant(x, scale, bits=8, op_name="fake_quantize"):
    """Simulated symmetric quantization with the STE gradient (reference:
    fake_quantize_op.cc FakeQuantizeAbsMax); a Python ``scale`` is a
    float32 scalar, as in the reference."""
    def f(xv):
        sv = unwrap(scale)
        if not isinstance(sv, torch.Tensor):
            sv = torch.full((), float(scale), dtype=torch.float32,
                            device=xv.device)
        return _quantize(xv, sv, bits)

    return call_op(f, x, op_name=op_name)


def _absmax(x, axis=None, keepdims=False):
    a = torch.abs(x)
    m = torch.amax(a) if axis is None else torch.amax(a, dim=axis,
                                                      keepdim=keepdims)
    return torch.clamp(m, min=1e-8)


def _rounded(v, dtype):
    """The Python float ``v`` rounded to ``dtype`` (how JAX uses a weakly
    typed constant beside an array of ``dtype``)."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


_SCALE_DTYPES = {"_act_scale": torch.float64, "_out_scale": torch.float32,
                 "_act_init": torch.bool, "_out_init": torch.bool}


class _QuantLayerMixin:
    """Weight abs-max fake-quant and the activation's moving-average
    abs-max (reference: imperative/qat.py's wrappers and the
    moving_average_abs_max_scale op), with the output-scale observer."""

    def _init_quant(self, weight_bits, activation_bits=None, momentum=0.9,
                    channel_wise=False):
        self._qbits = weight_bits
        self._qabits = activation_bits if activation_bits is not None \
            else weight_bits
        self._qmomentum = momentum
        self._channel_wise = channel_wise
        dev = self.weight.device
        for name, dtype in _SCALE_DTYPES.items():
            value = 1.0 if dtype != torch.bool else False
            self.register_buffer(name, torch.full((), value, dtype=dtype,
                                                  device=dev),
                                 persistable=False)
        self._frozen = False
        # the PTQ percentile observer: per instance, never a class patch
        self._act_observer = None

    @property
    def _act_scale_initialized(self):
        return bool(self._act_init)

    @property
    def _out_scale_initialized(self):
        return bool(self._out_init)

    def _apply(self, fn, recurse=True):
        keep = {n: self._buffers[n] for n in _SCALE_DTYPES}
        out = super()._apply(fn, recurse)
        for name, old in keep.items():  # the device follows, the dtype not
            self._buffers[name] = old.to(self._buffers[name].device)
        return out

    def _quant_act(self, x):
        if self._act_observer is not None:
            self._act_observer(self, x)
        if not self._frozen:
            with torch.no_grad():
                cur = _absmax(x.detach()).to(torch.float64)
                m = self._qmomentum
                moved = self._act_scale * m
                moved = moved + cur * (1 - m)
                self._act_scale.copy_(torch.where(self._act_init, moved,
                                                  cur))
                self._act_init.fill_(True)
        # the reference's scale: its float64 value as a float32 array
        return _quantize(x, self._act_scale.to(torch.float32), self._qabits)

    def _quant_weight(self, w):
        # the scale from a detached weight (no grad mode switch: an exported
        # forward holds no set_grad_enabled node)
        wd = w.detach()
        if self._channel_wise:
            # channel_wise_abs_max: one scale per output channel
            axes, shape = self._channel_axes(tuple(w.shape))
            sv = torch.reshape(_absmax(wd, axis=axes, keepdims=True), shape)
        else:
            sv = _absmax(wd)
        return _quantize(w, sv, self._qbits)

    def _observe_out(self, y):
        if not self._frozen:
            with torch.no_grad():
                cur = _absmax(y.detach())
                dt = cur.dtype
                m = self._qmomentum
                moved = (self._out_scale.to(dt) * _rounded(m, dt)
                         + cur * _rounded(1 - m, dt))
                self._out_scale.copy_(torch.where(self._out_init, moved,
                                                  cur))
                self._out_init.fill_(True)
        return y

    def quant_scales(self):
        """The exported calibration record: the activation and output
        thresholds and the weight scales (one per channel with
        ``channel_wise``), for a serving backend to requantize from."""
        w = self.weight.detach()
        if self._channel_wise:
            axes, _ = self._channel_axes(tuple(w.shape))
            wscale = _absmax(w, axis=axes).float().cpu().numpy() \
                .ravel().tolist()
        else:
            wscale = float(_absmax(w).float())
        return {"act_scale": float(self._act_scale),
                "out_scale": float(self._out_scale),
                "weight_scale": wscale,
                "weight_bits": self._qbits, "activation_bits": self._qabits,
                "channel_wise": self._channel_wise}

    def freeze(self):
        """Stop updating the scales (calibration done)."""
        self._frozen = True


class QuantizedLinear(_QuantLayerMixin, Layer):
    def __init__(self, layer, bits=8, activation_bits=None,
                 channel_wise=False):
        super().__init__()
        self.weight = layer.weight
        self.bias = layer.bias
        self._init_quant(bits, activation_bits, channel_wise=channel_wise)

    @staticmethod
    def _channel_axes(wshape):
        # weight [in, out]: one scale per output column
        return (0,), (1, wshape[1])

    def forward(self, x):
        y = F.linear(self._quant_act(x), self._quant_weight(self.weight),
                     self.bias)
        return self._observe_out(y)


class QuantizedConv2D(_QuantLayerMixin, Layer):
    def __init__(self, layer, bits=8, activation_bits=None,
                 channel_wise=False):
        super().__init__()
        self.weight = layer.weight
        self.bias = layer.bias
        self._inner = dict(stride=layer._stride, padding=layer._padding,
                           dilation=layer._dilation, groups=layer._groups,
                           data_format=layer._data_format)
        self._init_quant(bits, activation_bits, channel_wise=channel_wise)

    @staticmethod
    def _channel_axes(wshape):
        # weight [out_c, in_c, kh, kw]: one scale per output channel
        return (1, 2, 3), (wshape[0], 1, 1, 1)

    def forward(self, x):
        y = F.conv2d(self._quant_act(x), self._quant_weight(self.weight),
                     self.bias, **self._inner)
        return self._observe_out(y)


class QuantizedEmbedding(_QuantLayerMixin, Layer):
    """Embedding-table quantization (reference: slim's quant_embedding
    pass, an abs_max int8 table); ids are not activation-quantized."""

    def __init__(self, layer, bits=8, activation_bits=None,
                 channel_wise=False):
        super().__init__()
        self.weight = layer.weight
        self._padding_idx = getattr(layer, "_padding_idx", None)
        self._init_quant(bits, activation_bits, channel_wise=channel_wise)

    @staticmethod
    def _channel_axes(wshape):
        # table [vocab, dim]: one scale per row
        return (1,), (wshape[0], 1)

    def forward(self, ids):
        y = F.embedding(ids, self._quant_weight(self.weight),
                        padding_idx=self._padding_idx)
        return self._observe_out(y)


_QUANTIZABLE = {Linear: QuantizedLinear, Conv2D: QuantizedConv2D,
                Embedding: QuantizedEmbedding}


class ImperativeQuantAware:
    """The QAT driver (reference: imperative/qat.py ImperativeQuantAware):
    ``quantize()`` swaps the model's ``Linear``/``Conv2D`` children (by
    exact type; ``Embedding`` when asked) for fake-quant wrappers in
    place."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 quantizable_layer_type=("Linear", "Conv2D"),
                 weight_quantize_type="abs_max", **kw):
        self._bits = weight_bits
        self._abits = activation_bits
        if weight_quantize_type not in ("abs_max", "channel_wise_abs_max"):
            raise ValueError(
                f"unsupported weight_quantize_type {weight_quantize_type!r}:"
                " expected 'abs_max' or 'channel_wise_abs_max'")
        self._channel_wise = weight_quantize_type == "channel_wise_abs_max"
        self._types = tuple(
            cls for cls in _QUANTIZABLE
            if cls.__name__ in quantizable_layer_type)

    def quantize(self, model):
        self._swap(model)
        return model

    def _swap(self, layer):
        for name, sub in list(layer._modules.items()):
            if sub is None:
                continue
            if type(sub) in self._types:
                layer._modules[name] = _QUANTIZABLE[type(sub)](
                    sub, self._bits, self._abits,
                    channel_wise=self._channel_wise)
            else:
                self._swap(sub)

    @staticmethod
    def save_quantized_model(model, path, input_spec=None):
        """Freeze the scales, write the servable artifact (``jit.save``'s
        ``.pdmodel``/``.pdiparams`` pair) and a ``<path>.quant.json``
        sidecar with every quantized layer's calibration record (the
        out_threshold and activation-scale attributes the reference embeds
        in its quantized program)."""
        from .. import jit
        scales = {}
        for name, sub in model.named_sublayers(include_self=True):
            if isinstance(sub, _QuantLayerMixin):
                sub.freeze()
                scales[name or "<root>"] = sub.quant_scales()
        out = jit.save(model, path, input_spec=input_spec)
        with open(path + ".quant.json", "w") as f:
            json.dump(scales, f, indent=1)
        return out


def load_quant_scales(path):
    """The calibration sidecar saved beside a quantized artifact."""
    with open(path + ".quant.json") as f:
        return json.load(f)


class PTQ:
    """Post-training quantization (reference: post_training_quantization.py
    PostTrainingQuantization): ``abs_max`` (the moving average over the
    calibration batches) or ``percentile`` activation calibration."""

    def __init__(self, activation_bits=8, weight_bits=8,
                 algo="abs_max", percentile=0.999):
        self._abits = activation_bits
        self._wbits = weight_bits
        self._algo = algo
        self._pct = percentile

    def quantize(self, model, calib_loader, max_batches=16):
        """Swap the layers, run the calibration batches, freeze."""
        ImperativeQuantAware(self._wbits, self._abits).quantize(model)
        qlayers = [sub for sub in model.sublayers(include_self=True)
                   if isinstance(sub, _QuantLayerMixin)]

        if self._algo == "percentile":
            # each layer's activation samples on the host, then the
            # percentile over all of them
            samples = {}

            def observing(layer, x):
                v = np.abs(unwrap(x).detach().float().cpu().numpy()).ravel()
                samples.setdefault(id(layer), []).append(v)

            for sub in qlayers:
                sub._act_observer = observing
            try:
                self._run_calib(model, calib_loader, max_batches)
            finally:
                for sub in qlayers:
                    sub._act_observer = None
            for sub in qlayers:
                if id(sub) in samples:
                    allv = np.concatenate(samples[id(sub)])
                    sub._act_scale.fill_(float(np.quantile(allv, self._pct)))
                    sub._act_init.fill_(True)
        else:
            self._run_calib(model, calib_loader, max_batches)

        for sub in qlayers:
            sub.freeze()
        return model

    @staticmethod
    def _run_calib(model, loader, max_batches):
        model.eval()
        with torch.no_grad():
            for i, batch in enumerate(loader):
                if i >= max_batches:
                    break
                x = batch[0] if isinstance(batch, (tuple, list)) else batch
                model(x)


def quant_post_static(model, calib_loader, **kw):
    """The functional PTQ entry (reference: paddle.static.quantization
    quant_post_static)."""
    return PTQ(**kw).quantize(model, calib_loader)
