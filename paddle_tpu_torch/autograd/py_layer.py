"""PyLayer: user-defined autograd ops (counterpart:
``paddle_tpu/autograd/py_layer.py``), over ``torch.autograd.Function``.

``forward(ctx, *args, **kwargs)`` runs without recording (as the
reference's, under ``no_grad``) on ``Tensor`` arguments; ``backward(ctx,
*grads)`` gets one ``Tensor`` gradient per output and returns one gradient
(or None) per tensor argument of ``forward``, in order. Non-tensor
arguments pass through. Unlike the reference, an op none of whose tensor
arguments needs a gradient records nothing (torch's rule), so its
``backward`` never runs.
"""
import torch

from ..core.tensor import unwrap, wrap

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class PyLayerMeta(type):
    pass


class PyLayer(metaclass=PyLayerMeta):
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        slots = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        fn = _function_of(cls)
        out = fn.apply(args, kwargs, slots,
                       *(unwrap(args[i]) for i in slots))
        single, outs = out[0], out[1:]
        return wrap(outs[0] if single else tuple(outs))


_FUNCTIONS = {}


def _function_of(cls):
    fn = _FUNCTIONS.get(cls)
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(tctx, args, kwargs, slots, *tensors):
            ctx = PyLayerContext()
            tctx.pl_ctx, tctx.n_in = ctx, len(tensors)
            full = list(args)
            for i, t in zip(slots, tensors):
                full[i] = wrap(t)
            outs = cls.forward(ctx, *full, **kwargs)
            single = not isinstance(outs, (tuple, list))
            outs = [outs] if single else list(outs)
            tctx.set_materialize_grads(ctx.materialize_grads)
            return (single, *(unwrap(o) for o in outs))

        @staticmethod
        def backward(tctx, _single_grad, *grads):
            got = cls.backward(tctx.pl_ctx, *wrap(list(grads)))
            if not isinstance(got, (tuple, list)):
                got = (got,)
            got = [None if g is None else unwrap(g) for g in got]
            got += [None] * (tctx.n_in - len(got))
            return (None, None, None, *got[:tctx.n_in])

    _Fn.__name__ = cls.__name__
    _FUNCTIONS[cls] = _Fn
    return _Fn
