"""``fleet.utils.recompute`` (counterpart:
``paddle_tpu/distributed/fleet/utils/recompute.py``; the reference's
``fleet/utils/recompute.py:63``).

:func:`recompute` is the package's recompute segment
(``paddle_tpu_torch.recompute``, over ``torch.utils.checkpoint``), called
now: its random draws replay bitwise whatever ``preserve_rng_state``
says, and ``policy`` picks what the segment keeps. ``RecomputeFunction``
is the legacy eager form for code that names it: the forward runs without
gradients, and the backward runs it again from the saved inputs (with the
package generator's state put back when ``preserve_rng_state``) and
differentiates that; parameter gradients accumulate on the parameters.
"""
import torch

from ....autograd.py_layer import PyLayer
from ....core import random as core_random
from ....core.tensor import unwrap

__all__ = ["RecomputeFunction", "recompute"]


def _device_of(args):
    return next((a.device for a in args if isinstance(a, torch.Tensor)),
                torch.device("cpu"))


class RecomputeFunction(PyLayer):
    @staticmethod
    def forward(ctx, run_function, preserve_rng_state, *args):
        ctx.run_function = run_function
        ctx.preserve_rng_state = preserve_rng_state
        ctx.inputs = args
        if preserve_rng_state:
            ctx.device = _device_of(args)
            ctx.rng_state = core_random.default_generator(
                ctx.device).get_state()
        with torch.no_grad():
            return run_function(*args)

    @staticmethod
    def backward(ctx, *grads):
        detached = [a.detach().requires_grad_(a.requires_grad)
                    if isinstance(a, torch.Tensor) else a
                    for a in ctx.inputs]
        gen = saved = None
        if ctx.preserve_rng_state:
            gen = core_random.default_generator(ctx.device)
            saved = gen.get_state()
            gen.set_state(ctx.rng_state)
        try:
            with torch.enable_grad():
                outputs = ctx.run_function(*detached)
                # plain aliases made with gradients on keep the graph
                outs = unwrap(list(outputs) if isinstance(
                    outputs, (tuple, list)) else [outputs])
        finally:
            if gen is not None:
                gen.set_state(saved)
        pairs = [(o, g) for o, g in zip(outs, unwrap(list(grads)))
                 if isinstance(o, torch.Tensor) and o.requires_grad
                 and g is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return tuple(t.grad if isinstance(t, torch.Tensor) else None
                     for t in detached if isinstance(t, torch.Tensor))


def recompute(function, *args, preserve_rng_state=True, policy="full",
              **kwargs):
    """``function(*args, **kwargs)`` as one recompute segment, now (also
    for a function of no arguments); ``policy`` is taken here and not
    passed on."""
    del preserve_rng_state  # the segment's draws always replay bitwise
    from ....recompute import _segment_call
    return _segment_call(function, args, kwargs, policy)
