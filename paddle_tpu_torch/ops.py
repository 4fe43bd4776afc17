"""Tensor ops of the ported paths (counterparts: ``paddle_tpu/ops/
manipulation.py`` reshape/unstack/flatten, ``paddle_tpu/ops/math.py``
arange/matmul/cast). Plain functions on tensors; ``matmul`` consults
``amp.auto_cast``."""
import torch

from .amp.auto_cast import cast_inputs
from .core.device import resolve_device
from .core.dtype import convert_dtype


def reshape(x, shape):
    # a symbolic size (torch.export's batch) stays symbolic: int() would
    # specialize it to the example's value
    return x.reshape([s if isinstance(s, torch.SymInt) else int(s)
                      for s in shape])


def flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis)


def unstack(x, axis=0, num=None):
    if num is not None and num != x.shape[axis]:
        raise ValueError(f"unstack: num={num} but axis {axis} has size "
                         f"{x.shape[axis]}")
    return list(torch.unbind(x, dim=axis))


def arange(start=0, end=None, step=1, dtype=None, device=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=resolve_device(device))


def matmul(x, y, transpose_x=False, transpose_y=False):
    x, y = cast_inputs("matmul", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def cast(x, dtype):
    return x.to(convert_dtype(dtype))
