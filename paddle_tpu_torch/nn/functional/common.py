"""linear, embedding, dropout (counterpart:
``paddle_tpu/nn/functional/common.py``). Plain torch ops: the JAX package
left these to XLA. ``linear`` and ``embedding`` consult ``amp.auto_cast``.

``embedding(sparse=True)`` gives the table a row gradient (the
reference's ``W@GRAD`` as ``SelectedRows``): its backward sums the
cotangents of equal ids (``SelectedRows.merge_add``, K rows for K ids
whatever the duplicates) and adds the result to the table's sparse
gradient (``core.tensor.accumulate_sparse``); the table's dense ``grad``
stays None. The optimizers update those rows only. Under ``grad``, which
touches no leaf, the row gradient is returned instead
(``core.autograd.collect_rows``).
"""
import torch

from ...amp.auto_cast import cast_inputs
from ...core.autograd import collect_rows
from ...core.random import draw_generator
from ...core.selected_rows import SelectedRows
from ...core.tensor import Tensor, accumulate_sparse


def linear(x, weight, bias=None):
    """y = x @ W + b with the reference's weight layout W: [in, out]."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False):
    """Row lookup; rows whose id is ``padding_idx`` come out as zeros.
    ``sparse=True`` gives ``weight`` (a leaf: a parameter) a row gradient
    instead of a dense one (module docstring)."""
    table = _leaf(weight)
    (weight,) = cast_inputs("embedding", weight)
    if sparse and torch.is_grad_enabled() and table.requires_grad:
        if not table.is_leaf:
            raise ValueError("embedding(sparse=True) needs a leaf table (a "
                             "parameter) to carry its row gradient")
        return _SparseLookup.apply(weight, x, padding_idx, table)
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out


def _leaf(weight):
    """The table that carries a row gradient: ``weight``, or the ``Tensor``
    leaf whose alias the ``Tensor`` boundary handed in."""
    fn = weight.grad_fn
    if (fn is not None and fn.name() == "AliasBackward0"
            and type(weight._base) is Tensor):
        return weight._base
    return weight


class _SparseLookup(torch.autograd.Function):
    """The lookup whose backward hands the table a ``SelectedRows``."""

    @staticmethod
    def forward(ctx, weight, ids, padding_idx, table):
        ctx.save_for_backward(ids)
        ctx.padding_idx, ctx.table = padding_idx, table
        out = torch.nn.functional.embedding(ids, weight)
        if padding_idx is not None:
            out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
        return out

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1).long()
        vals = grad.reshape(flat.shape[0], *grad.shape[ids.dim():])
        if ctx.padding_idx is not None:
            vals = vals.masked_fill((flat == ctx.padding_idx).unsqueeze(-1),
                                    0.0)
        table = ctx.table
        rows = SelectedRows(flat, vals, table.shape[0]).merge_add()
        if not collect_rows(table, rows):  # grad() touches no leaf
            accumulate_sparse(table, rows)
        return None, None, None, None


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """Reference dropout semantics (identity in eval mode or at p = 0);
    the keep mask draws from the package's seeded generator for ``x``'s
    device."""
    if not training or p == 0.0:
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    u = torch.rand(shape, generator=draw_generator(x.device),
                   device=x.device)
    keep = u >= p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero)
    return torch.where(keep, x, zero)
