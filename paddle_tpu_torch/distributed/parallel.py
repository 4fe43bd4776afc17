"""DataParallel (counterpart: ``paddle_tpu/distributed/parallel.py``).

``DataParallel`` wraps a layer for data parallelism over the mesh's dp group
(never the whole world of a hybrid mesh): at wrap time it broadcasts the
parameters from the group's first rank, so every replica starts alike;
``apply_collective_grads`` (``fused_allreduce_grads``) averages the
gradients over the group in float32 flat buckets of ``comm_buffer_size`` MB,
one all-reduce each (the reference's ``reducer.cc`` groups). A sparse
gradient (``SelectedRows``, from ``embedding(sparse=True)``) is skipped,
as the reference skips it; a parameter with a dense and a sparse one is
reduced as their dense sum. Under
``jit.to_static(..., dp_axis="dp")`` the optimizer reduces instead.

The wrappers of this module and ``fleet.meta_parallel`` hand the inner
layer's names through: ``parameters()``, ``named_parameters()``,
``state_dict()`` and ``set_state_dict()`` are the inner layer's, without a
``_layers.`` prefix.
"""
import torch

from ..core.tensor import fold_sparse
from . import bucketing, collective, parallel_env
from ..nn.layer.layers import Layer


def _dp_group():
    mesh = parallel_env.current_mesh()
    if mesh is not None and "dp" in mesh.shape:
        return parallel_env.axis_group(mesh, "dp")
    return None


@torch.no_grad()
def fused_allreduce_grads(params, comm_buffer_mb=25.0,
                          last_comm_buffer_mb=1.0, group=None):
    """Average the parameters' gradients over ``group`` (default: the
    mesh's dp group) in place: float32 flat buckets of ``comm_buffer_mb``
    MB, one all-reduce each. Returns the number of buckets."""
    params = [p for p in params if p.requires_grad and p.grad is not None
              and fold_sparse(p) is not None]
    if not params:
        return 0
    group = _dp_group() if group is None else group
    buckets = bucketing.bucket_params(params, comm_buffer_mb,
                                      last_comm_buffer_mb)
    for bucket in buckets:
        flat = torch.cat([p.grad.float().reshape(-1) for p in bucket])
        collective.all_reduce(flat, op=collective.ReduceOp.AVG, group=group)
        off = 0
        for p in bucket:
            n = p.grad.numel()
            p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n
    return len(buckets)


class _LayerWrapper(Layer):
    """A wrapper that is its inner layer for names and state."""

    def __init__(self, layers):
        super().__init__()
        self._layers = layers

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, include_sublayers=True, recurse=None):
        return self._layers.parameters(include_sublayers, recurse)

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        return self._layers.named_parameters(prefix, include_sublayers,
                                             recurse, remove_duplicate)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)


@torch.no_grad()
def broadcast_parameters(params, group):
    """Every parameter from ``group``'s first rank to the others."""
    src = collective.peer(group, 0)
    for p in params:
        collective.broadcast(p.data, src=src, group=group)


class DataParallel(_LayerWrapper):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__(layers)
        self._comm_buffer_mb = float(comm_buffer_size)
        self._last_comm_buffer_mb = float(last_comm_buffer_size)
        self._group = _dp_group() if group is None else group
        if collective._world():
            broadcast_parameters(list(layers.parameters()), self._group)

    def scale_loss(self, loss):
        # the gradients are averaged in apply_collective_grads
        return loss

    def apply_collective_grads(self):
        return fused_allreduce_grads(
            self._layers.parameters(), self._comm_buffer_mb,
            self._last_comm_buffer_mb, group=self._group)
