"""LayerNorm, RMSNorm, GroupNorm, the instance norms, the BatchNorm
layers and ``SyncBatchNorm`` (counterpart: ``paddle_tpu/nn/layer/norm.py``).
As in the reference, ``InstanceNorm1D``, ``2D`` and ``3D`` are one class
(it normalises over whatever spatial axes its input has).

``SyncBatchNorm`` normalises a training batch with the statistics of the
global batch of the data-parallel group (the mesh's dp axis, else the
default process group): the reference's ``SyncBatchNorm`` is its
``BatchNorm``, and under its GSPMD step program the batch statistics of a
batch sharded over dp are the global batch's. The port's plain
``BatchNorm`` under data parallelism normalises each rank's shard by its
own statistics, as the reference's manual-dp (``shard_map``) program does.
With one rank (or none, or in eval) ``SyncBatchNorm`` is ``BatchNorm``, as
torch's own is.
"""
import torch

from ...core.device import resolve_device
from ...distributed import collective, parallel_env
from .. import functional as F
from .. import initializer as I
from .layers import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr, device=device,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True,
            device=device)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr, device=device,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr, device=device,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True, device=device)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon, self._data_format)


class InstanceNorm2D(Layer):
    """Scale (ones) and shift (zeros) per channel; ``momentum`` is taken
    and unused, as in the reference (no running statistics)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr, device=device,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True, device=device)

    def forward(self, x):
        return F.instance_norm(x, self.weight, self.bias, self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class _BatchNormBase(Layer):
    """Scale (ones) and shift (zeros), or as ``weight_attr``/``bias_attr``
    say (none where False); the running statistics are the float32
    buffers ``_mean`` (zeros) and ``_variance`` (ones), the reference's
    ``state_dict`` names. ``momentum`` is the reference's (the old
    value's weight)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr, device=device,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True, device=device)
        dev = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """The fluid-style name of the same layer."""


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, name=name, device=device)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, name=name, device=device)


class LocalResponseNorm(Layer):
    """``F.local_response_norm`` as a layer (no parameters)."""

    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


def _dp_group():
    """(group, degree) that ``SyncBatchNorm`` reduces over: the mesh's dp
    axis, else the default process group; (None, 1) without one."""
    mesh = parallel_env.current_mesh()
    if mesh is not None and "dp" in mesh.axis_names:
        return (parallel_env.axis_group(mesh, "dp"),
                parallel_env.axis_degree(mesh, "dp"))
    if collective._world():
        return None, collective.get_world_size()
    return None, 1


class _SyncBatchNormFn(torch.autograd.Function):
    """Training-mode batch norm over the group's global batch, channels at
    dim 1. Forward: one float32 all-reduce of each channel's sum, sum of
    squares and the element count; the biased variance ``E[x^2] - E[x]^2``.
    Backward: one float32 all-reduce of each channel's ``sum(dy)`` and
    ``sum(dy * xhat)``, so ``dx`` is full-batch BatchNorm's for this
    rank's rows; the weight and bias gradients are this rank's own sums,
    which the optimizer's dp mean makes the global batch's. Both
    collectives run on the current stream's work, so a CUDA graph captures
    them."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        dims = [0] + list(range(2, x.dim()))
        c = x.shape[1]
        xf = x.float()
        stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                           xf.new_full((1,), float(x.numel() // c))])
        collective.all_reduce(stats, group=group)
        count = stats[2 * c]
        mean = stats[:c] / count
        var = (stats[c:2 * c] / count - mean * mean).clamp_(min=0.0)
        invstd = torch.rsqrt(var + eps)
        shape = (1, c) + (1,) * (x.dim() - 2)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        out = xhat
        if weight is not None:
            out = out * weight.float().view(shape)
        if bias is not None:
            out = out + bias.float().view(shape)
        ctx.save_for_backward(xhat, invstd, weight, count)
        ctx.has_bias = bias is not None
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        xhat, invstd, weight, count = ctx.saved_tensors
        dims = [0] + list(range(2, xhat.dim()))
        c = xhat.shape[1]
        shape = (1, c) + (1,) * (xhat.dim() - 2)
        g = gy.float()
        local = torch.cat([g.sum(dims), (g * xhat).sum(dims)])
        sums = local.clone()
        collective.all_reduce(sums, group=ctx.group)
        mean_dy = (sums[:c] / count).view(shape)
        mean_dy_xhat = (sums[c:] / count).view(shape)
        scale = invstd if weight is None else invstd * weight.float()
        dx = (g - mean_dy - xhat * mean_dy_xhat) * scale.view(shape)
        gw = local[c:].to(weight.dtype) if weight is not None else None
        gb = local[:c].to(weight.dtype if weight is not None
                          else gy.dtype) if ctx.has_bias else None
        return dx.to(gy.dtype), gw, gb, None, None


class SyncBatchNorm(_BatchNormBase):
    """``BatchNorm`` with the data-parallel group's global batch
    statistics in training (``_SyncBatchNormFn``); the running buffers
    move by the reference's rule (``momentum`` the old value's weight,
    the biased variance), on every rank alike."""

    # the all-reduce path also at one rank (a check of that path where
    # only one rank exists, as on one card)
    _force_sync = False

    def forward(self, x):
        group, degree = _dp_group()
        sync = (self.training and not self._use_global_stats
                and (degree > 1 or self._force_sync))
        if not sync:
            return super().forward(x)
        channel = 1 if self._data_format.startswith("NC") else x.dim() - 1
        v = x if channel == 1 else x.movedim(channel, 1)
        out, mean, var = _SyncBatchNormFn.apply(v, self.weight, self.bias,
                                                self._epsilon, group)
        with torch.no_grad():
            keep = float(torch.tensor(1.0 - self._momentum,
                                      dtype=mean.dtype))
            for buf, batch in ((self._mean, mean), (self._variance, var)):
                buf.mul_(self._momentum).add_((batch * keep).to(buf.dtype))
        return out if channel == 1 else out.movedim(1, channel)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every BatchNorm sublayer (itself included)
        replaced by a ``SyncBatchNorm`` that holds the same parameters and
        running buffers; returns the converted layer."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            sync = cls.__new__(cls)
            torch.nn.Module.__init__(sync)
            sync.__dict__.update({k: v for k, v in layer.__dict__.items()
                                  if k not in ("_parameters", "_buffers",
                                               "_modules")})
            sync._parameters = layer._parameters
            sync._buffers = layer._buffers
            sync._modules = layer._modules
            sync.train(layer.training)
            return sync
        for name, child in list(layer.named_children()):
            converted = cls.convert_sync_batchnorm(child)
            if converted is not child:
                setattr(layer, name, converted)
        return layer
