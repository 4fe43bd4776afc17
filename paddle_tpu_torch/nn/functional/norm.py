"""batch_norm, layer_norm, rms_norm, instance_norm and group_norm
(counterpart: ``paddle_tpu/nn/functional/norm.py``). Each is on the
reference's AMP block and downcast lists: under ``auto_cast`` it computes
in float32 and returns the AMP dtype when an input came in it. The last
three normalise with the population variance over their axes (instance
norm: each sample's channel over its spatial axes; group norm: each
sample's channel group), as the reference writes them out."""
import torch

from ...amp.auto_cast import cast_inputs, downcast_dtype


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Normalise each channel (axis 1 for ``NC*`` formats, else the last)
    by its statistics: the batch's in training, the running buffers in eval
    or with ``use_global_stats``. Training updates the buffers in place with
    the reference's conventions, which are not torch's: ``momentum`` is the
    weight of the old value (``running = momentum * running + (1 - momentum)
    * batch``) and the variance is the biased one, both taken from ``x`` in
    its own dtype, as the reference's ``jnp.mean``/``jnp.var`` take them.
    So the buffers never reach torch's training-mode call, which would
    update them its own way; the update is a no-grad ``var_mean`` and two
    in-place ops, with no host read (it runs inside a captured program).

    Under ``auto_cast`` the op is block-listed and in the downcast list:
    it computes in float32 and a bf16 ``x`` gets a bf16 result. torch's
    batch norm computes a bf16 input against float32 parameters in float32
    and returns bf16, so that input is passed as it is (no float32 copy).
    """
    if use_global_stats is None:
        use_global_stats = not training
    channel = 1 if data_format.startswith("NC") else x.dim() - 1
    v = x if channel == 1 else x.movedim(channel, 1)
    stats = (running_mean, running_var)
    if downcast_dtype("batch_norm", x, *stats, weight, bias) is None:
        # no AMP downcast: compute in the widest dtype of what is used
        used = [t for t in (v, weight, bias) + (stats if use_global_stats
                                                else ()) if t is not None]
        dtype = used[0].dtype
        for t in used[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
        v, weight, bias = (None if t is None else t.to(dtype)
                           for t in (v, weight, bias))
        if use_global_stats:
            stats = tuple(t.to(dtype) for t in stats)
    else:
        weight, bias = cast_inputs("batch_norm", weight, bias)
    if use_global_stats:
        out = torch.nn.functional.batch_norm(v, *stats, weight, bias,
                                             training=False, eps=epsilon)
    else:
        out = torch.nn.functional.batch_norm(v, None, None, weight, bias,
                                             training=True, eps=epsilon)
        if running_mean is not None:
            with torch.no_grad():
                dims = [d for d in range(x.dim()) if d != channel]
                var, mean = torch.var_mean(x.detach(), dims, correction=0)
                # 1 - momentum in the statistics' dtype first, as a weakly
                # typed scalar meets a bf16 array in the reference
                keep = float(torch.tensor(1.0 - momentum, dtype=mean.dtype))
                for buf, batch in ((running_mean, mean), (running_var, var)):
                    buf.mul_(momentum).add_((batch * keep).to(buf.dtype))
    return out if channel == 1 else out.movedim(1, channel)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Normalise over the trailing ``normalized_shape`` dims with the
    population variance, then scale and shift. Under ``auto_cast`` it
    computes in float32 and casts back to the AMP dtype when ``x`` or a
    parameter came in it (the reference's block and downcast lists)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    out_dtype = downcast_dtype("layer_norm", x, weight, bias)
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    out = torch.nn.functional.layer_norm(x, list(normalized_shape), weight,
                                         bias, epsilon)
    return out if out_dtype is None else out.to(out_dtype)


def _scale_shift(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def rms_norm(x, weight=None, epsilon=1e-6):
    """``x / sqrt(mean(x^2) + epsilon)`` over the last axis, times
    ``weight``."""
    out_dtype = downcast_dtype("rms_norm", x, weight)
    x, weight = cast_inputs("rms_norm", x, weight)
    out = x / torch.sqrt(x.square().mean(-1, keepdim=True) + epsilon)
    if weight is not None:
        out = out * weight
    return out if out_dtype is None else out.to(out_dtype)


def _normalise(v, axes, epsilon):
    var, mean = torch.var_mean(v, axes, correction=0, keepdim=True)
    return (v - mean) / torch.sqrt(var + epsilon)


def instance_norm(x, weight=None, bias=None, epsilon=1e-5,
                  data_format="NCHW"):
    """Each sample's channel over its spatial axes (channels on axis 1,
    whatever ``data_format`` says, as the reference reads it)."""
    out_dtype = downcast_dtype("instance_norm", x, weight, bias)
    x, weight, bias = cast_inputs("instance_norm", x, weight, bias)
    out = _normalise(x, tuple(range(2, x.dim())), epsilon)
    out = _scale_shift(out, weight, bias, (1, -1) + (1,) * (x.dim() - 2))
    return out if out_dtype is None else out.to(out_dtype)


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    """Each sample's group of ``C / num_groups`` channels over the group
    and the spatial axes (channels on axis 1)."""
    out_dtype = downcast_dtype("group_norm", x, weight, bias)
    x, weight, bias = cast_inputs("group_norm", x, weight, bias)
    n, c = x.shape[0], x.shape[1]
    g = x.reshape(n, num_groups, c // num_groups, *x.shape[2:])
    out = _normalise(g, tuple(range(2, g.dim())), epsilon).reshape(x.shape)
    out = _scale_shift(out, weight, bias, (1, -1) + (1,) * (x.dim() - 2))
    return out if out_dtype is None else out.to(out_dtype)
