"""conv1d, conv2d, conv3d and the transposed convolutions (counterpart:
``paddle_tpu/nn/functional/conv.py``).

The reference lowers each convolution to one XLA ``conv_general_dilated``,
not to a Pallas kernel; the port calls ``torch.nn.functional.conv{1,2,3}d``
(cuDNN on the card). Weights are ``[out, in/groups, *k]``, torch's layout
too. ``padding`` takes what the reference's ``_conv_padding`` takes: an int,
one int per spatial dim, a (before, after) pair per dim written flat
(``[p0, p1, q0, q1]``), or ``"SAME"``/``"VALID"``; padding that torch's
call cannot express (uneven, or ``"SAME"`` at a stride) is applied with
``F.pad`` first. The channels-last formats (``NLC``, ``NHWC``, ``NDHWC``)
run channels-first between two permutes. Under ``auto_cast`` the ops are
allow-listed (``conv1d``, ``conv2d``, ``conv3d`` and the transposed
three); the output keeps the input's dtype.

``conv{1,2,3}d_transpose`` take weights ``[in, out/groups, *k]`` (torch's
``conv_transpose`` layout too) and compute the reference's fractionally
strided convolution: the input dilated by the stride, the kernel flipped,
and per spatial dim the pads ``(k_eff - 1 - p0, k_eff - 1 - p1 +
output_padding)`` with ``k_eff = (k - 1) * dilation + 1``. So padding may
be uneven (``[p0, p1]`` a dim) and ``output_padding`` any size, where
torch's call pads symmetrically and wants ``output_padding`` below the
stride or the dilation: such a case runs torch's call unpadded and crops
(or zero-extends) the result to the reference's size before the bias.
String padding raises, as in the reference.
"""
import torch

from ...amp.auto_cast import cast_inputs

_CHANNELS_FIRST = {1: ("NCL", "NCHW"), 2: ("NCHW",), 3: ("NCDHW",)}


def _ntuple(v, nd):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * nd


def _same_pads(sizes, kernel, stride, dilation):
    """XLA's ``SAME``: ceil(n / s) outputs, the extra pad after."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def spatial_pads(padding, sizes, kernel, stride, dilation=None):
    """(before, after) per spatial dim, as the reference reads ``padding``
    (the pooling functionals share it)."""
    nd = len(sizes)
    dilation = dilation or (1,) * nd
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "SAME":
            return _same_pads(sizes, kernel, stride, dilation)
        if mode == "VALID":
            return [(0, 0)] * nd
        raise ValueError(f"bad padding {padding!r}")
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = [int(p) for p in padding]
    if len(padding) == nd:
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    raise ValueError(f"bad padding {padding}")


def torch_pad_arg(pads):
    """(before, after) per spatial dim -> ``F.pad``'s last-dim-first list."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd,
             data_format):
    x, weight, bias = cast_inputs(f"conv{nd}d", x, weight, bias)
    last = data_format not in _CHANNELS_FIRST[nd]
    if last:
        x = x.movedim(-1, 1)
    stride, dilation = _ntuple(stride, nd), _ntuple(dilation, nd)
    pads = spatial_pads(padding, x.shape[2:], weight.shape[2:], stride,
                        dilation)
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        x = torch.nn.functional.pad(x, torch_pad_arg(pads))
        pad = 0
    conv = (torch.nn.functional.conv1d, torch.nn.functional.conv2d,
            torch.nn.functional.conv3d)[nd - 1]
    out = conv(x, weight, bias, stride, pad, dilation, groups)
    return out.movedim(1, -1) if last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def _transpose_pads(padding, nd):
    if isinstance(padding, str):
        raise NotImplementedError(
            "string padding for conv_transpose not supported")
    return spatial_pads(padding, (0,) * nd, (1,) * nd, (1,) * nd)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, nd, data_format):
    x, weight, bias = cast_inputs(f"conv{nd}d_transpose", x, weight, bias)
    last = data_format not in _CHANNELS_FIRST[nd]
    if last:
        x = x.movedim(-1, 1)
    stride, dilation = _ntuple(stride, nd), _ntuple(dilation, nd)
    opad = _ntuple(output_padding, nd)
    pads = _transpose_pads(padding, nd)
    conv = (torch.nn.functional.conv_transpose1d,
            torch.nn.functional.conv_transpose2d,
            torch.nn.functional.conv_transpose3d)[nd - 1]
    native = all(p0 == p1 and 0 <= op < max(s, d) for (p0, p1), op, s, d
                 in zip(pads, opad, stride, dilation))
    if native:
        out = conv(x, weight, bias, stride, tuple(p0 for p0, _ in pads),
                   opad, groups, dilation)
    else:
        out = conv(x, weight, None, stride, 0, 0, groups, dilation)
        # the unpadded output is the reference's with pads (k_eff - 1) a
        # side: crop p0 before and p1 - output_padding after (a negative
        # crop extends with zeros, what the reference's extra pad reads)
        out = torch.nn.functional.pad(out, torch_pad_arg(
            [(-p0, op - p1) for (p0, p1), op in zip(pads, opad)]))
        if bias is not None:
            out = out + bias.reshape((1, -1) + (1,) * nd)
    return out.movedim(1, -1) if last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCL"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format)
