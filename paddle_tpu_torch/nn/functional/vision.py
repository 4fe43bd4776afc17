"""Spatial-transform and vision functionals (counterpart:
``paddle_tpu/nn/functional/vision.py``).

Dense torch operations with their gradients: the reference lowered them
to gather arithmetic for XLA; on the card they run inside cuDNN or ATen.
None reads the host or makes a data-dependent shape, so each can be
captured into a CUDA graph (``jit.to_static``).
"""
import torch
import torch.nn.functional as TF

__all__ = ["affine_grid", "grid_sample", "temporal_shift", "channel_shuffle",
           "shuffle_channel", "space_to_depth", "affine_channel",
           "local_response_norm", "lrn", "deformable_conv"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def affine_grid(theta, out_shape, align_corners=True):
    """theta [N, 2, 3] -> the sampling grid [N, H, W, 2] of normalized
    (x, y) for an output of ``out_shape`` [N, C, H, W]. Capturable."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    n, c, h, w = (int(s) for s in out_shape)
    return TF.affine_grid(theta, [n, c, h, w], align_corners=align_corners)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """Sample x [N, C, H, W] at the normalized grid [N, Hg, Wg, (x, y)]:
    ``bilinear`` or ``nearest`` (ties to even, as the reference's
    rounding), ``zeros``, ``border`` or ``reflection`` padding.
    Capturable."""
    return TF.grid_sample(x, grid.to(x.dtype), mode=mode,
                          padding_mode=padding_mode,
                          align_corners=align_corners)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """TSM's shift over time of x [N*T, C, H, W]: the first
    ``C * shift_ratio`` channels from the step before, the next as many
    from the step after (zeros at the ends), the rest in place.
    Capturable."""
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    padded = TF.pad(v, (0, 0, 0, 0, 0, 0, 1, 1))
    out = torch.cat([padded[:, :seg_num, :c1], padded[:, 2:, c1:c2],
                     v[:, :, c2:]], dim=2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def channel_shuffle(x, groups, data_format="NCHW"):
    """ShuffleNet's channel shuffle over ``groups``. Capturable."""
    if data_format == "NHWC":
        n, h, w, c = x.shape
        return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
            .reshape(n, h, w, c)
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)


shuffle_channel = channel_shuffle  # the fluid name


def space_to_depth(x, blocksize):
    """[N, C, H, W] -> [N, C*b*b, H/b, W/b], the reference's channel order
    (the block offsets outermost). Capturable."""
    n, c, h, w = x.shape
    b = blocksize
    v = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return v.reshape(n, c * b * b, h // b, w // b)


def affine_channel(x, scale, bias, data_format="NCHW"):
    """y = scale * x + bias per channel. Capturable."""
    if data_format == "NHWC":
        return x * scale + bias
    return x * scale[:, None, None] + bias[:, None, None]


def local_response_norm(x, size=5, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    """x / (k + alpha / size * sum of x^2 over ``size`` neighbouring
    channels) ^ beta, the window from ``size // 2`` channels before to
    ``size - 1 - size // 2`` after (zeros beyond the edges). Capturable."""
    v = x if data_format == "NCHW" else x.movedim(-1, 1)
    c = v.shape[1]
    half = size // 2
    sq = TF.pad(v.square(), (0, 0, 0, 0, half, size - 1 - half))
    den = sq[:, 0:c]
    for i in range(1, size):
        den = den + sq[:, i:i + c]
    out = v / (k + alpha / size * den).pow(beta)
    return out if data_format == "NCHW" else out.movedim(1, -1)


def lrn(x, n=5, k=1.0, alpha=1e-4, beta=0.75, data_format="NCHW"):
    """The fluid signature: ``alpha`` scales each squared term (it is not
    divided by ``n``)."""
    return local_response_norm(x, size=n, alpha=alpha * n, beta=beta, k=k,
                               data_format=data_format)


def deformable_conv(x, offset, weight, bias=None, stride=1, padding=0,
                    dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1 (``mask=None``) and v2 (modulated).

    x [N, Cin, H, W]; offset [N, 2*dg*kh*kw, Ho, Wo] ((y, x) per tap);
    mask [N, dg*kh*kw, Ho, Wo]; weight [Cout, Cin/groups, kh, kw]. Each
    tap samples the input bilinearly at its offset position (zero outside
    the input), the columns are weighted by the mask, and a grouped matmul
    with the weight gives the output, as the reference computes it.
    Capturable: the gathers have the output's shape."""
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    n, cin, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    ho = (h + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    wo = (w + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    dg = deformable_groups
    cpg = cin // dg
    off = offset.reshape(n, dg, kh * kw, 2, ho, wo)
    if mask is not None:
        mask = mask.reshape(n, dg, kh * kw, ho, wo)
    flat = x.reshape(n, dg, cpg, h * w)
    oy = (torch.arange(ho, device=x.device) * s[0] - p[0]).to(x.dtype)
    ox = (torch.arange(wo, device=x.device) * s[1] - p[1]).to(x.dtype)

    def corner(iy, ix, weight_):
        inside = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
        idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(
            n, dg, 1, ho * wo).expand(n, dg, cpg, ho * wo)
        got = torch.gather(flat, 3, idx)
        return got * (weight_ * inside).reshape(n, dg, 1, ho * wo)

    cols = []
    for ky in range(kh):
        for kx in range(kw):
            tap = ky * kw + kx
            fy = (oy + ky * d[0])[:, None] + off[:, :, tap, 0]
            fx = (ox + kx * d[1])[None, :] + off[:, :, tap, 1]
            y0, x0 = torch.floor(fy), torch.floor(fx)
            wy, wx = fy - y0, fx - x0
            y0, x0 = y0.long(), x0.long()
            val = (corner(y0, x0, (1 - wy) * (1 - wx))
                   + corner(y0, x0 + 1, (1 - wy) * wx)
                   + corner(y0 + 1, x0, wy * (1 - wx))
                   + corner(y0 + 1, x0 + 1, wy * wx))
            if mask is not None:
                val = val * mask[:, :, tap].reshape(n, dg, 1, ho * wo)
            cols.append(val.reshape(n, cin, ho * wo))
    col = torch.stack(cols, dim=2).reshape(n, cin * kh * kw, ho * wo)
    wmat = weight.reshape(cout, cin_g * kh * kw)
    if groups == 1:
        out = torch.matmul(wmat, col)
    else:
        col = col.reshape(n, groups, (cin // groups) * kh * kw, ho * wo)
        out = torch.matmul(wmat.reshape(groups, cout // groups, -1), col) \
            .reshape(n, cout, ho * wo)
    out = out.reshape(n, cout, ho, wo)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out
