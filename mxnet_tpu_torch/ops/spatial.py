"""Spatial sampling and warping ops (counterpart of
``mxnet_tpu.ops.spatial``; reference ``src/operator/bilinear_sampler.cc``,
``grid_generator.cc``, ``spatial_transformer.cc``,
``contrib/deformable_convolution.cc``, ``contrib/roi_align.cc``,
``contrib/bilinear_resize.cc``, ``correlation.cc``).

Every sampler goes through one differentiable gather,
:func:`_sample_bilinear`: a corner outside the image contributes zero,
and a normalised grid coordinate ``g`` is the pixel ``(g + 1) * (size -
1) / 2``.  Gradients, those of the sampling coordinates included, are
PyTorch's autograd of the interpolation weights (the floor carries
none).  ``ROIAlign`` and ``DeformableConvolution`` are written in
PyTorch ops over that gather.
"""
from __future__ import annotations

import torch

from .registry import register


def _sample_bilinear(data, y, x):
    """``data`` (N, C, H, W) at float pixel coordinates ``y`` / ``x`` of
    shape (N, *S): (N, C, *S)."""
    n, c, h, w = data.shape
    spatial = tuple(y.shape[1:])
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0).unsqueeze(1)
    wx = (x - x0).unsqueeze(1)
    flat = data.reshape(n, c, h * w)

    def corner(yy, xx):
        ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        yc = yy.clamp(0, h - 1).to(torch.int64)
        xc = xx.clamp(0, w - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
        vals = torch.gather(flat, 2, idx).reshape((n, c) + spatial)
        return vals * ok.unsqueeze(1).to(data.dtype)

    v00 = corner(y0, x0)
    v01 = corner(y0, x0 + 1)
    v10 = corner(y0 + 1, x0)
    v11 = corner(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _denorm(coord, size):
    """A [-1, 1] coordinate as a pixel coordinate."""
    return (coord + 1.0) * (size - 1) / 2.0


@register("BilinearSampler", aliases=("bilinear_sampler",))
def _bilinear_sampler(data, grid, cudnn_off=None, **_):
    """``data`` (N, C, H, W) sampled at ``grid`` (N, 2, Ho, Wo), the
    normalised (x, y) in [-1, 1]."""
    x = _denorm(grid[:, 0], data.shape[3])
    y = _denorm(grid[:, 1], data.shape[2])
    return _sample_bilinear(data, y, x)


@register("GridGenerator", aliases=("grid_generator",))
def _grid_generator(data, transform_type="affine", target_shape=(0, 0),
                    **_):
    """``affine``: (N, 6) parameters to a sampling grid (N, 2, H, W);
    ``warp``: a pixel flow (N, 2, H, W) to the normalised grid."""
    if transform_type == "affine":
        h, w = int(target_shape[0]), int(target_shape[1])
        ys = torch.linspace(-1.0, 1.0, h, device=data.device)
        xs = torch.linspace(-1.0, 1.0, w, device=data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        src = torch.stack([gx.reshape(-1), gy.reshape(-1),
                           torch.ones_like(gx).reshape(-1)])   # (3, HW)
        theta = data.reshape(-1, 2, 3)
        dt = torch.promote_types(theta.dtype, src.dtype)
        out = torch.einsum("nij,jk->nik", theta.to(dt), src.to(dt))
        return out.reshape(-1, 2, h, w)
    if transform_type == "warp":
        _, _, h, w = data.shape
        base_y, base_x = torch.meshgrid(
            torch.arange(h, dtype=data.dtype, device=data.device),
            torch.arange(w, dtype=data.dtype, device=data.device),
            indexing="ij")
        nx = 2.0 * (base_x + data[:, 0]) / (w - 1) - 1.0
        ny = 2.0 * (base_y + data[:, 1]) / (h - 1) - 1.0
        return torch.stack([nx, ny], dim=1)
    raise ValueError("unknown transform_type %r" % transform_type)


@register("SpatialTransformer", aliases=("spatial_transformer",))
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=None, **_):
    """The affine grid of ``loc`` (N, 6), then bilinear sampling."""
    grid = _grid_generator(loc, "affine", target_shape)
    return _bilinear_sampler(data, grid)


@register("_contrib_BilinearResize2D", aliases=("BilinearResize2D",
                                                "bilinear_resize_2d"))
def _bilinear_resize(data, like=None, height=0, width=0, scale_height=None,
                     scale_width=None, mode="size", **_):
    """Bilinear resize, corners aligned."""
    n, _, h, w = data.shape
    if like is not None and mode == "like":
        height, width = like.shape[2:4]
    if scale_height is not None:
        height = int(h * scale_height)
    if scale_width is not None:
        width = int(w * scale_width)
    height, width = int(height), int(width)
    ys = torch.linspace(0.0, h - 1.0, height, device=data.device)
    xs = torch.linspace(0.0, w - 1.0, width, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return _sample_bilinear(data, gy.expand((n,) + gy.shape),
                            gx.expand((n,) + gx.shape))


@register("_contrib_ROIAlign", aliases=("ROIAlign", "roi_align"))
def _roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sample_ratio=-1, position_sensitive=False, aligned=False,
               **_):
    """ROI Align: the mean of bilinear samples on a regular sub-grid of
    each pooled cell (``sample_ratio`` a side, 2 when it is not
    positive)."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    ns = sample_ratio if sample_ratio > 0 else 2
    off = 0.5 if aligned else 0.0
    batch_idx = rois[:, 0].to(torch.int64)
    x1 = rois[:, 1] * spatial_scale - off
    y1 = rois[:, 2] * spatial_scale - off
    x2 = rois[:, 3] * spatial_scale - off
    y2 = rois[:, 4] * spatial_scale - off
    least = 1e-6 if aligned else 1.0
    rw = torch.clamp(x2 - x1, min=least)
    rh = torch.clamp(y2 - y1, min=least)
    sy = (torch.arange(ph * ns, device=data.device) + 0.5) / ns
    sx = (torch.arange(pw * ns, device=data.device) + 0.5) / ns
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    y = y1[:, None, None] + gy[None] * (rh / ph)[:, None, None]
    x = x1[:, None, None] + gx[None] * (rw / pw)[:, None, None]
    samp = _sample_bilinear(data[batch_idx], y, x)
    r, c = samp.shape[:2]
    return samp.reshape(r, c, ph, ns, pw, ns).mean(dim=(3, 5))


@register("_contrib_DeformableConvolution", aliases=(
    "DeformableConvolution", "deformable_convolution"))
def _deformable_convolution(data, offset, weight, bias=None, kernel=None,
                            stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                            num_filter=None, num_group=1,
                            num_deformable_group=1, no_bias=False, **_):
    """Deformable convolution v1: each kernel tap of each output position
    samples at its learned offset (bilinear gather), and the taps are
    contracted with the weights (the reference's deformable im2col and
    GEMM)."""
    n, c, h, w = data.shape
    o, cg, kh, kw = weight.shape
    sh, sw = stride
    dh, dw = dilate
    ph, pw = pad
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = num_deformable_group
    base_y = torch.arange(ho, device=data.device) * sh - ph
    base_x = torch.arange(wo, device=data.device) * sw - pw
    gy, gx = torch.meshgrid(base_y.to(data.dtype), base_x.to(data.dtype),
                            indexing="ij")
    cols = []
    cpg = c // dg
    for g in range(dg):
        dslice = data[:, g * cpg:(g + 1) * cpg]
        taps = []
        for i in range(kh):
            for j in range(kw):
                k = i * kw + j
                oy = offset[:, 2 * (g * kh * kw + k)]
                ox = offset[:, 2 * (g * kh * kw + k) + 1]
                taps.append(_sample_bilinear(dslice, gy[None] + i * dh + oy,
                                             gx[None] + j * dw + ox))
        cols.append(torch.stack(taps, dim=2))    # (N, cpg, K, Ho, Wo)
    col = torch.cat(cols, dim=1).reshape(n, c * kh * kw, ho, wo)
    wg = weight.reshape(num_group, o // num_group, cg * kh * kw)
    colg = col.reshape(n, num_group, (c // num_group) * kh * kw, ho, wo)
    out = torch.einsum("gok,ngkhw->ngohw", wg, colg).reshape(n, o, ho, wo)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


@register("Correlation", aliases=("correlation",))
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True, **_):
    """FlowNet's correlation: ``out[:, k, y, x]`` is the channel mean of
    ``data1[y, x] * data2[y + dy, x + dx]`` (or of ``|a - b|``) over the
    displacements ``k = (dy, dx)``; ``kernel_size`` 1 only, as the
    reference's."""
    if kernel_size != 1:
        raise NotImplementedError("Correlation: kernel_size>1 not supported")
    ps = pad_size
    ap = torch.nn.functional.pad(data1, (ps, ps, ps, ps))
    bp = torch.nn.functional.pad(data2, (ps, ps, ps, ps))
    n, _, hp, wp = ap.shape
    disp = max_displacement
    steps = 2 * (disp // stride2) + 1
    ho = (hp - 2 * disp) // stride1
    wo = (wp - 2 * disp) // stride1
    a_c = ap[:, :, disp:disp + ho * stride1:stride1,
             disp:disp + wo * stride1:stride1]
    out = []
    for dy in range(-disp, disp + 1, stride2):
        for dx in range(-disp, disp + 1, stride2):
            b_c = bp[:, :, disp + dy:disp + dy + ho * stride1:stride1,
                     disp + dx:disp + dx + wo * stride1:stride1]
            if is_multiply:
                out.append((a_c * b_c).mean(dim=1))
            else:
                out.append((a_c - b_c).abs().mean(dim=1))
    return torch.stack(out, dim=1).reshape(n, steps * steps, ho, wo)
