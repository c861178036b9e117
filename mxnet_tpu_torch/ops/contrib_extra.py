"""Contrib detection and pooling ops (counterpart of the detection part
of ``mxnet_tpu.ops.contrib_extra``): ``AdaptiveAvgPooling2D``, the RPN
``Proposal`` (``MultiProposal``), ``PSROIPooling``,
``DeformablePSROIPooling`` and ``RROIAlign``.  Reference files are cited
per op.

Each op keeps the reference's op order and static output shapes
(``Proposal`` returns ``rpn_post_nms_top_n`` rows an image, suppressed
ones zero), batched over the ROIs with tensor ops where the reference
``vmap``s; ``Proposal``'s NMS is ``kernels.box_nms`` through
``contrib.nms_rows``.

The int8 graph ops around the quantized FC and convolution
(``_contrib_quantize``, ``requantize``, ``quantized_act``,
``quantized_flatten``, ``quantized_concat``, ``quantized_elemwise_add``,
``quantized_pooling``, ``quantized_batch_norm`` and
``calibrate_entropy``; reference ``contrib_extra.py:212-350``) keep the
reference's symmetric ranges and ``(out, min, max)`` outputs, in its op
order: every division between tensors (``contrib.div_exact`` for a
constant divisor) and the square root rounded once (``sqrt_rn``).  The
other contrib ops of the same reference file are not ported yet.
"""
from __future__ import annotations

import numpy as _np
import torch

from .contrib import (_batch_index, _f32, div_exact, nms_rows,
                      quant_scale, to_int8)
from .registry import register

__all__ = []


@register("_contrib_AdaptiveAvgPooling2D",
          aliases=("AdaptiveAvgPooling2D", "adaptive_avg_pool2d"))
def _adaptive_avg_pool2d(data, output_size=(1, 1), **_):
    """Adaptive average pooling (reference
    ``src/operator/contrib/adaptive_avg_pooling.cc``): output cell ``o``
    averages input rows ``floor(o H / oh) .. ceil((o + 1) H / oh)``, as
    the reference's pair of overlap-weight matrices ``W_h X W_w^T``."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    elif len(output_size) == 1:
        output_size = (output_size[0], output_size[0])
    oh, ow = int(output_size[0]), int(output_size[1])
    H, W = data.shape[2], data.shape[3]

    def weights(out_n, in_n):
        w = _np.zeros((out_n, in_n), _np.float32)
        for o in range(out_n):
            lo = (o * in_n) // out_n
            hi = -(-((o + 1) * in_n) // out_n)  # ceil
            w[o, lo:hi] = 1.0 / (hi - lo)
        return torch.as_tensor(w, device=data.device).to(data.dtype)

    return torch.einsum("oh,nchw,pw->ncop", weights(oh, H), data,
                        weights(ow, W))


# ------------------------------------------------------------ RPN proposals

def _enum_anchors(scales, ratios, feat_h, feat_w, stride, device):
    """Every anchor of a ``feat_h x feat_w`` map at ``stride``, (H*W*A, 4)
    f32, ordered by position then anchor (the reference's host numpy)."""
    base = float(stride)
    cx = cy = (base - 1) / 2.0
    anchors = []
    for r in ratios:
        size = base * base
        ws = _np.round(_np.sqrt(size / r))
        hs = _np.round(ws * r)
        for s in scales:
            w, h = ws * s, hs * s
            anchors.append([cx - (w - 1) / 2, cy - (h - 1) / 2,
                            cx + (w - 1) / 2, cy + (h - 1) / 2])
    A = _np.asarray(anchors, _np.float32)
    sx = _np.arange(feat_w) * stride
    sy = _np.arange(feat_h) * stride
    gx, gy = _np.meshgrid(sx, sy)
    shifts = _np.stack([gx.ravel(), gy.ravel(), gx.ravel(), gy.ravel()], 1)
    all_a = (A[None, :, :] + shifts[:, None, :]).reshape(-1, 4)
    return torch.as_tensor(all_a.astype(_np.float32), device=device)


def _proposals(scores, deltas, anchors, im_info, pre_n, post_n, threshold,
               rpn_min_size):
    """The reference's ``_proposal_one`` over a batch: ``scores [B, N]``,
    ``deltas [B, N, 4]``, ``anchors [N, 4]``, ``im_info [B, 3]`` ->
    (rois [B, post, 4], scores [B, post, 1])."""
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2
    dx, dy, dw, dh = deltas.unbind(-1)
    cx = dx * aw + acx
    cy = dy * ah + acy
    w = torch.exp(dw.clamp(-10, 10)) * aw
    h = torch.exp(dh.clamp(-10, 10)) * ah
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    hi_x = (im_info[:, 1] - 1)[:, None]
    hi_y = (im_info[:, 0] - 1)[:, None]
    x1 = torch.minimum(torch.maximum(cx - w / 2, zero), hi_x)
    y1 = torch.minimum(torch.maximum(cy - h / 2, zero), hi_y)
    x2 = torch.minimum(torch.maximum(cx + w / 2, zero), hi_x)
    y2 = torch.minimum(torch.maximum(cy + h / 2, zero), hi_y)
    min_size = (rpn_min_size * im_info[:, 2])[:, None]
    keep = ((x2 - x1 + 1) >= min_size) & ((y2 - y1 + 1) >= min_size)
    scores = torch.where(keep, scores, torch.full_like(scores, -1e9))
    k = min(pre_n, scores.shape[1])
    # lax.top_k: the k largest, equal values in index order
    top_idx = torch.sort(scores, dim=1, descending=True,
                         stable=True).indices[:, :k]
    top_scores = torch.gather(scores, 1, top_idx)
    boxes = torch.stack([x1, y1, x2, y2], -1)
    boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    entries = torch.cat([top_scores[..., None], boxes], -1)   # (B, k, 5)
    nms = nms_rows(entries, 0.0, threshold, post_n, 0, 1, -1, True)
    out = nms[:, :post_n]
    s = out[..., 0]
    rois = torch.where(s[..., None] > 0, out[..., 1:5],
                       torch.zeros_like(out[..., 1:5]))
    return rois, s.clamp(min=0.0)[..., None]


@register("_contrib_Proposal", aliases=("Proposal", "_contrib_MultiProposal",
                                        "MultiProposal"),
          differentiable=False, num_outputs=2)
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
              feature_stride=16, output_score=False, iou_loss=False, **_):
    """Region proposals (reference ``src/operator/contrib/proposal.cc``,
    ``multi_proposal.cc``): cls_prob (B, 2A, H, W), bbox_pred (B, 4A, H,
    W), im_info (B, 3) -> (rois (B*post, 5) with the batch index in
    column 0, scores (B*post, 1)).  Each image's deltas decode against
    the anchors, clip to the image, drop boxes under ``rpn_min_size``,
    keep the ``rpn_pre_nms_top_n`` best and run NMS at ``threshold``, of
    which the first ``rpn_post_nms_top_n`` rows may be kept."""
    B, A2, H, W = cls_prob.shape
    A = A2 // 2
    if A != len(scales) * len(ratios):
        raise ValueError(
            "Proposal: cls_prob has %d anchor channels but scales x ratios "
            "gives %d anchors" % (A, len(scales) * len(ratios)))
    anchors = _enum_anchors(scales, ratios, H, W, feature_stride,
                            cls_prob.device)
    fg = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(B, -1)
    deltas = bbox_pred.permute(0, 2, 3, 1).reshape(B, -1, 4)
    rois, scores = _proposals(fg, deltas, anchors, im_info,
                              int(rpn_pre_nms_top_n),
                              int(rpn_post_nms_top_n), float(threshold),
                              float(rpn_min_size))
    batch_ids = torch.arange(B, dtype=rois.dtype, device=rois.device)
    batch_ids = batch_ids.repeat_interleave(rois.shape[1])[:, None]
    return (torch.cat([batch_ids, rois.reshape(-1, 4)], 1),
            scores.reshape(-1, 1))


# ----------------------------------------- position-sensitive ROI pooling

def _tap_bilinear(data, b, ch, y, x):
    """Bilinear taps of ``data (B, C, H, W)``: image ``b [R]``, channels
    ``ch`` (broadcast to the taps' shape ``[R, c, ...]`` with ``y``/``x``
    of shape ``[R, 1, ...]``); zero outside the image (the reference's
    ``_tap_bilinear``, its arithmetic in its order)."""
    _, _, H, W = data.shape
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = y - y0
    wx = x - x0
    bi = b.reshape((-1,) + (1,) * (y.dim() - 1))

    def corner(yy, xx):
        ok = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        yc = yy.clamp(0, H - 1).to(torch.int64)
        xc = xx.clamp(0, W - 1).to(torch.int64)
        return data[bi, ch, yc, xc] * ok.to(data.dtype)

    top = corner(y0, x0) * (1 - wx) + corner(y0, x0 + 1) * wx
    bot = corner(y0 + 1, x0) * (1 - wx) + corner(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _integral(x):
    """2-D integral image over the trailing axes (H, W), a zero row and
    column in front."""
    c = torch.cumsum(torch.cumsum(x, dim=-2), dim=-1)
    return torch.nn.functional.pad(c, (1, 0, 1, 0))


def _bin_channels(C, G, P, device):
    """Input channel of output channel c at bin (gy, gx): ``c G^2 +
    min(gy, G-1) G + min(gx, G-1)``, as ``[C, P, P]``."""
    g = torch.arange(P, device=device).clamp(max=G - 1)
    return (torch.arange(C, device=device)[:, None, None] * G * G
            + g[None, :, None] * G + g[None, None, :])


@register("_contrib_PSROIPooling", aliases=("PSROIPooling",),
          differentiable=False)
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1,
                   pooled_size=1, group_size=0, **_):
    """Position-sensitive ROI pooling (reference
    ``src/operator/contrib/psroi_pooling.cc``): output channel c at bin
    (gy, gx) averages input channel ``c G^2 + gy G + gx`` over the bin,
    each bin's sum read from the integral image -> [R, C, P, P]."""
    B, _, H, W = data.shape
    G = int(group_size) if group_size else int(pooled_size)
    P = int(pooled_size)
    C = int(output_dim)
    dev = data.device
    ii = _integral(data)                            # (B, CGG, H+1, W+1)
    b = _batch_index(rois[:, 0].to(torch.int64), B)
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    rw = (x2 - x1).clamp(min=0.1)[:, None]
    rh = (y2 - y1).clamp(min=0.1)[:, None]
    g = torch.arange(P, dtype=data.dtype, device=dev)
    y0 = torch.floor(y1[:, None] + div_exact(rh * g, P)).to(torch.int64)
    y1_ = torch.ceil(y1[:, None] + div_exact(rh * (g + 1), P)).to(
        torch.int64)
    x0 = torch.floor(x1[:, None] + div_exact(rw * g, P)).to(torch.int64)
    x1_ = torch.ceil(x1[:, None] + div_exact(rw * (g + 1), P)).to(
        torch.int64)
    y0c, y1c = y0.clamp(0, H), y1_.clamp(0, H)      # [R, P]
    x0c, x1c = x0.clamp(0, W), x1_.clamp(0, W)
    ch = _bin_channels(C, G, P, dev)[None]          # [1, C, P, P]
    bi = b[:, None, None, None]
    Y0, Y1 = y0c[:, None, :, None], y1c[:, None, :, None]
    X0, X1 = x0c[:, None, None, :], x1c[:, None, None, :]
    s = (ii[bi, ch, Y1, X1] - ii[bi, ch, Y0, X1]
         - ii[bi, ch, Y1, X0] + ii[bi, ch, Y0, X0])
    area = ((Y1 - Y0) * (X1 - X0)).clamp(min=1)
    return s / area


@register("_contrib_DeformablePSROIPooling",
          aliases=("DeformablePSROIPooling",), differentiable=False,
          num_outputs=2)
def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                              output_dim=1, pooled_size=1, group_size=0,
                              part_size=0, sample_per_part=4, trans_std=0.1,
                              no_trans=False, **_):
    """Deformable PS-ROI pooling (reference
    ``src/operator/contrib/deformable_psroi_pooling.cc``): each bin's
    window shifts by its learned offset (``trans [R, 2, T, T]`` times
    ``trans_std`` and the ROI's size) and averages ``sample_per_part^2``
    bilinear taps -> (pooled [R, C, P, P], zeros of its shape)."""
    P = int(pooled_size)
    G = int(group_size) if group_size else P
    C = int(output_dim)
    S = int(sample_per_part)
    dev = data.device
    b = _batch_index(rois[:, 0].to(torch.int64), data.shape[0])
    x1 = rois[:, 1] * spatial_scale - 0.5
    y1 = rois[:, 2] * spatial_scale - 0.5
    x2 = rois[:, 3] * spatial_scale + 0.5
    y2 = rois[:, 4] * spatial_scale + 0.5
    rw = (x2 - x1).clamp(min=0.1)
    rh = (y2 - y1).clamp(min=0.1)
    bin_w = (rw / P)[:, None, None, None]
    bin_h = (rh / P)[:, None, None, None]
    g = torch.arange(P, dtype=data.dtype, device=dev)
    gy = g[None, None, :, None]
    gx = g[None, None, None, :]
    if no_trans or trans is None:
        dx = dy = 0.0
    else:
        t = trans[:, :, g.to(torch.int64).clamp(max=trans.shape[2] - 1)]
        t = t[:, :, :, g.to(torch.int64).clamp(max=trans.shape[3] - 1)]
        dx = (t[:, 0] * trans_std * rw[:, None, None])[:, None]
        dy = (t[:, 1] * trans_std * rh[:, None, None])[:, None]
    ch = _bin_channels(C, G, P, dev)[None]
    y_base = y1[:, None, None, None] + gy * bin_h
    x_base = x1[:, None, None, None] + gx * bin_w
    acc = torch.zeros((rois.shape[0], C, P, P), dtype=data.dtype,
                      device=dev)
    for sy in range(S):
        for sx in range(S):
            yy = y_base + (sy + 0.5) * bin_h / S + dy
            xx = x_base + (sx + 0.5) * bin_w / S + dx
            acc = acc + _tap_bilinear(data, b, ch, yy, xx)
    pooled = acc / (S * S)
    return pooled, torch.zeros_like(pooled)


@register("_contrib_RROIAlign", aliases=("RROIAlign",),
          differentiable=False)
def _rroi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0, **_):
    """Rotated ROI align (reference ``src/operator/contrib/
    rroi_align.cc``): rois (batch, cx, cy, w, h, angle in degrees); the
    pooled grid's cell centres rotate into the image and are sampled
    bilinearly -> [R, C, ph, pw]."""
    if isinstance(pooled_size, int):
        pooled_size = (pooled_size, pooled_size)
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    dev = data.device
    C = data.shape[1]
    b = _batch_index(rois[:, 0].to(torch.int64), data.shape[0])
    cx = rois[:, 1] * spatial_scale
    cy = rois[:, 2] * spatial_scale
    w = (rois[:, 3] * spatial_scale).clamp(min=1.0)
    h = (rois[:, 4] * spatial_scale).clamp(min=1.0)
    ang = div_exact(rois[:, 5] * _np.pi, 180.0)
    cos, sin = torch.cos(ang), torch.sin(ang)
    ys = div_exact(torch.arange(ph, dtype=data.dtype, device=dev) + 0.5,
                   ph) - 0.5
    xs = div_exact(torch.arange(pw, dtype=data.dtype, device=dev) + 0.5,
                   pw) - 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")

    def per_roi(v):
        return v[:, None, None, None]

    lx = gx[None, None] * per_roi(w)
    ly = gy[None, None] * per_roi(h)
    ix = per_roi(cx) + lx * per_roi(cos) - ly * per_roi(sin)
    iy = per_roi(cy) + lx * per_roi(sin) + ly * per_roi(cos)
    ch = torch.arange(C, device=dev)[None, :, None, None]
    return _tap_bilinear(data, b, ch, iy, ix)


# ------------------------------------------------------------ quantization

def _range_pair(min_range, max_range, like):
    amax = torch.maximum(_f32(min_range, like).abs(),
                         _f32(max_range, like).abs())
    return -amax, amax


@register("_contrib_quantize", aliases=("quantize",), differentiable=False,
          num_outputs=3)
def _quantize(data, min_range, max_range, out_type="int8", **_):
    """f32 -> int8 at an explicit range (reference quantize.cc)."""
    lo, hi = _range_pair(min_range, max_range, data)
    return to_int8(data, quant_scale(hi)), lo.reshape(1), hi.reshape(1)


@register("_contrib_requantize", aliases=("requantize",),
          differentiable=False, num_outputs=3)
def _requantize(data, min_range, max_range, min_calib_range=None,
                max_calib_range=None, **_):
    """int32 accumulator -> int8 at a (re)calibrated range (reference
    requantize.cc)."""
    x = data.to(torch.float32)
    _, hi32 = _range_pair(min_range, max_range, x)
    real = x * div_exact(hi32, 2147483647.0)
    if min_calib_range is not None and max_calib_range is not None:
        lo, hi = _range_pair(min_calib_range, max_calib_range, x)
    else:
        hi = real.abs().max()
        lo = -hi
    return to_int8(real, quant_scale(hi)), lo.reshape(1), hi.reshape(1)


@register("_contrib_quantized_act", aliases=("quantized_act",),
          differentiable=False, num_outputs=3)
def _quantized_act(data, min_data, max_data, act_type="relu", **_):
    """int8 activation (reference quantized_activation.cc): relu keeps
    the int8 grid; the range's low end clips at zero."""
    _, hi = _range_pair(min_data, max_data, data)
    if act_type == "relu":
        return (torch.clamp_min(data, 0),
                torch.zeros(1, dtype=torch.float32, device=data.device),
                hi.reshape(1))
    raise ValueError("quantized_act supports relu only (reference parity)")


@register("_contrib_quantized_flatten", aliases=("quantized_flatten",),
          differentiable=False, num_outputs=3)
def _quantized_flatten(data, min_data, max_data, **_):
    lo, hi = _range_pair(min_data, max_data, data)
    return data.reshape(data.shape[0], -1), lo.reshape(1), hi.reshape(1)


@register("_contrib_quantized_concat", aliases=("quantized_concat",),
          differentiable=False, num_outputs=3)
def _quantized_concat(*args, dim=1, num_args=None, **_):
    """int8 concat (reference quantized_concat.cc): N data tensors, then
    N mins and N maxes; every part is rescaled to the widest range."""
    n = int(num_args) if num_args is not None else len(args) // 3
    datas = [a.to(torch.float32) for a in args[:n]]
    like = datas[0]
    amaxs = [torch.maximum(_f32(lo, like).abs().max(),
                           _f32(hi, like).abs().max())
             for lo, hi in zip(args[n:2 * n], args[2 * n:3 * n])]
    amax = amaxs[0]
    for a in amaxs[1:]:
        amax = torch.maximum(amax, a)
    parts = [torch.clamp(torch.round(d * (a / torch.clamp_min(amax, 1e-12))),
                         -127, 127) for d, a in zip(datas, amaxs)]
    out = torch.cat(parts, dim=int(dim)).to(torch.int8)
    return out, (-amax).reshape(1), amax.reshape(1)


@register("_contrib_quantized_elemwise_add",
          aliases=("quantized_elemwise_add",), differentiable=False,
          num_outputs=3)
def _quantized_elemwise_add(lhs, rhs, min_lhs, max_lhs, min_rhs, max_rhs,
                            **_):
    """int8 add with the ranges merged (reference
    quantized_elemwise_add.cc)."""
    _, ah = _range_pair(min_lhs, max_lhs, lhs)
    _, bh = _range_pair(min_rhs, max_rhs, lhs)
    fa = lhs.to(torch.float32) * div_exact(ah, 127.0)
    fb = rhs.to(torch.float32) * div_exact(bh, 127.0)
    amax = ah + bh
    return (to_int8(fa + fb, quant_scale(amax)), (-amax).reshape(1),
            amax.reshape(1))


@register("_contrib_quantized_pooling", aliases=("quantized_pooling",),
          differentiable=False, num_outputs=3)
def _quantized_pooling(data, min_data, max_data, kernel=(2, 2),
                       pool_type="max", stride=None, pad=None,
                       global_pool=False, **_):
    """int8 pooling (reference quantized_pooling.cc): max stays on the
    int8 grid; avg averages in f32 and rounds again."""
    from .nn import _pooling
    lo, hi = _range_pair(min_data, max_data, data)
    out = _pooling(data.to(torch.float32), kernel=kernel,
                   pool_type=pool_type, stride=stride, pad=pad,
                   global_pool=global_pool)
    if pool_type != "max":
        out = torch.round(out)
    return (torch.clamp(out, -127, 127).to(torch.int8), lo.reshape(1),
            hi.reshape(1))


@register("_contrib_quantized_batch_norm",
          aliases=("quantized_batch_norm",), differentiable=False,
          num_outputs=3)
def _quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                          min_data, max_data, eps=1e-3, **_):
    """int8 inference BatchNorm (reference quantized_batch_norm.cc): the
    affine transform in f32, the output range recalibrated."""
    from .cuda_kernels import sqrt_rn
    _, hi = _range_pair(min_data, max_data, data)
    x = data.to(torch.float32) * div_exact(hi, 127.0)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = (x - moving_mean.reshape(shape)) \
        / sqrt_rn(moving_var.reshape(shape) + eps) \
        * gamma.reshape(shape) + beta.reshape(shape)
    amax = y.abs().max()
    return (to_int8(y, quant_scale(amax)), (-amax).reshape(1),
            amax.reshape(1))


@register("_contrib_calibrate_entropy", aliases=("calibrate_entropy",),
          differentiable=False, num_outputs=2)
def _calibrate_entropy(hist, hist_edges, num_quantized_bins=255, **_):
    """KL-divergence threshold calibration (reference calibrate.cc): the
    host-side search of ``contrib.quantization._kl_threshold``."""
    from ..contrib.quantization import _kl_threshold
    t = _kl_threshold(hist.detach().cpu().numpy(),
                      hist_edges.detach().cpu().numpy(),
                      int(num_quantized_bins))
    return (torch.tensor([-t], dtype=torch.float32, device=hist.device),
            torch.tensor([t], dtype=torch.float32, device=hist.device))
