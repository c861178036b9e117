"""Contrib detection ops (counterpart of the detection part of
``mxnet_tpu.ops.contrib``; reference ``src/operator/contrib/
bounding_box-inl.h``, ``multibox_prior.cc``, ``multibox_target.cc``,
``multibox_detection.cc``, ``bipartite_matching.cc`` and
``src/operator/roi_pooling.cc``).

Each op computes what the reference computes, in its op order, batched
over the leading axes with tensor ops where the reference ``vmap``s.
The reference's forms that exist only to keep XLA's shapes static are
not carried over:

* NMS (``box_nms``, ``MultiBoxDetection``, and ``Proposal`` in
  ``contrib_extra``) sorts the rows (stable, as ``jnp.argsort``) and
  hands the greedy scan to ``kernels.box_nms``: the hand-written kernel
  on CUDA tensors (``csrc/box_nms.cu``), its O(N)-memory plain version
  on the CPU.  No N x N matrix is built.
* ``ROIPooling`` gathers each bin's window (at most the largest bin's
  rows and columns) instead of masking the whole map per bin.

Outputs keep the reference's static shapes: a suppressed row keeps its
place with score -1 (class id -1 in ``MultiBoxDetection``).

The quantization primitives (``_contrib_quantize_v2``,
``_contrib_dequantize``, ``_sim_quant``, and the REAL int8
``_contrib_quantized_fully_connected`` / ``_contrib_quantized_conv``)
quantize as the reference does: ``s = 127 / max(amax, 1e-12)``, then
``clip(round(x * s), -127, 127)`` (half to even, as ``jnp.round``), every
division between tensors (the card divides by a Python scalar as a
product with its reciprocal).  Their int8 products are
``ops.int8.int8_matmul`` / ``int8_conv``: ``torch._int_mm`` on CUDA
tensors, exact int32 ``torch.mm`` on the CPU.
"""
from __future__ import annotations

import numpy as _np
import torch

from .registry import register

__all__ = []


def _corner_iou(a, b):
    """IoU of [..., 4] corner boxes (xmin, ymin, xmax, ymax), broadcast,
    one rounding an operation as the reference's ``_corner_iou``."""
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = (br - tl).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * \
        (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)
    return inter / (area_a + area_b - inter).clamp(min=1e-12)


def _center_to_corner(x):
    cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


@register("box_iou", aliases=("_contrib_box_iou",))
def _box_iou(lhs, rhs, format="corner", **_):
    a, b = lhs, rhs
    if format == "center":
        a = _center_to_corner(a)
        b = _center_to_corner(b)
    return _corner_iou(a.unsqueeze(-2), b.unsqueeze(-3))


def _stable_order(key):
    """Ascending stable order along the last axis (``jnp.argsort``: equal
    keys keep their index order, NaN last)."""
    return torch.sort(key, dim=-1, stable=True).indices


def nms_rows(rows, valid_thresh, overlap_thresh, topk, score_index,
             coord_start, id_index, force_suppress):
    """The reference's ``_nms_one`` over ``rows [M, N, K]``: the rows
    sorted by score (descending, stable; invalid rows, score <=
    ``valid_thresh``, last), with the score of every row the greedy scan
    does not keep set to -1.  The scan is ``kernels.box_nms``."""
    from .. import kernels
    m, n, k = rows.shape
    scores = rows[..., score_index]
    valid = scores > valid_thresh
    key = -torch.where(valid, scores, torch.full_like(scores, -_np.inf))
    order = _stable_order(key)
    srt = torch.gather(rows, 1, order.unsqueeze(-1).expand(m, n, k))
    svalid = torch.gather(valid, 1, order)
    start = max(0, min(int(coord_start), k - 4))  # dynamic_slice clamps
    coords = srt[..., start:start + 4]
    cls = srt[..., id_index] if id_index >= 0 and not force_suppress \
        else None
    if topk > 0:
        svalid = svalid & (torch.arange(n, device=rows.device) < topk)
    keep = kernels.box_nms(coords.detach(),
                           None if cls is None else cls.detach(), svalid,
                           overlap_thresh)
    out = srt.clone()
    out[..., score_index] = torch.where(keep, srt[..., score_index],
                                        torch.full_like(scores, -1.0))
    return out


@register("box_nms", aliases=("_contrib_box_nms",
                              "box_non_maximum_suppression",
                              "_contrib_box_non_maximum_suppression"))
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1,
             force_suppress=False, in_format="corner",
             out_format="corner", **_):
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    out = nms_rows(flat, valid_thresh, overlap_thresh, int(topk),
                   int(score_index), int(coord_start), int(id_index),
                   bool(force_suppress))
    return out.reshape(shape)


@register("bipartite_matching", aliases=("_contrib_bipartite_matching",),
          differentiable=False, num_outputs=2)
def _bipartite_matching(dist, is_ascend=False, threshold=0.5, topk=-1, **_):
    """Greedy bipartite matching over ``dist [..., N, M]``: min(N, M) (or
    ``topk``) rounds, each claiming the best remaining entry (the first
    in row-major order on ties) when it passes ``threshold`` and retiring
    its row and column either way.  Returns ``(row -> column or -1,
    column used)`` as f32."""
    shape = dist.shape
    n, m = shape[-2], shape[-1]
    dd = dist.reshape((-1, n, m)).clone()
    b = dd.shape[0]
    big = float("inf") if is_ascend else -float("inf")
    rows = torch.full((b, n), -1, dtype=torch.int64, device=dist.device)
    cols = torch.zeros((b, m), dtype=torch.int64, device=dist.device)
    ar = torch.arange(b, device=dist.device)
    iters = min(n, m) if topk <= 0 else min(topk, min(n, m))
    for _ in range(iters):
        flat = dd.reshape(b, n * m)
        idx = flat.argmin(dim=1) if is_ascend else flat.argmax(dim=1)
        i, j = idx // m, idx % m
        val = dd[ar, i, j]
        ok = (val <= threshold) if is_ascend else (val >= threshold)
        rows[ar, i] = torch.where(ok, j, rows[ar, i])
        cols[ar, j] = torch.where(ok, torch.ones_like(j), cols[ar, j])
        dd[ar, i, :] = big
        dd[ar, :, j] = big
    return (rows.to(torch.float32).reshape(shape[:-1]),
            cols.to(torch.float32).reshape(tuple(shape[:-2]) + (m,)))


def div_exact(x, d):
    """``x / d`` for a Python number ``d``, one IEEE division on every
    device: the card divides by a Python scalar as a product with its
    reciprocal, which can miss by an ulp (and then a floor by one)."""
    return x / torch.tensor(float(d), dtype=x.dtype, device=x.device)


def _batch_index(idx, size):
    """JAX's gather index rule: negative indices count from the end, and
    out-of-range ones clamp."""
    idx = torch.where(idx < 0, idx + size, idx)
    return idx.clamp(0, size - 1)


@register("ROIPooling", aliases=("roi_pooling",))
def _roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0, **_):
    """ROI max pooling: data [B, C, H, W]; rois [R, 5] (batch index, x1,
    y1, x2, y2) -> [R, C, ph, pw].  The bins are the reference's (rounded
    scaled corners, floor/ceil bin edges clipped to the map); each bin's
    window is gathered, padded to the largest bin and masked, one bin at
    a time."""
    B, C, H, W = data.shape
    ph, pw = (int(v) for v in pooled_size)
    r = rois.shape[0]
    dev = data.device
    b = _batch_index(rois[:, 0].to(torch.int64), B)
    x1, y1, x2, y2 = torch.round(rois[:, 1:5] * spatial_scale).unbind(1)
    h = (y2 - y1 + 1).clamp(min=1.0)
    w = (x2 - x1 + 1).clamp(min=1.0)

    def edges(lo, size, p, limit):
        step = torch.arange(p, dtype=data.dtype, device=dev)
        start = torch.floor(lo[:, None] + div_exact(step, p) * size[:, None])
        end = torch.ceil(lo[:, None]
                         + div_exact(step + 1, p) * size[:, None])
        return (start.clamp(0, limit - 1).to(torch.int64),
                end.clamp(1, limit).to(torch.int64))

    y_lo, y_hi = edges(y1, h, ph, H)
    x_lo, x_hi = edges(x1, w, pw, W)
    out = data.new_empty((r, C, ph, pw))
    if r == 0:
        return out
    span_y = int((y_hi - y_lo).max())
    span_x = int((x_hi - x_lo).max())
    oy = torch.arange(span_y, device=dev)
    ox = torch.arange(span_x, device=dev)
    neg = torch.tensor(-float("inf"), dtype=data.dtype, device=dev)
    for p in range(ph):
        yy = y_lo[:, p, None] + oy                       # [R, sy]
        ymask = yy < y_hi[:, p, None]
        yy = yy.clamp(max=H - 1)
        for q in range(pw):
            xx = x_lo[:, q, None] + ox                   # [R, sx]
            xmask = xx < x_hi[:, q, None]
            xx = xx.clamp(max=W - 1)
            win = data[b[:, None, None], :, yy[:, :, None],
                       xx[:, None, :]]                   # [R, sy, sx, C]
            keep = (ymask[:, :, None] & xmask[:, None, :])[..., None]
            out[:, :, p, q] = torch.where(keep, win, neg).amax(dim=(1, 2))
    return out


def _sqrt_f32(x):
    """``jnp.sqrt`` of a Python float, in f32 and correctly rounded."""
    return _np.float32(_np.sqrt(_np.float64(_np.float32(x))))


@register("MultiBoxPrior", aliases=("_contrib_MultiBoxPrior",),
          differentiable=False)
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5), **_):
    """SSD anchors: data [B, C, H, W] -> [1, H*W*(S+R-1), 4] corner boxes,
    ordered by row, column, then anchor (the sizes at the first ratio,
    then the other ratios at the first size)."""
    H, W = data.shape[-2], data.shape[-1]
    sizes = tuple(sizes)
    ratios = tuple(ratios)
    dev = data.device
    step_y = steps[1] if steps[1] > 0 else 1.0 / H
    step_x = steps[0] if steps[0] > 0 else 1.0 / W
    cy = (torch.arange(H, dtype=torch.float32, device=dev)
          + offsets[1]) * step_y
    cx = (torch.arange(W, dtype=torch.float32, device=dev)
          + offsets[0]) * step_x
    whs = []
    r0 = _sqrt_f32(ratios[0])
    for s in sizes:
        whs.append((_np.float32(s) * r0, _np.float32(s) / r0))
    for rt in ratios[1:]:
        sr = _sqrt_f32(rt)
        whs.append((_np.float32(sizes[0]) * sr, _np.float32(sizes[0]) / sr))
    whs = torch.as_tensor(_np.asarray(whs, _np.float32), device=dev)
    w = whs[:, 0] / 2
    h = whs[:, 1] / 2
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    gy = gy[:, :, None]
    gx = gx[:, :, None]
    anchors = torch.stack([gx - w, gy - h, gx + w, gy + h], dim=-1)
    anchors = anchors.reshape(1, -1, 4)
    if clip:
        anchors = anchors.clamp(0.0, 1.0)
    return anchors


@register("box_encode", aliases=("_contrib_box_encode",), num_outputs=2)
def _box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
                stds=(0.1, 0.1, 0.2, 0.2), **_):
    """Matched boxes as regression targets against their anchors; returns
    ``(targets [..., N, 4] zero where not matched, mask [..., N, 1])``."""
    a = anchors
    idx = _batch_index(matches.to(torch.int64), refs.shape[-2])
    g = torch.take_along_dim(refs, idx.unsqueeze(-1), dim=-2)
    aw = a[..., 2] - a[..., 0]
    ah = a[..., 3] - a[..., 1]
    ax = (a[..., 0] + a[..., 2]) / 2
    ay = (a[..., 1] + a[..., 3]) / 2
    gw = g[..., 2] - g[..., 0]
    gh = g[..., 3] - g[..., 1]
    gx = (g[..., 0] + g[..., 2]) / 2
    gy = (g[..., 1] + g[..., 3]) / 2
    aw_ = aw.clamp(min=1e-12)
    ah_ = ah.clamp(min=1e-12)
    tx = ((gx - ax) / aw_ - means[0]) / stds[0]
    ty = ((gy - ay) / ah_ - means[1]) / stds[1]
    tw = (torch.log((gw / aw_).clamp(min=1e-12)) - means[2]) / stds[2]
    th = (torch.log((gh / ah_).clamp(min=1e-12)) - means[3]) / stds[3]
    targets = torch.stack([tx, ty, tw, th], dim=-1)
    mask = (samples > 0.5).unsqueeze(-1)
    return (torch.where(mask, targets, torch.zeros_like(targets)),
            mask.to(targets.dtype))


@register("box_decode", aliases=("_contrib_box_decode",))
def _box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
                clip=-1.0, format="corner", **_):
    d, a = data, anchors
    if format == "corner":
        aw = a[..., 2] - a[..., 0]
        ah = a[..., 3] - a[..., 1]
        ax = (a[..., 0] + a[..., 2]) / 2
        ay = (a[..., 1] + a[..., 3]) / 2
    else:
        ax, ay, aw, ah = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    ox = d[..., 0] * std0 * aw + ax
    oy = d[..., 1] * std1 * ah + ay
    dw = d[..., 2] * std2
    dh = d[..., 3] * std3
    if clip > 0:
        dw = dw.clamp(max=clip)
        dh = dh.clamp(max=clip)
    ow = torch.exp(dw) * aw / 2
    oh = torch.exp(dh) * ah / 2
    return torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)


@register("MultiBoxTarget", aliases=("_contrib_MultiBoxTarget",),
          differentiable=False, num_outputs=3)
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5,
                     variances=(0.1, 0.1, 0.2, 0.2), **_):
    """SSD training targets: anchor (1, N, 4) corner boxes; label (B, M,
    5+) rows [cls, x1, y1, x2, y2] padded with -1; cls_pred (B, C+1, N).
    Returns (box_target (B, N*4), box_mask (B, N*4), cls_target (B, N)).

    Each valid ground truth with a positive overlap claims its best
    remaining anchor by greedy bipartite matching (threshold 1e-12); an
    anchor also matches its best ground truth at ``overlap_threshold``.
    With ``negative_mining_ratio`` > 0 the unmatched anchors below
    ``negative_mining_thresh`` are ranked by their largest foreground
    score (stable) and ``ratio`` x positives of them become background;
    the other anchors get ``ignore_label``."""
    a = anchor[0]                                        # (N, 4)
    lab = label
    B = lab.shape[0]
    N = a.shape[0]
    dev = a.device
    valid = lab[:, :, 0] >= 0                            # (B, M)
    gt = lab[:, :, 1:5]
    iou = _corner_iou(a[None, :, None, :], gt[:, None, :, :])  # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=2)
    best_gt = iou.argmax(dim=2)
    forced_f, _ = _bipartite_matching(iou, is_ascend=False,
                                      threshold=1e-12)
    forced_gt = forced_f.to(torch.int64)
    forced = forced_gt >= 0
    matched = forced | (best_iou >= overlap_threshold)
    gt_idx = torch.where(forced, forced_gt.clamp(min=0), best_gt)
    t, m = _box_encode(matched.to(torch.float32), gt_idx,
                       a.expand(B, N, 4), gt,
                       stds=tuple(float(v) for v in variances))
    box_t = t.reshape(B, -1)
    box_m = m.expand(t.shape).reshape(B, -1)
    neg_cand = ~matched & (best_iou < negative_mining_thresh)
    if negative_mining_ratio > 0:
        fg_score = cls_pred[:, 1:].amax(dim=1)            # (B, N)
        key = torch.where(neg_cand, -fg_score,
                          torch.full_like(fg_score, _np.inf))
        order = _stable_order(key)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(N, device=dev).expand(B, N))
        n_pos = matched.to(torch.int32).sum(dim=1, keepdim=True)
        limit = negative_mining_ratio * n_pos.clamp(min=1).to(torch.float32)
        keep_neg = neg_cand & (rank.to(torch.float32) < limit)
    else:
        keep_neg = neg_cand
    gt_cls = torch.gather(lab[:, :, 0], 1, gt_idx)
    cls_t = torch.where(matched, gt_cls + 1.0,
                        torch.where(keep_neg, torch.zeros_like(gt_cls),
                                    torch.full_like(gt_cls, ignore_label)))
    return box_t, box_m, cls_t


@register("MultiBoxDetection", aliases=("_contrib_MultiBoxDetection",),
          differentiable=False)
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, nms_threshold=0.5,
                        force_suppress=False, nms_topk=-1,
                        variances=(0.1, 0.1, 0.2, 0.2), **_):
    """SSD decode and per-class NMS: cls_prob (B, C+1, N) softmax scores
    (class 0 is background); loc_pred (B, N*4); anchor (1, N, 4).  Output
    (B, N, 6) rows [class_id, score, x1, y1, x2, y2] sorted by score,
    suppressed rows with class id -1."""
    B, C1, N = cls_prob.shape
    v0, v1, v2, v3 = (float(v) for v in variances)
    boxes = _box_decode(loc_pred.reshape(B, N, 4), anchor[0], v0, v1, v2,
                        v3)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    fg = cls_prob[:, 1:]
    cls_id = fg.argmax(dim=1).to(torch.float32)            # (B, N)
    score = fg.amax(dim=1)
    keep = score > threshold
    neg1 = torch.full_like(score, -1.0)
    rows = torch.cat([torch.where(keep, cls_id, neg1)[..., None],
                      torch.where(keep, score, neg1)[..., None], boxes],
                     dim=-1)
    out = nms_rows(rows, 0.0, nms_threshold, int(nms_topk), 1, 2, 0,
                   bool(force_suppress))
    out[..., 0] = torch.where(out[..., 1] > 0, out[..., 0], neg1)
    return out


# ----------------------------------------------------- quantization primitives
# (reference ``mxnet_tpu/ops/contrib.py:264-360``)

def _f32(v, like):
    """``v`` (a number or tensor) as an f32 tensor on ``like``'s device."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.float32)
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def quant_scale(amax):
    """``127 / max(amax, 1e-12)`` in f32, one IEEE division."""
    amax = amax.to(torch.float32)
    return torch.full_like(amax, 127.0) / torch.clamp_min(amax, 1e-12)


def to_int8(x, scale):
    """``clip(round(x * scale), -127, 127)`` as int8."""
    return torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)


@register("_contrib_quantize_v2", aliases=("quantize_v2",),
          differentiable=False, num_outputs=3)
def _quantize_v2(data, min_calib_range=None, max_calib_range=None,
                 out_type="int8", **_):
    x = data
    lo = _f32(min_calib_range, x) if min_calib_range is not None \
        else x.min().to(torch.float32)
    hi = _f32(max_calib_range, x) if max_calib_range is not None \
        else x.max().to(torch.float32)
    amax = torch.maximum(lo.abs(), hi.abs())
    return to_int8(x, quant_scale(amax)), -amax, amax


@register("_contrib_dequantize", aliases=("dequantize",),
          differentiable=False)
def _dequantize(data, min_range, max_range, out_type="float32", **_):
    amax = torch.maximum(_f32(min_range, data).abs(),
                         _f32(max_range, data).abs())
    return data.to(torch.float32) * div_exact(amax, 127.0)


@register("_sim_quant", differentiable=False)
def _sim_quant(data, amax=1.0, **_):
    """Simulated int8: round onto the int8 grid, stay f32 (the scale is
    the reference's Python double, taken to f32 as JAX's weak typing
    does)."""
    s = _f32(127.0 / max(float(amax), 1e-12), data)
    return torch.clamp(torch.round(data * s), -127, 127) / s


def data_scale(x, amax):
    """The per-tensor scale ``127 / max(amax, 1e-12)`` at ``amax`` (a
    number or a tensor), or at the tensor's own ``|max|`` where ``amax``
    is not positive (the dynamic range)."""
    if isinstance(amax, torch.Tensor):
        amax = amax.to(torch.float32)
        amax = torch.where(amax > 0, amax, x.abs().max().to(torch.float32))
    elif float(amax) > 0:
        amax = _f32(amax, x)
    else:
        amax = x.abs().max().to(torch.float32)
    return quant_scale(amax)


def _to_int8(x, amax):
    """Symmetric per-tensor int8 at :func:`data_scale`."""
    s = data_scale(x, amax)
    return to_int8(x, s), s


@register("_contrib_quantized_fully_connected",
          aliases=("quantized_fully_connected",), differentiable=False)
def _quantized_fully_connected(data, weight, bias=None, amax_data=1.0,
                               amax_weight=1.0, num_hidden=None,
                               no_bias=False, flatten=True, **_):
    """REAL int8 dense: both operands quantized per tensor, the product
    in int8 with exact int32 accumulation, rescaled to f32."""
    from .int8 import int8_matmul
    x = data.reshape(data.shape[0], -1) if flatten else data
    xq, sx = _to_int8(x, amax_data)
    wq, sw = _to_int8(weight, amax_weight)
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), wq)
    acc = acc.reshape(tuple(xq.shape[:-1]) + (wq.shape[0],))
    out = acc.to(torch.float32) / (sx * sw)
    if bias is not None and not no_bias:
        out = out + bias
    return out


@register("_contrib_quantized_conv", aliases=("quantized_conv",),
          differentiable=False)
def _quantized_conv(data, weight, bias=None, amax_data=1.0, amax_weight=1.0,
                    kernel=None, stride=None, dilate=None, pad=None,
                    num_filter=None, num_group=1, no_bias=False, layout=None,
                    **_):
    """REAL int8 convolution with exact int32 accumulation."""
    from .int8 import int8_conv
    ndim = data.dim() - 2
    xq, sx = _to_int8(data, amax_data)
    wq, sw = _to_int8(weight, amax_weight)
    acc = int8_conv(xq, wq, stride, pad if pad is not None else 0, dilate,
                    int(num_group))
    out = acc.to(torch.float32) / (sx * sw)
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * ndim)
    return out
