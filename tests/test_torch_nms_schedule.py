"""The NMS kernel's schedule (``csrc/box_nms.cu``) emulated on the CPU and
held bitwise against the plain greedy scan (``box_nms_sorted_plain``),
and through it against the reference's ``box_nms``.

The kernel cannot run here (no card, no nvcc), so this file checks the
design's logic at small sizes:

* step 1, the segments: :func:`cuda_kernels.nms_sort` (the function the
  wrapper calls) and the kernel's start test and binary search, written
  out in Python, against the segments defined by hand (valid rows by
  class, -0.0 with 0.0, a NaN class alone, one segment an image without
  classes or under a negative or NaN threshold);
* steps 1-2, the scan: segments of at most ``block_rows`` rows walked in
  64-row tiles (the tile's rows against the rows kept so far, the tile's
  own bits, the tile resolved first-alive-first as the warp does it),
  longer ones in chunks of ``block_rows`` (a chunk's rows against the
  rows kept in earlier chunks, then the chunk walked with those rows
  removed), at small ``block_rows`` so the chunked pass runs.

Each IoU rounds as the kernel's and the plain version's (one rounding an
operation, the earlier row as operand a), so the keep masks are compared
bit for bit.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the reference's ops)
from mxnet_tpu.ops.registry import _REGISTRY as REF_OPS

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import cuda_kernels as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

TILE = 64


def _segments(order, valid):
    """Step 1 as the kernel runs it: ``([(lo, hi)], rows)``, each segment
    a range of positions and ``rows[q]`` the flat row at position q.
    Sorted keys (``order`` from ``nms_sort``): a valid row that differs
    from the position before it in key or image starts a segment, whose
    end is the binary search over that key and image (a NaN key ends at
    once).  No keys: each image is one segment of positions."""
    b, n = valid.shape
    if order is None:
        return [(i * n, (i + 1) * n) for i in range(b)], torch.arange(b * n)
    keys, rows = order
    k = keys.numpy()
    img = (rows // n).numpy()
    v = valid.reshape(-1).numpy()

    def same(q, p):
        return k[q] == k[p] and img[q] == img[p]

    out = []
    for q in range(b * n):
        if not v[rows[q]] or (q and same(q - 1, q)):
            continue
        lo, hi = q + 1, b * n
        if np.isnan(k[q]):
            hi = lo
        while lo < hi:
            mid = lo + (hi - lo) // 2
            if same(mid, q):
                lo = mid + 1
            else:
                hi = mid
        out.append((q, lo))
    return out, rows


def _suppresses(a, aa, ca, b, ab, cb, thresh, class_aware):
    """``[ka, kb]``: earlier rows ``a`` suppress later rows ``b``, the
    kernel's pair test (the IoU as ``_iou_later`` rounds it; with
    ``class_aware`` rows of other classes count 0)."""
    w = (torch.minimum(a[:, None, 2], b[None, :, 2])
         - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp(min=0)
    h = (torch.minimum(a[:, None, 3], b[None, :, 3])
         - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp(min=0)
    inter = w * h
    v = inter / (aa[:, None] + ab[None, :] - inter).clamp(min=1e-12)
    if class_aware:
        v = torch.where(ca[:, None] == cb[None, :], v, torch.zeros_like(v))
    return v > thresh


def _walk(box, area, cls, thresh, class_aware):
    """The kernel's ``walk`` over the staged (live) rows: ``(keep [m]
    bool, kept indices in order)``."""
    m = box.shape[0]
    keep = np.zeros(m, dtype=bool)
    kept = []
    for t0 in range(0, m, TILE):
        idx = torch.arange(t0, min(t0 + TILE, m))
        sup = torch.zeros(len(idx), dtype=torch.bool)
        if kept:
            k = torch.tensor(kept)
            sup = _suppresses(box[k], area[k], cls[k], box[idx], area[idx],
                              cls[idx], thresh, class_aware).any(0)
        bits = torch.triu(_suppresses(box[idx], area[idx], cls[idx],
                                      box[idx], area[idx], cls[idx], thresh,
                                      class_aware), diagonal=1).numpy()
        alive = (~sup).numpy().copy()
        while alive.any():       # the warp: first alive row kept, its bits
            r = int(np.argmax(alive))
            keep[t0 + r] = True
            kept.append(t0 + r)
            alive[r] = False
            alive &= ~bits[r]
    return keep, kept


def emulate(coords, cls, valid, thresh, block_rows=ck.NMS_BLOCK_ROWS):
    """The keep mask ``[B, N]`` the kernel's schedule gives: segments of
    at most ``block_rows`` positions (or images of at most that many
    valid rows) staged and walked whole, longer ones a chunk of
    ``block_rows`` positions at a time (the chunk's valid rows tested
    against the rows kept in earlier chunks, the rest walked)."""
    b, n = valid.shape
    order = ck.nms_sort(cls, valid, thresh)
    class_aware = cls is not None and not ck.nms_by_class(cls, thresh)
    flat = coords.reshape(-1, 4)
    area = ck._box_area(flat)
    fcls = cls.reshape(-1) if cls is not None else torch.zeros(b * n)
    fvalid = valid.reshape(-1)
    keep = np.zeros(b * n, dtype=bool)
    segments, rows = _segments(order, valid)
    for lo, hi in segments:
        kbox = torch.zeros((0, 4))
        karea = kcls = torch.zeros(0)
        step = block_rows                         # one chunk if it fits,
        if order is None and hi - lo <= 65535 and \
                int(fvalid[rows[lo:hi]].sum()) <= block_rows:
            step = hi - lo                        # or its valid rows do
        for q0 in range(lo, hi, step):
            r = rows[q0:min(q0 + step, hi)]
            r = r[fvalid[r]]
            if len(kbox):
                r = r[~_suppresses(kbox, karea, kcls, flat[r], area[r],
                                   fcls[r], thresh, class_aware).any(0)]
            got, kept = _walk(flat[r], area[r], fcls[r], thresh,
                              class_aware)
            keep[r.numpy()] = got
            k = r[torch.tensor(kept, dtype=torch.long)]
            kbox = torch.cat([kbox, flat[k]])
            karea = torch.cat([karea, area[k]])
            kcls = torch.cat([kcls, fcls[k]])
    return torch.from_numpy(keep.reshape(b, n))


def _rows(seed, b=2, n=200, classes=3, p_valid=0.8, levels=0):
    """Sorted rows: boxes clustered so that many overlap, random classes,
    a valid mask that is not a prefix."""
    rng = np.random.RandomState(seed)
    boxes = np.stack([chip_smoke._det_boxes(np, rng, n, 0.0, 0.5, 0.1, 0.4)
                      for _ in range(b)])
    if levels:
        boxes = np.floor(boxes * levels) / levels
    cls = rng.randint(0, classes, (b, n)).astype(np.float32)
    valid = rng.rand(b, n) < p_valid
    return (torch.from_numpy(boxes), torch.from_numpy(cls),
            torch.from_numpy(valid))


def _case(name):
    coords, cls, valid = _rows(7)
    if name == "nan_class":
        cls[0, ::7] = float("nan")
    elif name == "signed_zero":
        cls[:, ::2] = torch.where(torch.arange(cls.shape[1])[::2] % 4 == 0,
                                  -0.0, 0.0)
    elif name == "duplicates":       # identical boxes: IoU exactly 1
        coords[:, 1::2] = coords[:, ::2]
    elif name == "grid":             # IoUs exactly 0.5, integer corners
        g = torch.from_numpy(chip_smoke._grid_rows(np, 200))[0]
        coords = g[None, :, 2:].repeat(2, 1, 1).contiguous()
        cls = g[None, :, 0].repeat(2, 1).contiguous()
    elif name == "topk":
        valid &= torch.arange(valid.shape[1]) < 90
    elif name == "empty_image":
        valid[1] = False
    elif name == "singletons":
        cls = torch.arange(cls.numel(), dtype=torch.float32).reshape(
            cls.shape)
    elif name == "all_valid":
        valid[:] = True
    elif name == "quantized":        # many equal corners and areas
        coords, cls, valid = _rows(8, levels=8)
    return coords, cls, valid


CASES = ["random", "nan_class", "signed_zero", "duplicates", "grid", "topk",
         "empty_image", "singletons", "all_valid", "quantized"]
#: (threshold, classes given): class by class, a threshold of 0, rows of
#: other classes suppressing (negative), nothing suppressing (NaN), and
#: one scan over all classes (no class ids)
MODES = [(0.4, True), (0.0, True), (-0.25, True), (float("nan"), True),
         (0.4, False)]


@pytest.mark.parametrize("block_rows", [64, 128, ck.NMS_BLOCK_ROWS])
@pytest.mark.parametrize("mode", MODES, ids=["t0.4", "t0", "neg", "nan",
                                             "any_class"])
@pytest.mark.parametrize("name", CASES)
def test_schedule_is_the_plain_scan_bitwise(name, mode, block_rows):
    coords, cls, valid = _case(name)
    thresh, with_cls = mode
    cls = cls if with_cls else None
    want = ck.box_nms_sorted_plain(coords, cls, valid, thresh)
    got = emulate(coords, cls, valid, thresh, block_rows)
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("mode", MODES, ids=["t0.4", "t0", "neg", "nan",
                                             "any_class"])
@pytest.mark.parametrize("name", ["random", "nan_class", "signed_zero",
                                  "empty_image", "singletons"])
def test_segments_are_the_scans_groups(name, mode):
    """Step 1's segments, against the groups defined by hand: with
    classes and a threshold >= 0 the valid rows of each class value
    (-0.0 one with 0.0), a NaN class alone; else each image's valid
    rows.  Each in score order; invalid rows are in none (unsorted, the
    kernel skips them as it stages an image)."""
    coords, cls, valid = _case(name)
    thresh, with_cls = mode
    cls = cls if with_cls else None
    b, n = valid.shape
    order = ck.nms_sort(cls, valid, thresh)
    assert (order is None) == (not ck.nms_by_class(cls, thresh))
    if order is not None:
        # a radix sort on the keys' bits (the card's) gives the same
        # order: no -0.0 beside a 0.0, so equal keys are equal bits
        keys = order[0]
        bits = keys[~torch.isnan(keys)].view(torch.int32).long()
        ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
        assert bool((ordered[1:] >= ordered[:-1]).all())
    segments, rows = _segments(order, valid)
    fvalid = valid.reshape(-1)
    got = sorted(tuple(i for i in rows[lo:hi].tolist() if fvalid[i])
                 for lo, hi in segments)
    got = [g for g in got if g]
    want = []
    for img in range(b):
        groups = {}
        for i in range(n):
            if not valid[img, i]:
                continue
            if not ck.nms_by_class(cls, thresh):
                key = "all"
            elif np.isnan(float(cls[img, i])):
                key = ("nan", i)
            else:
                key = float(cls[img, i]) + 0.0      # -0.0 -> 0.0
            groups.setdefault(key, []).append(img * n + i)
        want += [tuple(g) for g in groups.values()]
    assert got == sorted(want)


def _ref(op, arrays, attrs):
    outs = jax.jit(lambda *xs: REF_OPS[op].fn(*xs, **attrs))(*arrays)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_box_nms_through_the_schedule_is_the_references(seed,
                                                        monkeypatch):
    """The port's ``box_nms`` op with its scan routed through the
    emulated schedule (chunks of 64 rows) against the reference's op:
    ties, ``topk``, ``force_suppress``, id_index -1, a NaN class and a
    negative threshold, the whole output bitwise."""
    monkeypatch.setattr(ck, "box_nms_sorted",
                        lambda c, k, v, t: emulate(c, k, v, t, 64))
    rng = np.random.RandomState(seed)
    rows = chip_smoke._nms_rows(np, rng, 2, 150, classes=2, levels=16)
    attrs = {"overlap_thresh": float(rng.uniform(0.2, 0.6)),
             "valid_thresh": 0.1, "topk": 100 + seed,
             "id_index": 0 if seed % 2 else -1,
             "force_suppress": seed == 3}
    if seed == 4:
        rows[:, 5, 0] = np.nan
        attrs.update(overlap_thresh=-0.25, id_index=0, topk=-1)
    got = chip_smoke.run_det_op(mt, "box_nms", [rows], attrs, mt.cpu())
    np.testing.assert_array_equal(got[0], _ref("box_nms", [rows], attrs)[0])
