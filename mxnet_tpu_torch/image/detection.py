"""Detection augmenters: joint image and bounding-box transforms
(counterpart of ``mxnet_tpu.image.detection``; reference
``python/mxnet/image/detection.py`` over
``src/io/image_det_aug_default.cc``).

Labels are ``(n, 5+)`` float arrays, rows ``[cls, x1, y1, x2, y2, ...]``
with the corners normalised to [0, 1]; a row with ``cls < 0`` is
padding.  Every augmenter maps ``(src, label) -> (src, label)`` on the
host (HWC images as CPU NDArrays, as ``mx.image``'s augmenters), and
never changes the number of label rows: an object that leaves a crop
gets class -1.

Randomness: an augmenter that draws holds its own CPU
``torch.Generator`` (``generator=``, else seeded from ``mx.random``'s
stream) and splits its draw, ``params(src, label)``, from its
arithmetic, ``apply(src, label, *params)``, as ``mx.image``'s drawing
augmenters do.  The draws go through ``image.image._uniform`` and
``_randint``.
"""
from __future__ import annotations

import json

import numpy as _np

from . import image as _image

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter"]


class DetAugmenter:
    """Base detection augmenter (reference: ``detection.py`` DetAugmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class _DetDrawing(DetAugmenter):
    """A detection augmenter that draws: ``__call__(src, label)`` is
    ``apply(src, label, *params(src, label))`` with its own generator."""

    def __init__(self, generator=None, **kwargs):
        super().__init__(**kwargs)
        self._gen = _image._generator(generator)

    def params(self, src, label):
        raise NotImplementedError

    def apply(self, src, label, *params):
        raise NotImplementedError

    def __call__(self, src, label):
        return self.apply(src, label, *self.params(src, label))


class DetBorrowAug(DetAugmenter):
    """An image-only augmenter in the detection chain; the labels pass
    through (reference ``detection.py:70``)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(_DetDrawing):
    """One of ``aug_list`` at random, or none with probability
    ``skip_prob`` (reference ``detection.py:84``).  ``params``: the index
    of the chosen augmenter, or None."""

    def __init__(self, aug_list, skip_prob=0.0, generator=None):
        super().__init__(generator, skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def params(self, src, label):
        if _image._uniform(self._gen, 0.0, 1.0) < self.skip_prob \
                or not self.aug_list:
            return (None,)
        return (_image._randint(self._gen, 0, len(self.aug_list) - 1),)

    def apply(self, src, label, index):
        if index is None:
            return src, label
        return self.aug_list[index](src, label)


class DetHorizontalFlipAug(_DetDrawing):
    """Flip the image and mirror the boxes' x corners with probability
    ``p`` (reference ``detection.py:103``).  ``params``: whether to flip."""

    def __init__(self, p, generator=None):
        super().__init__(generator, p=p)
        self.p = p

    def params(self, src, label):
        return (_image._uniform(self._gen, 0.0, 1.0) < self.p,)

    def apply(self, src, label, flip):
        if not flip:
            return src, label
        arr = _image._to_np(src)[:, ::-1, :]
        label = _np.array(label, _np.float32, copy=True)
        valid = label[:, 0] >= 0
        x1 = label[valid, 1].copy()
        x2 = label[valid, 3].copy()
        label[valid, 1] = 1.0 - x2
        label[valid, 3] = 1.0 - x1
        return _image._nd(arr), label


def _box_coverage(crop, boxes):
    """How much of each of ``boxes (n, 4)`` one crop covers: intersection
    over the box's area (the reference's ``min_object_covered`` rule,
    not IoU)."""
    tl = _np.maximum(crop[:2], boxes[:, :2])
    br = _np.minimum(crop[2:], boxes[:, 2:4])
    wh = _np.clip(br - tl, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / _np.maximum(area_b, 1e-12)


class DetRandomCropAug(_DetDrawing):
    """SSD's constrained random crop (reference ``detection.py:161``):
    crops are drawn until one covers some object at least
    ``min_object_covered``; the boxes are moved into the crop and clipped,
    and an object whose centre left it gets class -1.  ``params``: the
    crop ``[x0, y0, x1, y1]`` (normalised, f32), or None when no draw
    passed."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75,
                 1.33), area_range=(0.05, 1.0), max_attempts=50,
                 generator=None):
        super().__init__(generator, min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def params(self, src, label):
        label = _np.asarray(label, _np.float32)
        for _ in range(self.max_attempts):
            area = _image._uniform(self._gen, *self.area_range)
            ar = _image._uniform(self._gen, *self.aspect_ratio_range)
            w = min(_np.sqrt(area * ar), 1.0)
            h = min(_np.sqrt(area / ar), 1.0)
            x0 = _image._uniform(self._gen, 0, 1 - w)
            y0 = _image._uniform(self._gen, 0, 1 - h)
            crop = _np.array([x0, y0, x0 + w, y0 + h], _np.float32)
            valid = label[:, 0] >= 0
            if not valid.any():
                return (crop,)
            cov = _box_coverage(crop, label[valid, 1:5])
            if cov.max() >= self.min_object_covered:
                return (crop,)
        return (None,)

    def apply(self, src, label, crop):
        label = _np.array(label, _np.float32, copy=True)
        if crop is None:
            return src, label
        arr = _image._to_np(src)
        h, w = arr.shape[:2]
        x0, y0, x1, y1 = crop
        px0, py0 = int(x0 * w), int(y0 * h)
        pw = max(1, int((x1 - x0) * w))
        ph = max(1, int((y1 - y0) * h))
        out = _image.fixed_crop(arr, px0, py0, pw, ph, None, 2)
        cw, ch = x1 - x0, y1 - y0
        valid = label[:, 0] >= 0
        b = label[valid, 1:5]
        b[:, [0, 2]] = (b[:, [0, 2]] - x0) / cw
        b[:, [1, 3]] = (b[:, [1, 3]] - y0) / ch
        clipped = _np.clip(b, 0.0, 1.0)
        cx = (b[:, 0] + b[:, 2]) / 2
        cy = (b[:, 1] + b[:, 3]) / 2
        keep = (cx > 0) & (cx < 1) & (cy > 0) & (cy < 1)
        label[valid, 1:5] = clipped
        cls = label[valid, 0]
        cls[~keep] = -1.0
        label[valid, 0] = cls
        return out, label


class DetRandomPadAug(_DetDrawing):
    """Zoom out (reference ``detection.py:280``): the image is placed on a
    larger canvas filled with ``pad_val`` and the boxes shrink with it.
    ``params``: the canvas ``(width, height, x0, y0)``, or None when no
    draw was at least the image's size."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127), generator=None):
        super().__init__(generator, aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def params(self, src, label):
        h, w = _image._to_np(src).shape[:2]
        for _ in range(self.max_attempts):
            scale = _image._uniform(self._gen, *self.area_range)
            ar = _image._uniform(self._gen, *self.aspect_ratio_range)
            nw = int(w * _np.sqrt(scale * ar))
            nh = int(h * _np.sqrt(scale / ar))
            if nw >= w and nh >= h:
                return ((nw, nh, _image._randint(self._gen, 0, nw - w),
                         _image._randint(self._gen, 0, nh - h)),)
        return (None,)

    def apply(self, src, label, canvas):
        label = _np.array(label, _np.float32, copy=True)
        if canvas is None:
            return src, label
        nw, nh, x0, y0 = canvas
        arr = _image._to_np(src)
        h, w = arr.shape[:2]
        out = _np.empty((nh, nw, arr.shape[2]), arr.dtype)
        out[...] = _np.asarray(self.pad_val, arr.dtype)
        out[y0:y0 + h, x0:x0 + w, :] = arr
        valid = label[:, 0] >= 0
        b = label[valid, 1:5]
        b[:, [0, 2]] = (b[:, [0, 2]] * w + x0) / nw
        b[:, [1, 3]] = (b[:, [1, 3]] * h + y0) / nh
        label[valid, 1:5] = b
        return _image._nd(out), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0,
                       pca_noise=0, hue=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50,
                       pad_val=(127, 127, 127)):
    """The detection augmenter chain (reference ``detection.py:342``: the
    same arguments and order): resize, random crop, random pad, mirror,
    then the forced resize to ``data_shape``, the cast and the colour
    augmenters."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(_image.ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(1.0, area_range[0]), area_range[1]),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # the final shape comes after the geometric augmenters
    auglist.append(DetBorrowAug(_image.ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(_image.CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            _image.ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(_image.HueJitterAug(hue)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(_image.RandomGrayAug(rand_gray)))
    if pca_noise > 0:
        eigval = [55.46, 4.794, 1.148]
        eigvec = [[-0.5675, 0.7192, 0.4009],
                  [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]
        auglist.append(DetBorrowAug(_image.LightingAug(pca_noise, eigval,
                                                       eigvec)))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and len(_np.atleast_1d(mean)):
        auglist.append(DetBorrowAug(_image.ColorNormalizeAug(mean, std)))
    return auglist
