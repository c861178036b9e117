"""``mx.image`` — image decoding, augmentation and ``ImageIter``
(counterpart of ``mxnet_tpu.image.image``).

Reference: ``python/mxnet/image/image.py`` and the native augmenter
chain (``src/io/image_aug_default.cc``).  Decoding and augmentation run
on the host in numpy (and PIL, where a function resizes), with the
reference's arithmetic, so a chain gives the reference's pixels; image
arrays are NDArrays on the CPU.  ``ImageIter`` assembles NCHW float32
batches on the host and hands them over as NDArrays on the current
context.

Randomness: every augmenter that draws holds its own CPU
``torch.Generator`` (given as ``generator=``, else seeded from
``mx.random``'s stream when it is made), and ``ImageIter`` shuffles with
its own (``seed=``, else from the stream).  Each drawing augmenter also
splits its draw from its arithmetic: ``params(src)`` draws, and
``apply(src, *params)`` transforms with given parameters (``__call__``
is the two in turn), so a caller can hold an augmenter to parameters it
chose.
"""
from __future__ import annotations

import json
import os
import time

import numpy as _np
import torch

from .. import telemetry as _telemetry
from ..io import DataIter, DataBatch, DataDesc
from ..ndarray.ndarray import NDArray, _wrap, array

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize",
           "random_size_crop", "HorizontalFlipAug", "CastAug",
           "ColorNormalizeAug", "ResizeAug", "ForceResizeAug",
           "CenterCropAug", "RandomCropAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "LightingAug",
           "ColorJitterAug", "RandomOrderAug", "Augmenter", "HueJitterAug",
           "RandomGrayAug", "RandomSizedCropAug", "SequentialAug",
           "CreateAugmenter", "ImageIter", "scale_down"]

# numpy dtypes that arrive in 32 bits, as the reference's arrays do
_NARROW = {_np.dtype(_np.float64): _np.float32,
           _np.dtype(_np.int64): _np.int32}


def _to_np(img):
    if isinstance(img, NDArray):
        return img.asnumpy()
    return _np.asarray(img)


def _nd(arr):
    """A host numpy image as an NDArray on the CPU, sharing its memory
    (64-bit values narrowed to 32 bits, as the reference's arrays)."""
    arr = _np.ascontiguousarray(arr, dtype=_NARROW.get(arr.dtype,
                                                       arr.dtype))
    if not arr.flags.writeable:
        arr = arr.copy()
    return _wrap(torch.from_numpy(arr))


def _generator(generator):
    """``generator``, or a CPU generator seeded from ``mx.random``."""
    if generator is not None:
        return generator
    from ..random import next_key
    return next_key()


def _uniform(gen, low, high):
    """A float uniform in ``[low, high)`` from ``gen``."""
    u = float(torch.rand((), generator=gen, dtype=torch.float64))
    return low + (high - low) * u


def _randint(gen, low, high):
    """An int uniform in ``[low, high]`` (both ends, as
    ``random.randint``) from ``gen``."""
    return int(torch.randint(low, high + 1, (), generator=gen))


def _permutation(gen, n):
    return [int(i) for i in torch.randperm(n, generator=gen)]


def imdecode(buf, flag=1, to_rgb=True, **kwargs):
    """Decode JPEG, PNG or ``NPYF`` bytes to an HWC uint8 image
    (reference: ``image.py:40``; PIL decodes)."""
    from ..recordio import _decode_img
    arr = _decode_img(bytes(buf), 1 if flag else 0)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return _nd(arr)


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    """Resize to ``w`` x ``h`` with PIL (nearest 0, bilinear 1, bicubic
    2), as the reference."""
    from PIL import Image
    arr = _to_np(src).astype(_np.uint8)
    mode = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC}.get(
        interp, Image.BILINEAR)
    squeeze = arr.ndim == 3 and arr.shape[2] == 1
    pil = Image.fromarray(arr[:, :, 0] if squeeze else arr)
    out = _np.asarray(pil.resize((w, h), mode))
    if out.ndim == 2:
        out = out[:, :, None]
    return _nd(out)


def scale_down(src_size, size):
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    arr = _to_np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, size * h // w
    else:
        new_w, new_h = size * w // h, size
    return imresize(arr, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    arr = _to_np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(arr, size[0], size[1], interp)
    return _nd(arr)


def center_crop(src, size, interp=2):
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    return fixed_crop(arr, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2, generator=None):
    """A crop of ``size`` (scaled down to fit) at a random corner; the
    image and ``(x0, y0, w, h)``."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    gen = _generator(generator)
    x0 = _randint(gen, 0, w - new_w)
    y0 = _randint(gen, 0, h - new_h)
    return fixed_crop(arr, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def _size_crop_box(shape, area, ratio, gen):
    """The random-area, random-aspect box of :func:`random_size_crop`
    (10 tries), or None when no try fits."""
    h, w = shape[:2]
    src_area = h * w
    if isinstance(area, (float, int)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _uniform(gen, *area) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        aspect = _np.exp(_uniform(gen, *log_ratio))
        new_w = int(round(_np.sqrt(target_area * aspect)))
        new_h = int(round(_np.sqrt(target_area / aspect)))
        if new_w <= w and new_h <= h:
            return (_randint(gen, 0, w - new_w), _randint(gen, 0, h - new_h),
                    new_w, new_h)
    return None


def random_size_crop(src, size, area, ratio, interp=2, generator=None):
    arr = _to_np(src)
    box = _size_crop_box(arr.shape, area, ratio, _generator(generator))
    if box is None:
        return center_crop(arr, size, interp)
    return fixed_crop(arr, *box, size, interp), box


def color_normalize(src, mean, std=None):
    arr = _to_np(src).astype(_np.float32)
    arr -= _np.asarray(mean, _np.float32)
    if std is not None:
        arr /= _np.asarray(std, _np.float32)
    return _nd(arr)


# ----------------------------------------------------------------- augmenters

class Augmenter:
    """Base augmenter (reference: ``image.py:145``)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class _Drawing(Augmenter):
    """An augmenter that draws: ``__call__(src)`` is
    ``apply(src, *params(src))`` with its own generator."""

    def __init__(self, generator=None, **kwargs):
        super().__init__(**kwargs)
        self._gen = _generator(generator)

    def params(self, src):
        raise NotImplementedError

    def apply(self, src, *params):
        raise NotImplementedError

    def __call__(self, src):
        return self.apply(src, *self.params(src))


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(_Drawing):
    """``params``: the crop's corner ``(x0, y0)``."""

    def __init__(self, size, interp=2, generator=None):
        super().__init__(generator, size=size, interp=interp)
        self.size, self.interp = size, interp

    def params(self, src):
        h, w = _to_np(src).shape[:2]
        new_w, new_h = scale_down((w, h), self.size)
        return (_randint(self._gen, 0, w - new_w),
                _randint(self._gen, 0, h - new_h))

    def apply(self, src, x0, y0):
        arr = _to_np(src)
        h, w = arr.shape[:2]
        new_w, new_h = scale_down((w, h), self.size)
        return fixed_crop(arr, x0, y0, new_w, new_h, self.size, self.interp)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(_Drawing):
    """``params``: whether to flip."""

    def __init__(self, p=0.5, generator=None):
        super().__init__(generator, p=p)
        self.p = p

    def params(self, src):
        return (_uniform(self._gen, 0.0, 1.0) < self.p,)

    def apply(self, src, flip):
        if flip:
            return _nd(_to_np(src)[:, ::-1])
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return _nd(_to_np(src).astype(self.typ))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean, self.std = mean, std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class _Jitter(_Drawing):
    """A jitter whose ``params`` are ``(alpha,)``, ``alpha = 1 + U(-a,
    a)``."""

    def __init__(self, amount, generator=None, **kwargs):
        super().__init__(generator, **kwargs)
        self._amount = amount

    def params(self, src):
        return (1.0 + _uniform(self._gen, -self._amount, self._amount),)


class BrightnessJitterAug(_Jitter):
    def __init__(self, brightness, generator=None):
        super().__init__(brightness, generator, brightness=brightness)
        self.brightness = brightness

    def apply(self, src, alpha):
        return _nd(_to_np(src).astype(_np.float32) * alpha)


class ContrastJitterAug(_Jitter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __init__(self, contrast, generator=None):
        super().__init__(contrast, generator, contrast=contrast)
        self.contrast = contrast

    def apply(self, src, alpha):
        arr = _to_np(src).astype(_np.float32)
        gray = (arr * self._coef).sum(axis=2, keepdims=True)
        mean = gray.mean() * (1.0 - alpha)
        return _nd(arr * alpha + mean)


class SaturationJitterAug(_Jitter):
    _coef = ContrastJitterAug._coef

    def __init__(self, saturation, generator=None):
        super().__init__(saturation, generator, saturation=saturation)
        self.saturation = saturation

    def apply(self, src, alpha):
        arr = _to_np(src).astype(_np.float32)
        gray = (arr * self._coef).sum(axis=2, keepdims=True) * (1.0 - alpha)
        return _nd(arr * alpha + gray)


class LightingAug(_Drawing):
    """PCA lighting noise (AlexNet-style); ``params``: the three
    ``N(0, alphastd)`` weights (float64, as numpy's draw)."""

    def __init__(self, alphastd, eigval, eigvec, generator=None):
        super().__init__(generator, alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, _np.float32)
        self.eigvec = _np.asarray(eigvec, _np.float32)

    def params(self, src):
        return (torch.normal(0.0, float(self.alphastd), (3,),
                             generator=self._gen,
                             dtype=torch.float64).numpy(),)

    def apply(self, src, alpha):
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return _nd(_to_np(src).astype(_np.float32) + rgb)


class ColorJitterAug(_Drawing):
    """Brightness, contrast and saturation jitters in a random order;
    ``params``: the order and each jitter's alpha in that order."""

    def __init__(self, brightness, contrast, saturation, generator=None):
        super().__init__(generator, brightness=brightness,
                         contrast=contrast, saturation=saturation)
        self.augs = [a for a in (
            BrightnessJitterAug(brightness, self._gen) if brightness
            else None,
            ContrastJitterAug(contrast, self._gen) if contrast else None,
            SaturationJitterAug(saturation, self._gen) if saturation
            else None) if a is not None]

    def params(self, src):
        order = _permutation(self._gen, len(self.augs))
        return order, [self.augs[i].params(src)[0] for i in order]

    def apply(self, src, order, alphas):
        for i, alpha in zip(order, alphas):
            src = self.augs[i].apply(src, alpha)
        return src


class HueJitterAug(_Drawing):
    """Hue rotation in YIQ space (reference: ``image.py:296``);
    ``params``: the rotation ``U(-hue, hue)`` in half turns."""

    _yiq = _np.array([[0.299, 0.587, 0.114],
                      [0.596, -0.274, -0.321],
                      [0.211, -0.523, 0.311]], _np.float32)
    _yiq_inv = _np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], _np.float32)

    def __init__(self, hue, generator=None):
        super().__init__(generator, hue=hue)
        self.hue = hue

    def params(self, src):
        return (_uniform(self._gen, -self.hue, self.hue),)

    def apply(self, src, alpha):
        arr = _to_np(src).astype(_np.float32)
        u = _np.cos(alpha * _np.pi)
        w = _np.sin(alpha * _np.pi)
        rot = _np.array([[1.0, 0.0, 0.0],
                         [0.0, u, -w],
                         [0.0, w, u]], _np.float32)
        t = self._yiq_inv @ rot @ self._yiq
        return _nd(arr @ t.T)


class RandomGrayAug(_Drawing):
    """Three-channel grayscale with probability ``p``; ``params``:
    whether to convert."""

    _coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __init__(self, p, generator=None):
        super().__init__(generator, p=p)
        self.p = p

    def params(self, src):
        return (_uniform(self._gen, 0.0, 1.0) < self.p,)

    def apply(self, src, gray):
        if not gray:
            return src
        arr = _to_np(src).astype(_np.float32)
        g = (arr * self._coef).sum(axis=2, keepdims=True)
        return _nd(_np.broadcast_to(g, arr.shape).copy())


class RandomSizedCropAug(_Drawing):
    """The Inception-style crop: a random area and aspect, resized to
    ``size``; ``params``: the box ``(x0, y0, w, h)``, or None for the
    center crop it falls back to."""

    def __init__(self, size, area, ratio, interp=2, generator=None):
        super().__init__(generator, size=size, area=area, ratio=ratio,
                         interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def params(self, src):
        return (_size_crop_box(_to_np(src).shape, self.area, self.ratio,
                               self._gen),)

    def apply(self, src, box):
        if box is None:
            return center_crop(src, self.size, self.interp)[0]
        return fixed_crop(src, *box, self.size, self.interp)


class SequentialAug(Augmenter):
    """A fixed sequence of augmenters (reference: ``image.py:358``)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(_Drawing):
    """The augmenters in a random order; ``params``: the order."""

    def __init__(self, ts, generator=None):
        super().__init__(generator)
        self.ts = ts

    def params(self, src):
        return (_permutation(self._gen, len(self.ts)),)

    def apply(self, src, order):
        for i in order:
            src = self.ts[i](src)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The standard augmenter chain (reference: ``image.py:385``, the
    defaults of ``image_aug_default.cc``)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4., 4 / 3.), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if pca_noise > 0:
        eigval = [55.46, 4.794, 1.148]
        eigvec = [[-0.5675, 0.7192, 0.4009],
                  [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and len(_np.atleast_1d(mean)):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Image batches from a ``.rec`` file (RecordIO, through its ``.idx``)
    or a ``.lst`` file and an image directory (reference: ``image.py:437``,
    ``src/io/iter_image_recordio_2.cc``): NCHW float32 data and float32
    labels, the last short batch wrap-padded from the epoch's start
    (``pad`` counts the fill) or dropped (``last_batch_handle=
    "discard"``).  ``shuffle`` reorders the samples at each ``reset`` with
    the iterator's own generator (``seed=``, else seeded from
    ``mx.random``); ``part_index`` / ``num_parts`` read a disjoint key
    range.  Samples decode and augment on the host, over
    ``io.decode_workers`` threads when that knob is above 1."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imgrec=None, data_name="data", label_name="softmax_label",
                 last_batch_handle="pad", seed=None, **kwargs):
        super().__init__(batch_size)
        self._shuffle_gen = torch.Generator().manual_seed(int(seed)) \
            if seed is not None else _generator(None)
        self._last_batch_handle = last_batch_handle
        if not (path_imgrec or path_imglist or imgrec):
            raise ValueError("ImageIter needs path_imgrec, path_imglist or "
                             "imgrec")
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        if aug_list is not None:
            self.auglist = aug_list
        else:
            import inspect
            aug_params = set(
                inspect.signature(CreateAugmenter).parameters) - {
                    "data_shape"}
            unknown = set(kwargs) - aug_params
            if unknown:
                raise TypeError("ImageIter: unknown arguments %s"
                                % (sorted(unknown),))
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        self.data_name = data_name
        self.label_name = label_name
        self.shuffle = shuffle
        self._imglist = None
        if path_imgrec or imgrec is not None:
            if imgrec is not None:
                self._rec = imgrec
            else:
                from .recordio_compat import open_indexed
                self._rec = open_indexed(path_imgrec)
            self._keys = list(self._rec.keys)
        else:
            self._imglist = []
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        continue
                    labels = _np.asarray(parts[1:-1], _np.float32)
                    self._imglist.append((parts[-1], labels))
            self._keys = list(range(len(self._imglist)))
        n = len(self._keys)
        lo = n * part_index // num_parts
        hi = n * (part_index + 1) // num_parts
        self._keys = self._keys[lo:hi]
        self.path_root = path_root
        self._order = list(range(len(self._keys)))
        self.cur = 0
        self._pool = None
        self._pool_size = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shp)]

    def reset(self):
        if self.shuffle:
            self._order = [self._order[i] for i in _permutation(
                self._shuffle_gen, len(self._order))]
        self.cur = 0

    def _read_sample(self, i):
        from .recordio_compat import record_to_image
        key = self._keys[self._order[i]]
        if self._imglist is not None:
            fname, label = self._imglist[key]
            img = imread(os.path.join(self.path_root, fname))
        else:
            label, img = record_to_image(self._rec.read_idx(key))
        for aug in self.auglist:
            img = aug(img)
        arr = _to_np(img).astype(_np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        arr = arr.transpose(2, 0, 1)  # HWC -> CHW
        return arr, _np.atleast_1d(_np.asarray(label, _np.float32))

    def _decode_pool(self, workers):
        if self._pool is None or self._pool_size != workers:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=workers,
                                            thread_name_prefix="mx-decode")
            self._pool_size = workers
        return self._pool

    def close(self):
        """Release the decode thread pool (idempotent; also on GC)."""
        pool, self._pool, self._pool_size = self._pool, None, 0
        if pool is not None:
            pool.shutdown(wait=False)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def _decode_positions(self, positions):
        """Decode and augment the samples at these epoch positions, each
        read retried on an I/O error (``resilience.call_with_retry``),
        over ``io.decode_workers`` threads when it is above 1."""
        from .. import config as _config
        from ..resilience import call_with_retry

        def read(pos):
            return call_with_retry(self._read_sample, pos, kind="io")

        workers = int(_config.get("io.decode_workers") or 0)
        if workers <= 1 or len(positions) <= 1:
            return [read(p) for p in positions]
        pool = self._decode_pool(workers)
        return list(pool.map(read, positions))

    def _batch_samples(self):
        """One batch of decoded samples, ``([(slot, data, label)], pad)``,
        the short final batch wrap-padded from the epoch's start."""
        n = len(self._keys)
        if self.cur >= n:
            raise StopIteration
        if self._last_batch_handle == "discard" and \
                n - self.cur < self.batch_size:
            raise StopIteration
        slots = []  # (batch slot, epoch position)
        i = 0
        while i < self.batch_size and self.cur < n:
            slots.append((i, self.cur))
            self.cur += 1
            i += 1
        pad = self.batch_size - i
        for j in range(i, self.batch_size):
            slots.append((j, j % max(i, 1)))
        decoded = self._decode_positions([pos for _, pos in slots])
        return [(slot, d, l)
                for (slot, _), (d, l) in zip(slots, decoded)], pad

    def next(self):
        t0 = time.perf_counter()
        C, H, W = self.data_shape
        samples, pad = self._batch_samples()
        batch_data = _np.zeros((self.batch_size, C, H, W), _np.float32)
        batch_label = _np.zeros((self.batch_size, self.label_width),
                                _np.float32)
        for slot, d, l in samples:
            batch_data[slot] = d
            batch_label[slot] = l[:self.label_width]
        label = batch_label[:, 0] if self.label_width == 1 else batch_label
        _telemetry.timer("io.batch_host_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return DataBatch([array(batch_data)], [array(label)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
