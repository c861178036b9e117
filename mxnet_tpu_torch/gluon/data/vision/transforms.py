"""Image transforms (counterpart of
``mxnet_tpu.gluon.data.vision.transforms``; reference
``python/mxnet/gluon/data/vision/transforms.py``): ``Compose``, ``Cast``,
``ToTensor``, ``Normalize``, ``Resize``, the crops, the flips and the
color jitters.  They work a sample at a time, HWC in, with the
reference's numpy arithmetic, and give an NDArray on the input's context
(the current one for a numpy input).

A random transform draws from its own CPU ``torch.Generator``
(``generator=``, else one seeded from ``mx.random``'s stream when it is
made), and splits the draw from the arithmetic: ``params(x)`` draws and
``apply(x, *params)`` transforms (``forward`` is the two in turn).
"""
from __future__ import annotations

import numpy as _np
import torch

from ...block import Block, HybridBlock
from ...nn import Sequential, HybridSequential
from ....ndarray.ndarray import NDArray, array as nd_array

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "CropResize", "RandomCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomBrightness",
           "RandomContrast", "RandomSaturation", "RandomHue",
           "RandomColorJitter", "RandomLighting"]


def _as_np_img(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


def _like(out, x):
    """``out`` (numpy) as an NDArray on ``x``'s context."""
    return nd_array(out, ctx=x.context if isinstance(x, NDArray) else None)


def _generator(generator):
    if generator is not None:
        return generator
    from ....random import next_key
    return next_key()


def _uniform(gen, low, high):
    u = float(torch.rand((), generator=gen, dtype=torch.float64))
    return low + (high - low) * u


def _randint(gen, low, high):
    """Uniform in ``[low, high]``, both ends (``random.randint``)."""
    return int(torch.randint(low, high + 1, (), generator=gen))


def _permutation(gen, n):
    return [int(i) for i in torch.randperm(n, generator=gen)]


class Compose(Sequential):
    """Sequentially composes transforms, runs of HybridBlocks grouped
    into one HybridSequential (reference: transforms.py:37)."""

    def __init__(self, transforms):
        super().__init__()
        transforms = list(transforms) + [None]
        hybrid = []
        for i in transforms:
            if isinstance(i, HybridBlock):
                hybrid.append(i)
                continue
            elif len(hybrid) == 1:
                self.add(hybrid[0])
                hybrid = []
            elif len(hybrid) > 1:
                hblock = HybridSequential()
                for j in hybrid:
                    hblock.add(j)
                self.add(hblock)
                hybrid = []
            if i is not None:
                self.add(i)


class Cast(HybridBlock):
    """Cast input to a specific data type (reference: transforms.py:81)."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 in [0, 255] to CHW float32 in [0, 1] (reference:
    transforms.py:102)."""

    def __init__(self):
        super().__init__()

    def hybrid_forward(self, F, x):
        if not isinstance(x, NDArray):
            x = nd_array(x)
        arr = x.astype("float32") / 255.0
        if arr.ndim == 3:
            return arr.transpose((2, 0, 1))
        return arr.transpose((0, 3, 1, 2))


class Normalize(HybridBlock):
    """``(x - mean) / std`` over a CHW float tensor, per channel
    (reference: transforms.py:139)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def hybrid_forward(self, F, x):
        mean = _np.asarray(self._mean, dtype="float32").reshape((-1, 1, 1))
        std = _np.asarray(self._std, dtype="float32").reshape((-1, 1, 1))
        return (x - _like(mean, x)) / _like(std, x)


def _resize_np(img, size, interp=1):
    """Bilinear (interp=1) or nearest (interp=0) resize of an HWC numpy
    image to ``size`` = (w, h), the reference's numpy arithmetic."""
    h, w = img.shape[:2]
    ow, oh = size if isinstance(size, (tuple, list)) else (size, size)
    if (oh, ow) == (h, w):
        return img
    ys = _np.linspace(0, h - 1, oh)
    xs = _np.linspace(0, w - 1, ow)
    if interp == 0:
        return img[_np.round(ys).astype(int)][:, _np.round(xs).astype(int)]
    y0 = _np.floor(ys).astype(int)
    x0 = _np.floor(xs).astype(int)
    y1 = _np.minimum(y0 + 1, h - 1)
    x1 = _np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img.astype(_np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


class Resize(Block):
    """Resize to ``size`` (an int: square, or the short side with
    ``keep_ratio``; reference: transforms.py:183)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._keep = keep_ratio
        self._size = size
        self._interpolation = interpolation

    def forward(self, x):
        img = _as_np_img(x)
        if isinstance(self._size, int):
            if self._keep:
                h, w = img.shape[:2]
                if h > w:
                    size = (self._size, int(h * self._size / w))
                else:
                    size = (int(w * self._size / h), self._size)
            else:
                size = (self._size, self._size)
        else:
            size = self._size
        out = _resize_np(img, size, self._interpolation)
        return _like(out.astype(img.dtype if img.dtype == _np.uint8
                                else _np.float32), x)


class CropResize(Block):
    """Crop a box, then optionally resize (reference:
    transforms.py:142)."""

    def __init__(self, x, y, width, height, size=None, interpolation=None):
        super().__init__()
        self._x = x
        self._y = y
        self._width = width
        self._height = height
        self._size = size
        self._interpolation = interpolation or 1

    def forward(self, data):
        img = _as_np_img(data)
        out = img[self._y:self._y + self._height,
                  self._x:self._x + self._width]
        if self._size:
            out = _resize_np(out, self._size, self._interpolation)
        return _like(out, data)


def _center(img, size, interpolation):
    h, w = img.shape[:2]
    ow, oh = size
    if h < oh or w < ow:
        img = _resize_np(img, (max(ow, w), max(oh, h)), interpolation)
        h, w = img.shape[:2]
    y0 = (h - oh) // 2
    x0 = (w - ow) // 2
    return img[y0:y0 + oh, x0:x0 + ow]


class CenterCrop(Block):
    """Crop the center (reference: transforms.py:225)."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._interpolation = interpolation

    def forward(self, x):
        return _like(_center(_as_np_img(x), self._size,
                             self._interpolation), x)


class _Random(Block):
    """A transform that draws: ``forward(x)`` is
    ``apply(x, *params(x))``."""

    def __init__(self, generator=None):
        super().__init__()
        self._gen = _generator(generator)

    def forward(self, x):
        return self.apply(x, *self.params(x))


class RandomCrop(_Random):
    """A random crop of ``size``, after zero padding by ``pad`` (and a
    resize up when the image is smaller); ``params``: the corner
    ``(y0, x0)``."""

    def __init__(self, size, pad=None, interpolation=1, generator=None):
        super().__init__(generator)
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._pad = pad
        self._interpolation = interpolation

    def _prepared(self, x):
        img = _as_np_img(x)
        if self._pad:
            p = self._pad
            img = _np.pad(img, ((p, p), (p, p), (0, 0)), mode="constant")
        h, w = img.shape[:2]
        ow, oh = self._size
        if h < oh or w < ow:
            img = _resize_np(img, (max(ow, w), max(oh, h)),
                             self._interpolation)
        return img

    def params(self, x):
        h, w = self._prepared(x).shape[:2]
        ow, oh = self._size
        return _randint(self._gen, 0, h - oh), _randint(self._gen, 0, w - ow)

    def apply(self, x, y0, x0):
        img = self._prepared(x)
        ow, oh = self._size
        return _like(img[y0:y0 + oh, x0:x0 + ow], x)


class RandomResizedCrop(_Random):
    """A crop of random area and aspect, resized to ``size`` (reference:
    transforms.py:257); ``params``: the box ``(x0, y0, w, h)``, or None
    for the center crop it falls back to."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1, generator=None):
        super().__init__(generator)
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def params(self, x):
        h, w = _as_np_img(x).shape[:2]
        area = h * w
        for _ in range(10):
            target_area = _uniform(self._gen, *self._scale) * area
            log_ratio = (_np.log(self._ratio[0]), _np.log(self._ratio[1]))
            aspect = _np.exp(_uniform(self._gen, *log_ratio))
            cw = int(round((target_area * aspect) ** 0.5))
            ch = int(round((target_area / aspect) ** 0.5))
            if cw <= w and ch <= h:
                return ((_randint(self._gen, 0, w - cw),
                         _randint(self._gen, 0, h - ch), cw, ch),)
        return (None,)

    def apply(self, x, box):
        img = _as_np_img(x)
        if box is None:
            return _like(_center(img, self._size, self._interpolation), x)
        x0, y0, cw, ch = box
        crop = img[y0:y0 + ch, x0:x0 + cw]
        return _like(_resize_np(crop, self._size,
                                self._interpolation).astype(img.dtype), x)


class _Flip(_Random):
    """``params``: whether to flip (probability ``p``)."""

    _axis = None

    def __init__(self, p=0.5, generator=None):
        super().__init__(generator)
        self._p = p

    def params(self, x):
        return (_uniform(self._gen, 0.0, 1.0) < self._p,)

    def apply(self, x, flip):
        if flip:
            return _like(_np.flip(_as_np_img(x), self._axis).copy(), x)
        return x if isinstance(x, NDArray) else nd_array(x)


class RandomFlipLeftRight(_Flip):
    """Random horizontal flip (reference: transforms.py:301)."""

    _axis = 1


class RandomFlipTopBottom(_Flip):
    """Random vertical flip (reference: transforms.py:318)."""

    _axis = 0


class _RandomColorBase(_Random):
    """``params``: ``alpha = 1 + U(-amount, amount)``."""

    def __init__(self, amount, generator=None):
        super().__init__(generator)
        self._amount = amount

    def params(self, x):
        return (1.0 + _uniform(self._gen, -self._amount, self._amount),)


class RandomBrightness(_RandomColorBase):
    """Random brightness jitter (reference: transforms.py:335)."""

    def apply(self, x, alpha):
        return _like(_as_np_img(x).astype(_np.float32) * alpha, x)


class RandomContrast(_RandomColorBase):
    """Random contrast jitter (reference: transforms.py:352)."""

    def apply(self, x, alpha):
        img = _as_np_img(x).astype(_np.float32)
        gray = img.mean()
        return _like(img * alpha + gray * (1 - alpha), x)


class RandomSaturation(_RandomColorBase):
    """Random saturation jitter (reference: transforms.py:369)."""

    def apply(self, x, alpha):
        img = _as_np_img(x).astype(_np.float32)
        coef = _np.array([0.299, 0.587, 0.114], dtype=_np.float32)
        gray = (img * coef).sum(axis=2, keepdims=True)
        return _like(img * alpha + gray * (1 - alpha), x)


class RandomHue(_Random):
    """Random hue jitter in YIQ space (reference: transforms.py:386);
    ``params``: the rotation ``U(-amount, amount)`` in half turns."""

    def __init__(self, amount, generator=None):
        super().__init__(generator)
        self._amount = amount

    def params(self, x):
        return (_uniform(self._gen, -self._amount, self._amount),)

    def apply(self, x, alpha):
        img = _as_np_img(x).astype(_np.float32)
        u = _np.cos(alpha * _np.pi)
        w = _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]], dtype=_np.float32)
        tyiq = _np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], dtype=_np.float32)
        ityiq = _np.array([[1.0, 0.956, 0.621],
                           [1.0, -0.272, -0.647],
                           [1.0, -1.107, 1.705]], dtype=_np.float32)
        t = ityiq @ bt @ tyiq
        return _like(img @ t.T, x)


class RandomColorJitter(_Random):
    """Brightness, contrast, saturation and hue jitters in a random order
    (reference: transforms.py:403); ``params``: the order and each
    jitter's parameter in that order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 generator=None):
        super().__init__(generator)
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness, self._gen))
        if contrast:
            self._ts.append(RandomContrast(contrast, self._gen))
        if saturation:
            self._ts.append(RandomSaturation(saturation, self._gen))
        if hue:
            self._ts.append(RandomHue(hue, self._gen))

    def params(self, x):
        order = _permutation(self._gen, len(self._ts))
        return order, [self._ts[i].params(x)[0] for i in order]

    def apply(self, x, order, alphas):
        for i, alpha in zip(order, alphas):
            x = self._ts[i].apply(x, alpha)
        return x


class RandomLighting(_Random):
    """AlexNet-style PCA lighting noise (reference: transforms.py:428);
    ``params``: the three ``N(0, alpha)`` weights, float32."""

    _eigval = _np.array([55.46, 4.794, 1.148], dtype=_np.float32)
    _eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], dtype=_np.float32)

    def __init__(self, alpha, generator=None):
        super().__init__(generator)
        self._alpha = alpha

    def params(self, x):
        return (torch.normal(0.0, float(self._alpha), (3,),
                             generator=self._gen,
                             dtype=torch.float64).numpy().astype(
                                 _np.float32),)

    def apply(self, x, alpha):
        img = _as_np_img(x).astype(_np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return _like(img + rgb, x)
