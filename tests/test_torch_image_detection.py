"""The detection data pipeline of the port held against the reference on
the CPU: ``mx.image``'s detection augmenters (``image/detection.py``),
``mx.io.ImageDetRecordIter`` and ``gluon.contrib.cnn``'s
``DeformableConvolution``.

* Augmenters: the port's draws are pointed at Python's ``random`` (the
  reference's stream) for the test, so each augmenter draws the
  reference's parameters; with them the images and labels are the
  reference's bitwise.  ``params`` then ``apply`` is ``__call__``.
* ``CreateDetAugmenter``: the same chain (classes, order and arguments)
  and, run with the same draws, the reference's output bitwise.
* ``ImageDetRecordIter`` over a ``.rec`` the test writes (im2rec's
  ``[A, B, extra..., objects]`` labels, a short last batch): the
  reference's batches, labels, padding and ``provide_label``, with the
  pad width given and inferred from the headers.
* ``DeformableConvolution`` with non-zero offset weights: outputs and
  every gradient within 1e-5 of the reference's layer.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu.image as rimage
import mxnet_tpu.gluon.contrib.cnn  # noqa: F401
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.image as pimage
import mxnet_tpu_torch.image.image as pimage_draws

import _torch_gluon as G


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


@pytest.fixture
def python_draws(monkeypatch):
    """The port's image draws from Python's ``random``, the reference's
    stream."""
    monkeypatch.setattr(pimage_draws, "_uniform",
                        lambda gen, lo, hi: random.uniform(lo, hi))
    monkeypatch.setattr(pimage_draws, "_randint",
                        lambda gen, lo, hi: random.randint(lo, hi))

    def permutation(gen, n):
        order = list(range(n))
        random.shuffle(order)
        return order
    monkeypatch.setattr(pimage_draws, "_permutation", permutation)


def _src(h=30, w=26):
    return np.random.RandomState(4).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


def _label():
    return np.array([[0, 0.1, 0.2, 0.5, 0.6], [2, 0.55, 0.1, 0.95, 0.4],
                     [1, 0.3, 0.6, 0.45, 0.9], [-1, -1, -1, -1, -1]],
                    np.float32)


def _host(x):
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _same(port, want):
    for p, r in zip(port, want):
        p, r = _host(p), _host(r)
        assert p.dtype == r.dtype and p.shape == r.shape, (p.shape, r.shape)
        np.testing.assert_array_equal(p, r)


def _both(make, seed, src=None, label=None):
    """``make(pkg)``'s augmenter on the same image and label in both
    packages, each after ``random.seed(seed)``."""
    src = _src() if src is None else src
    label = _label() if label is None else label
    random.seed(seed)
    want = make(rimage)(ref.nd.array(src, dtype=np.uint8), label.copy())
    random.seed(seed)
    got = make(pimage)(src, label.copy())
    return got, want


AUGS = {
    "flip": lambda m: m.DetHorizontalFlipAug(0.5),
    "crop": lambda m: m.DetRandomCropAug(0.3, (0.5, 2.0), (0.1, 1.0)),
    "crop_strict": lambda m: m.DetRandomCropAug(0.9, (0.75, 1.33),
                                                (0.05, 0.3), 5),
    "pad": lambda m: m.DetRandomPadAug((0.75, 1.33), (1.0, 3.0), 50,
                                       (10, 20, 30)),
    "select": lambda m: m.DetRandomSelectAug(
        [m.DetHorizontalFlipAug(1.0), m.DetRandomCropAug()], 0.3),
    "borrow": lambda m: m.DetBorrowAug(m.ForceResizeAug((16, 12))),
}


@pytest.mark.parametrize("name", sorted(AUGS))
@pytest.mark.parametrize("seed", range(4))
def test_augmenter_matches_reference_for_equal_draws(name, seed,
                                                     python_draws):
    got, want = _both(AUGS[name], seed)
    _same(got, want)


@pytest.mark.parametrize("name", ["flip", "crop", "pad", "select"])
def test_params_then_apply_is_call(name, python_draws):
    aug = AUGS[name](pimage)
    src, label = _src(), _label()
    random.seed(7)
    params = aug.params(src, label)
    split = aug.apply(src, label, *params)
    random.seed(7)
    _same(split, aug(src, label))


def test_crop_marks_objects_that_left_with_class_minus_one(python_draws):
    label = _label()
    aug = pimage.DetRandomCropAug()
    out, lab = aug.apply(_src(), label, np.array([0.5, 0.0, 1.0, 0.5],
                                                 np.float32))
    assert lab.shape == label.shape
    np.testing.assert_array_equal(lab[:, 0], [-1, 2, -1, -1])
    assert _host(out).shape == (15, 13, 3)


def test_create_det_augmenter_chain(python_draws):
    kwargs = dict(resize=40, rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
                  mean=True, std=True, brightness=0.2, contrast=0.2,
                  saturation=0.2, hue=0.1, rand_gray=0.3,
                  area_range=(0.1, 2.0))
    shape = (3, 24, 20)
    chain_r = rimage.CreateDetAugmenter(shape, **kwargs)
    chain_p = pimage.CreateDetAugmenter(shape, **kwargs)
    assert [a.dumps() for a in chain_p] == [a.dumps() for a in chain_r]
    for seed in range(3):
        random.seed(seed)
        img, lab = ref.nd.array(_src(), dtype=np.uint8), _label()
        for aug in chain_r:
            img, lab = aug(img, lab)
        want = (img, lab)
        random.seed(seed)
        img, lab = _src(), _label()
        for aug in chain_p:
            img, lab = aug(img, lab)
        assert _host(img).shape == (24, 20, 3)
        _same((img, lab), want)


def _write_det_records(prefix, n=7, extra=0):
    """``n`` 12x10 PNG images with detection labels ``[2 + extra, 5,
    extra values..., objects]``, one to three objects each."""
    rng = np.random.RandomState(0)
    w = mt.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = rng.randint(0, 256, (12, 10, 3)).astype(np.uint8)
        objs = np.concatenate(
            [rng.randint(0, 5, (i % 3 + 1, 1)),
             rng.uniform(0, 1, (i % 3 + 1, 4))], 1)
        flat = np.concatenate([[2.0 + extra, 5.0], np.arange(extra),
                               objs.ravel()]).astype(np.float32)
        payload = mt.recordio.pack_img(mt.recordio.IRHeader(0, flat, i, 0),
                                       img, img_fmt=".png")
        w.write_idx(i, payload)
    w.close()
    return prefix + ".rec"


@pytest.mark.parametrize("pad_width,extra", [(-1, 0), (5, 2)])
def test_image_det_record_iter_matches_reference(pad_width, extra,
                                                  tmp_path):
    path = _write_det_records(str(tmp_path / "det"), extra=extra)
    kw = dict(path_imgrec=path, batch_size=3, data_shape=(3, 12, 10),
              label_pad_width=pad_width)
    rit = ref.io.ImageDetRecordIter(**kw)
    pit = mt.io.ImageDetRecordIter(**kw)
    width = pad_width if pad_width > 0 else 3
    assert pit.provide_label[0].shape == rit.provide_label[0].shape \
        == (3, width, 5)
    assert pit.provide_data[0].shape == rit.provide_data[0].shape
    for _ in range(2):            # an epoch, a reset, the epoch again
        got, want = list(pit), list(rit)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.pad == w.pad
            _same((g.data[0], g.label[0]), (w.data[0], w.label[0]))
        assert got[-1].pad == 2
        pit.reset()
        rit.reset()


def test_deformable_convolution_layer_matches_reference():
    def make(pkg):
        return pkg.gluon.contrib.cnn.DeformableConvolution(
            4, kernel_size=3, padding=1, strides=1, num_deformable_group=1,
            offset_weight_initializer=pkg.init.Normal(0.3),
            offset_bias_initializer=pkg.init.Normal(0.3),
            bias_initializer=pkg.init.Normal(0.1), in_channels=0)
    x = np.random.RandomState(2).randn(2, 3, 7, 6).astype(np.float32)
    rb, pb = G.check(make, [x], 1e-5)
    names = sorted(pb.collect_params().keys())
    assert names == sorted(rb.collect_params().keys())
    assert any(n.endswith("deformable_conv_offset_weight") for n in names)
