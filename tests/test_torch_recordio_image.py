"""``mx.recordio`` and ``mx.image`` held against the reference on the CPU.

* Records: both packages write byte-identical ``.rec`` and ``.idx``
  files for the same records (the dmlc framing: magic, 29-bit length and
  continuation flag, 4-byte padding; long payloads split into parts);
  each reads the other's headers and payloads, multi-label headers too.
* Image payloads: PIL's JPEG and PNG bytes (PIL is here) and, without
  PIL, the ``NPYF`` container, identical in both; each decodes the
  other's.
* Augmenters: those that draw nothing give the reference's pixels
  bitwise.  Those that draw are held to the parameters the reference
  drew: the port's draw helpers are pointed at Python's ``random`` (the
  reference's stream) for the test, so ``params(src)`` returns the
  reference's crop, flip or jitter, and ``apply(src, *params)`` with
  those parameters gives the reference's pixels bitwise (LightingAug
  draws with numpy in the reference: its weights are passed in).
* ``ImageIter`` over a ``.rec`` and over a ``.lst`` with image files:
  the reference's batches, labels and pads.
"""
import random
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.image as jimage
import mxnet_tpu.recordio as jrec

import mxnet_tpu_torch as mt
import mxnet_tpu_torch.image.image as pimage
import mxnet_tpu_torch.recordio as trec


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _images(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (20 + i, 24 - i, 3)).astype(np.uint8)
            for i in range(n)]


def _write(mod, prefix, images, fmt=".png"):
    w = mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, img in enumerate(images):
        label = float(i % 3) if i % 2 else [float(i), 0.5, -1.0]
        w.write_idx(i, mod.pack_img(mod.IRHeader(0, label, i, 7), img,
                                    img_fmt=fmt))
    w.close()


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_record_files_are_byte_identical(fmt, tmp_path):
    imgs = _images()
    _write(jrec, str(tmp_path / "r"), imgs, fmt)
    _write(trec, str(tmp_path / "t"), imgs, fmt)
    for ext in (".rec", ".idx"):
        assert open(str(tmp_path / ("t" + ext)), "rb").read() \
            == open(str(tmp_path / ("r" + ext)), "rb").read()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_records(writer, tmp_path):
    imgs = _images()
    src, dst = (trec, jrec) if writer == "port" else (jrec, trec)
    _write(src, str(tmp_path / "a"), imgs)
    r = dst.MXIndexedRecordIO(str(tmp_path / "a.idx"),
                              str(tmp_path / "a.rec"), "r")
    assert r.keys == list(range(len(imgs)))
    for i in reversed(r.keys):
        header, img = dst.unpack_img(r.read_idx(i))
        np.testing.assert_array_equal(img, imgs[i])
        assert header.id == i and header.id2 == 7
        if i % 2:
            assert header.flag == 0 and header.label == float(i % 3)
        else:
            np.testing.assert_array_equal(header.label, [i, 0.5, -1.0])
    r.close()


def test_continuation_records(tmp_path, monkeypatch):
    """A payload past the length field's reach goes out in parts
    (start, middle, end): both packages write the same bytes and read
    each other's (the field is narrowed to 5 bits for the test)."""
    for mod in (jrec, trec):
        monkeypatch.setattr(mod, "_LENGTH_MASK", 31)
    blobs = [bytes(range(70)), b"short", bytes(range(32))]
    for name, mod in (("r", jrec), ("t", trec)):
        w = mod.MXRecordIO(str(tmp_path / name), "w")
        for b in blobs:
            w.write(b)
        w.close()
    raw = open(str(tmp_path / "t"), "rb").read()
    assert raw == open(str(tmp_path / "r"), "rb").read()
    for name, mod in (("r", trec), ("t", jrec)):
        rd = mod.MXRecordIO(str(tmp_path / name), "r")
        assert [rd.read() for _ in blobs] == blobs
        assert rd.read() is None
    bad = str(tmp_path / "bad")
    open(bad, "wb").write(raw[:20])
    with pytest.raises(IOError):
        trec.MXRecordIO(bad, "r").read()


def test_npyf_payload_without_pil(monkeypatch):
    img = _images(1)[0]
    monkeypatch.setitem(sys.modules, "PIL", None)
    port = trec.pack_img(trec.IRHeader(0, 1.0, 3, 0), img)
    assert port[24:28] == b"NPYF"
    assert port == jrec.pack_img(jrec.IRHeader(0, 1.0, 3, 0), img)
    np.testing.assert_array_equal(jrec.unpack_img(port)[1], img)
    np.testing.assert_array_equal(trec.unpack_img(port)[1], img)


# ----------------------------------------------------------- augmenters
@pytest.fixture
def python_draws(monkeypatch):
    """The port's image draws from Python's ``random``, the reference's
    stream."""
    monkeypatch.setattr(pimage, "_uniform",
                        lambda gen, lo, hi: random.uniform(lo, hi))
    monkeypatch.setattr(pimage, "_randint",
                        lambda gen, lo, hi: random.randint(lo, hi))

    def permutation(gen, n):
        order = list(range(n))
        random.shuffle(order)
        return order
    monkeypatch.setattr(pimage, "_permutation", permutation)


def _src():
    return np.random.RandomState(4).randint(0, 256, (30, 26, 3)).astype(
        np.uint8)


def _host(x):
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _same(port, ref):
    p, r = _host(port), _host(ref)
    assert p.dtype == r.dtype and p.shape == r.shape
    np.testing.assert_array_equal(p, r)


DETERMINISTIC = [
    ("ResizeAug", (16,)), ("ForceResizeAug", ((12, 18),)),
    ("CenterCropAug", ((20, 16),)), ("CastAug", ()),
    ("ColorNormalizeAug", ([120.0, 110.0, 100.0], [50.0, 60.0, 70.0])),
]


@pytest.mark.parametrize("name,args", DETERMINISTIC,
                         ids=[d[0] for d in DETERMINISTIC])
def test_augmenters_that_draw_nothing(name, args):
    src = _src()
    _same(getattr(pimage, name)(*args)(src),
          getattr(jimage, name)(*args)(jmx.nd.array(src, dtype=np.uint8)))


def test_image_functions():
    src = _src()
    jsrc = jmx.nd.array(src, dtype=np.uint8)
    _same(pimage.imresize(src, 13, 17, 2), jimage.imresize(jsrc, 13, 17, 2))
    _same(pimage.resize_short(src, 20), jimage.resize_short(jsrc, 20))
    _same(pimage.fixed_crop(src, 2, 3, 10, 12, (8, 8)),
          jimage.fixed_crop(jsrc, 2, 3, 10, 12, (8, 8)))
    _same(pimage.center_crop(src, (12, 10))[0],
          jimage.center_crop(jsrc, (12, 10))[0])
    _same(pimage.color_normalize(src, 127.0, 30.0),
          jimage.color_normalize(jsrc, 127.0, 30.0))
    assert pimage.scale_down((20, 10), (30, 30)) == \
        jimage.scale_down((20, 10), (30, 30))
    png = trec._encode_img(src, 95, ".png")
    _same(pimage.imdecode(png), jimage.imdecode(png))


DRAWING = [
    ("RandomCropAug", ((16, 12),)),
    ("RandomSizedCropAug", ((14, 14), (0.3, 1.0), (0.75, 1.33))),
    ("HorizontalFlipAug", (0.5,)),
    ("BrightnessJitterAug", (0.4,)), ("ContrastJitterAug", (0.4,)),
    ("SaturationJitterAug", (0.4,)), ("HueJitterAug", (0.3,)),
    ("ColorJitterAug", (0.3, 0.3, 0.3)), ("RandomGrayAug", (0.5,)),
]


@pytest.mark.parametrize("name,args", DRAWING, ids=[d[0] for d in DRAWING])
def test_augmenters_that_draw(name, args, python_draws):
    src = _src()
    paug = getattr(pimage, name)(*args)
    jaug = getattr(jimage, name)(*args)
    for seed in range(4):
        random.seed(seed)
        want = jaug(jmx.nd.array(src, dtype=np.uint8))
        random.seed(seed)
        params = paug.params(src)
        _same(paug.apply(src, *params), want)


def test_lighting_aug_with_the_references_weights():
    src = _src().astype(np.float32)
    ev, evec = [55.46, 4.794, 1.148], [[-0.5675, 0.7192, 0.4009],
                                       [-0.5808, -0.0045, -0.8140],
                                       [-0.5836, -0.6948, 0.4203]]
    np.random.seed(1)
    want = jimage.LightingAug(0.1, ev, evec)(jmx.nd.array(src))
    np.random.seed(1)
    alpha = np.random.normal(0, 0.1, size=(3,))
    _same(pimage.LightingAug(0.1, ev, evec).apply(src, alpha), want)


def test_create_augmenter_chain_and_random_order(python_draws):
    kw = dict(resize=28, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.2, contrast=0.2, saturation=0.2,
              hue=0.1, rand_gray=0.3)
    pch = pimage.CreateAugmenter((3, 20, 20), **kw)
    jch = jimage.CreateAugmenter((3, 20, 20), **kw)
    assert [type(a).__name__ for a in pch] == [type(a).__name__ for a in jch]
    src = _src()
    random.seed(5)
    want = jimage.RandomOrderAug(jch)(jmx.nd.array(src, dtype=np.uint8))
    random.seed(5)
    _same(pimage.RandomOrderAug(pch)(src), want)
    assert pch[0].dumps() == jch[0].dumps()


def test_augmenter_generators_are_explicit():
    """Without the test's redirection each drawing augmenter draws from
    its own generator: the same seed gives the same draws."""
    import torch
    src = _src()
    a = pimage.RandomCropAug((10, 10), generator=torch.Generator()
                             .manual_seed(3))
    b = pimage.RandomCropAug((10, 10), generator=torch.Generator()
                             .manual_seed(3))
    assert [a.params(src) for _ in range(5)] == \
        [b.params(src) for _ in range(5)]


# ------------------------------------------------------------ ImageIter
def test_image_iter_over_a_record_file(tmp_path):
    imgs = [np.random.RandomState(i).randint(0, 256, (36, 40, 3)).astype(
        np.uint8) for i in range(7)]
    _write(jrec, str(tmp_path / "d"), imgs)
    kw = dict(batch_size=3, data_shape=(3, 32, 32),
              path_imgrec=str(tmp_path / "d.rec"), mean=True, std=True,
              label_width=1)
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
            for b in jimage.ImageIter(**kw)]
    got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
           for b in pimage.ImageIter(**kw)]
    assert len(got) == len(want) == 3
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp
    it = pimage.ImageIter(shuffle=True, seed=1, **kw)
    labels = sorted(np.concatenate([b.label[0].asnumpy()[:3 - b.pad]
                                    for b in it]).tolist())
    assert labels == sorted(np.concatenate([w[1][:3 - w[2]]
                                            for w in want]).tolist())


def test_image_iter_over_a_list_file(tmp_path):
    from PIL import Image
    lines = []
    for i, img in enumerate(_images(5)):
        name = "img%d.png" % i
        Image.fromarray(img).save(str(tmp_path / name))
        lines.append("%d\t%f\t%f\t%s" % (i, i * 1.5, -i, name))
    open(str(tmp_path / "d.lst"), "w").write("\n".join(lines) + "\n")
    kw = dict(batch_size=2, data_shape=(3, 16, 16), label_width=2,
              path_imglist=str(tmp_path / "d.lst"), path_root=str(tmp_path))
    for jb, tb in zip(jimage.ImageIter(**kw), pimage.ImageIter(**kw)):
        np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                      jb.data[0].asnumpy())
        np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                      jb.label[0].asnumpy())
        assert tb.pad == jb.pad
