"""``gluon.data`` and ``gluon.contrib.data`` held against the reference on
the CPU: the same batches, samples and pixels (bitwise) from the same
numpy inputs and from files the tests write (MNIST idx, CIFAR pickles,
PNG folders, a record file, a WikiText snippet).

* ``DataLoader`` with 0 and 2 workers (threads) and with a process
  worker, under ``SequentialSampler`` and ``last_batch`` keep, discard
  and rollover: the reference's batches.
* The samplers, the ``Dataset`` methods and the vision datasets.
* The transforms: those that draw nothing bitwise; those that draw with
  the parameters the reference drew (the port's draw helpers pointed at
  Python's ``random`` for the test, then ``apply`` with the drawn
  parameters), RandomLighting with the reference's numpy weights.
"""
import os
import pickle
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.contrib import data as jcdata
from mxnet_tpu.gluon.data.vision import transforms as jtf

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.contrib import data as tcdata
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _assert_same(got, want):
    got, want = _host(got), _host(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _dataset(lib, n=11):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 3).astype(np.float32)
    y = rng.randint(0, 4, (n,)).astype(np.int32)
    return lib.gluon.data.ArrayDataset(x, y)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_matches_the_reference(workers, last_batch):
    kw = dict(batch_size=4, last_batch=last_batch, num_workers=workers)
    jl = jdata.DataLoader(_dataset(jmx), **kw)
    tl = tdata.DataLoader(_dataset(mt), **kw)
    assert len(tl) == len(jl)
    for _ in range(2):        # rollover carries the tail to the next pass
        want, got = list(jl), list(tl)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)


def test_dataloader_process_worker():
    kw = dict(batch_size=5, num_workers=1, thread_pool=False)
    want = list(jdata.DataLoader(_dataset(jmx), batch_size=5))
    got = list(tdata.DataLoader(_dataset(mt), **kw))
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_dataloader_batch_sampler_and_errors():
    bs = tdata.BatchSampler(tdata.SequentialSampler(7), 3, "keep")
    got = list(tdata.DataLoader(_dataset(mt, 7), batch_sampler=bs))
    assert [len(g[0]) for g in got] == [3, 3, 1]
    with pytest.raises(ValueError):
        tdata.DataLoader(_dataset(mt), batch_size=2, batch_sampler=bs)
    with pytest.raises(ValueError):
        tdata.DataLoader(_dataset(mt))


def test_samplers():
    for last in ("keep", "discard", "rollover"):
        js = jdata.BatchSampler(jdata.SequentialSampler(10), 4, last)
        ts = tdata.BatchSampler(tdata.SequentialSampler(10), 4, last)
        for _ in range(2):
            assert list(ts) == list(js)
            assert len(ts) == len(js)
    for length, interval, roll in ((10, 3, True), (10, 3, False)):
        assert list(tcdata.IntervalSampler(length, interval, roll)) == \
            list(jcdata.IntervalSampler(length, interval, roll))
        assert len(tcdata.IntervalSampler(length, interval, roll)) == \
            len(jcdata.IntervalSampler(length, interval, roll))
    import torch
    r = tdata.RandomSampler(20, generator=torch.Generator().manual_seed(1))
    a, b = list(r), list(r)
    assert sorted(a) == list(range(20)) and a != b and len(r) == 20


def test_dataset_methods():
    jd, td = _dataset(jmx), _dataset(mt)
    cases = [lambda d: d.transform(lambda x, y: (x * 2, y + 1)),
             lambda d: d.transform_first(lambda x: x - 1),
             lambda d: d.transform(lambda x, y: x.sum(), lazy=False),
             lambda d: d.filter(lambda s: s[1] > 1),
             lambda d: d.shard(3, 1), lambda d: d.take(4),
             lambda d: d.sample(tdata.SequentialSampler(5))]
    for case in cases:
        jv, tv = case(jd), case(td)
        assert len(tv) == len(jv)
        for i in range(len(jv)):
            _assert_same(tv[i], jv[i])
    assert len(tdata.SimpleDataset([1, 2, 3])) == 3


# ------------------------------------------------------ vision datasets
def _write_idx(path, arr):
    import gzip
    import struct
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


def test_mnist_and_fashion_mnist(tmp_path):
    rng = np.random.RandomState(1)
    for split in ("train", "t10k"):
        n = 6 if split == "train" else 3
        _write_idx(str(tmp_path / ("%s-images-idx3-ubyte.gz" % split)),
                   rng.randint(0, 256, (n, 28, 28)))
        _write_idx(str(tmp_path / ("%s-labels-idx1-ubyte.gz" % split)),
                   rng.randint(0, 10, (n,)))
    for name in ("MNIST", "FashionMNIST"):
        for train in (True, False):
            jd = getattr(jdata.vision, name)(str(tmp_path), train=train)
            td = getattr(tdata.vision, name)(str(tmp_path), train=train)
            assert len(td) == len(jd)
            for i in range(len(jd)):
                _assert_same(td[i][0], jd[i][0])
                assert int(td[i][1]) == int(jd[i][1])
    with pytest.raises(FileNotFoundError):
        tdata.vision.MNIST(str(tmp_path / "empty"))


def test_cifar(tmp_path):
    rng = np.random.RandomState(2)
    base10 = tmp_path / "cifar-10-batches-py"
    base10.mkdir()
    for name in ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]:
        with open(str(base10 / name), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (2, 3072)),
                         "labels": list(rng.randint(0, 10, 2))}, f)
    base100 = tmp_path / "cifar-100-python"
    base100.mkdir()
    for name in ("train", "test"):
        with open(str(base100 / name), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (3, 3072)),
                         "fine_labels": list(rng.randint(0, 100, 3)),
                         "coarse_labels": list(rng.randint(0, 20, 3))}, f)
    for jd, td in ((jdata.vision.CIFAR10(str(tmp_path)),
                    tdata.vision.CIFAR10(str(tmp_path))),
                   (jdata.vision.CIFAR100(str(tmp_path), fine_label=True,
                                          train=False),
                    tdata.vision.CIFAR100(str(tmp_path), fine_label=True,
                                          train=False))):
        assert len(td) == len(jd)
        for i in range(len(jd)):
            _assert_same(td[i][0], jd[i][0])
            assert int(td[i][1]) == int(jd[i][1])
    with pytest.raises(FileNotFoundError):
        tdata.vision.CIFAR10(str(tmp_path / "none"))


def test_image_folder_and_record_datasets(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(3)
    imgs = {}
    for cls in ("cat", "dog"):
        (tmp_path / "f" / cls).mkdir(parents=True)
        for i in range(2):
            img = rng.randint(0, 256, (8, 9, 3)).astype(np.uint8)
            Image.fromarray(img).save(str(tmp_path / "f" / cls /
                                          ("%d.png" % i)))
            imgs[(cls, i)] = img
    jd = jdata.vision.ImageFolderDataset(str(tmp_path / "f"))
    td = tdata.vision.ImageFolderDataset(str(tmp_path / "f"))
    assert td.synsets == jd.synsets and len(td) == len(jd) == 4
    for i in range(4):
        _assert_same(td[i][0], jd[i][0])
        assert td[i][1] == jd[i][1]
    prefix = str(tmp_path / "r")
    w = mt.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, img in enumerate(imgs.values()):
        w.write_idx(i, mt.recordio.pack_img(
            mt.recordio.IRHeader(0, float(i), i, 0), img, img_fmt=".png"))
    w.close()
    rd = tdata.vision.ImageRecordDataset(prefix + ".rec",
                                         transform=lambda x, y: (x, y * 2))
    assert len(rd) == 4
    for i, img in enumerate(imgs.values()):
        _assert_same(rd[i][0], img)
        assert rd[i][1] == 2 * i
    # the reference's RecordFileDataset imports a name its recordio lacks
    with pytest.raises(ImportError):
        jdata.vision.ImageRecordDataset(prefix + ".rec")


def test_wikitext(tmp_path):
    text = "the cat sat on the mat\n the dog sat\n\n a cat ran\n"
    for name in ("train", "valid", "test"):
        (tmp_path / ("wiki.%s.tokens" % name)).write_text(text)
    for cls in ("WikiText2", "WikiText103"):
        jd = getattr(jcdata, cls)(str(tmp_path), seq_len=4)
        td = getattr(tcdata, cls)(str(tmp_path), segment="validation",
                                  seq_len=4)
        assert len(td) == len(jd)
        for i in range(len(jd)):
            _assert_same(td[i][0], jd[i][0])
            _assert_same(td[i][1], jd[i][1])
    with pytest.raises(FileNotFoundError):
        tcdata.WikiText2(str(tmp_path / "none"))


# ------------------------------------------------------------ transforms
def _img(dtype=np.uint8):
    return np.random.RandomState(5).randint(0, 256, (13, 11, 3)).astype(dtype)


DETERMINISTIC = [
    lambda m: m.ToTensor(), lambda m: m.Cast("float16"),
    lambda m: m.Resize(7), lambda m: m.Resize((6, 9), interpolation=0),
    lambda m: m.Resize(8, keep_ratio=True), lambda m: m.CenterCrop(6),
    lambda m: m.CenterCrop((16, 15)),
    lambda m: m.CropResize(1, 2, 6, 5, size=(4, 4)),
    lambda m: m.Compose([m.Cast("float32"), m.Resize(6), m.ToTensor(),
                         m.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4])]),
]


@pytest.mark.parametrize("i", range(len(DETERMINISTIC)))
def test_transforms_that_draw_nothing(i):
    img = _img()
    _assert_same(DETERMINISTIC[i](ttf)(mt.nd.array(img, dtype=np.uint8)),
                 DETERMINISTIC[i](jtf)(jmx.nd.array(img, dtype=np.uint8)))


@pytest.fixture
def python_draws(monkeypatch):
    monkeypatch.setattr(ttf, "_uniform",
                        lambda gen, lo, hi: random.uniform(lo, hi))
    monkeypatch.setattr(ttf, "_randint",
                        lambda gen, lo, hi: random.randint(lo, hi))

    def permutation(gen, n):
        order = list(range(n))
        random.shuffle(order)
        return order
    monkeypatch.setattr(ttf, "_permutation", permutation)


DRAWING = [
    lambda m: m.RandomCrop(8, pad=2), lambda m: m.RandomCrop((16, 15)),
    lambda m: m.RandomResizedCrop(6, scale=(0.3, 1.0)),
    lambda m: m.RandomFlipLeftRight(), lambda m: m.RandomFlipTopBottom(),
    lambda m: m.RandomBrightness(0.3), lambda m: m.RandomContrast(0.3),
    lambda m: m.RandomSaturation(0.3), lambda m: m.RandomHue(0.2),
    lambda m: m.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
]


@pytest.mark.parametrize("i", range(len(DRAWING)))
def test_transforms_that_draw(i, python_draws):
    img = _img()
    pt, jt = DRAWING[i](ttf), DRAWING[i](jtf)
    for seed in range(3):
        random.seed(seed)
        want = jt(jmx.nd.array(img, dtype=np.uint8))
        random.seed(seed)
        x = mt.nd.array(img, dtype=np.uint8)
        _assert_same(pt.apply(x, *pt.params(x)), want)


def test_random_lighting_with_the_references_weights():
    img = _img(np.float32)
    np.random.seed(4)
    want = jtf.RandomLighting(0.1)(jmx.nd.array(img))
    np.random.seed(4)
    alpha = np.random.normal(0, 0.1, size=(3,)).astype(np.float32)
    _assert_same(ttf.RandomLighting(0.1).apply(mt.nd.array(img), alpha),
                 want)


def test_transforms_in_a_loader():
    """A ``transform_first`` chain through a 2-worker DataLoader: the
    reference's batches."""
    rng = np.random.RandomState(6)
    imgs = rng.randint(0, 256, (6, 10, 10, 3)).astype(np.uint8)
    labels = np.arange(6, dtype=np.int32)
    out = {}
    for lib, tf in ((jmx, jtf), (mt, ttf)):
        ds = lib.gluon.data.ArrayDataset(
            [lib.nd.array(i, dtype=np.uint8) for i in imgs], labels)
        chain = tf.Compose([tf.Resize(8), tf.ToTensor(),
                            tf.Normalize(0.5, 0.25)])
        loader = lib.gluon.data.DataLoader(ds.transform_first(chain),
                                           batch_size=4, num_workers=2)
        out[lib] = list(loader)
    for g, w in zip(out[mt], out[jmx]):
        _assert_same(g, w)
    assert os.path.exists(os.path.dirname(tdata.__file__))
