"""The ``mx.io`` iterators held against the reference's on the CPU: the
same batches (bitwise), pads and epoch ends, from files the tests write
(record files, CSV, MNIST idx) and in-memory arrays.

``ImageRecordIter`` (serial and over decode threads), ``CSVIter``,
``MNISTIter``, ``ResizeIter``, ``PrefetchingIter`` and
``DevicePrefetcher`` (on the CPU it pads to buckets on its thread and
stages nothing), ``bucket_sizes`` / ``pick_bucket`` / ``pad_rows_to``,
and ``ensure_staged``'s counters with ``SPMDTrainer`` as the consumer.
"""
import gzip
import struct

import numpy as np
import pytest
import torch

from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import telemetry as tt


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _batches(it, limit=50):
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [lab.asnumpy() for lab in b.label], b.pad))
        if len(out) >= limit:
            break
    return out


def _assert_batches(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.fixture
def rec_file(tmp_path):
    prefix = str(tmp_path / "imgs")
    w = jrec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(0)
    for i in range(11):
        img = rng.randint(0, 256, (40, 36, 3)).astype(np.uint8)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i % 5), i, 0),
                                     img, img_fmt=".png"))
    w.close()
    return prefix + ".rec"


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("round_batch", [True, False])
def test_image_record_iter(rec_file, workers, round_batch):
    kw = dict(path_imgrec=rec_file, batch_size=4, data_shape=(3, 32, 32),
              round_batch=round_batch, preprocess_threads=8)
    mt.config.set("io.decode_workers", workers)
    try:
        got = _batches(tio.ImageRecordIter(**kw))
    finally:
        mt.config.unset("io.decode_workers")
    want = _batches(jio.ImageRecordIter(**kw))
    _assert_batches(got, want)
    assert [p for *_, p in got] == ([0, 0, 1] if round_batch else [0, 0])


def test_csv_iter(tmp_path):
    rng = np.random.RandomState(1)
    np.savetxt(str(tmp_path / "d.csv"), rng.randn(10, 6), delimiter=",")
    np.savetxt(str(tmp_path / "l.csv"), rng.randint(0, 3, 10),
               delimiter=",")
    for round_batch in (True, False):
        kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
                  label_csv=str(tmp_path / "l.csv"), batch_size=4,
                  round_batch=round_batch)
        it = tio.CSVIter(**kw)
        _assert_batches(_batches(it), _batches(jio.CSVIter(**kw)))
        it.reset()
        assert len(_batches(it)) == (3 if round_batch else 2)


def _idx_file(path, arr, gz):
    head = struct.pack(">HBB", 0, 8, arr.ndim)
    head += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    op = gzip.open if gz else open
    with op(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter(tmp_path, flat):
    rng = np.random.RandomState(2)
    _idx_file(str(tmp_path / "img.gz"), rng.randint(0, 256, (10, 5, 4)),
              True)
    _idx_file(str(tmp_path / "lbl"), rng.randint(0, 10, (10,)), False)
    kw = dict(image=str(tmp_path / "img.gz"), label=str(tmp_path / "lbl"),
              batch_size=4, flat=flat)
    np.random.seed(7)
    want = _batches(jio.MNISTIter(**kw))
    np.random.seed(7)
    got = _batches(tio.MNISTIter(**kw))
    _assert_batches(got, want)


def _arrays(n=10):
    rng = np.random.RandomState(3)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 4, (n,)).astype(np.float32))


def test_resize_iter():
    X, Y = _arrays()
    for size in (2, 5):
        want = _batches(jio.ResizeIter(jio.NDArrayIter(X, Y, 4), size))
        got = _batches(tio.ResizeIter(tio.NDArrayIter(X, Y, 4), size))
        _assert_batches(got, want)


def test_prefetching_iter():
    X, Y = _arrays()
    it = tio.PrefetchingIter(tio.NDArrayIter(X, Y, 4), depth=2)
    want = _batches(jio.NDArrayIter(X, Y, 4))
    for _ in range(2):
        _assert_batches(_batches(it), want)
        it.reset()
    assert it.provide_data[0].shape == (4, 3)


class _Failing(tio.DataIter):
    def __init__(self):
        super().__init__(2)

    def next(self):
        raise RuntimeError("broken source")


def test_prefetcher_surfaces_worker_errors():
    for cls in (tio.PrefetchingIter, tio.DevicePrefetcher):
        it = cls(_Failing())
        with pytest.raises(RuntimeError, match="broken source"):
            next(it)


@pytest.mark.parametrize("policy", ["pow2", "full", "off"])
def test_device_prefetcher_pads_as_the_reference(policy):
    X, Y = _arrays(11)
    ids = np.arange(11, dtype=np.int32)
    kw = dict(buckets=policy, pad_sentinel=-1)
    want = _batches(jio.DevicePrefetcher(
        jio.NDArrayIter({"x": X, "ids": ids}, Y, 8), **kw))
    got = _batches(tio.DevicePrefetcher(
        tio.NDArrayIter({"x": X, "ids": ids}, Y, 8), **kw))
    _assert_batches(got, want)
    it = tio.DevicePrefetcher(tio.NDArrayIter(X, Y, 8, last_batch_handle=
                                              "discard"), buckets=policy)
    assert len(_batches(it)) == 1
    it.reset()
    assert len(_batches(it)) == 1


def test_bucket_helpers():
    for policy in ("off", "full", "pow2"):
        assert tio.bucket_sizes(policy, 20) == jio.bucket_sizes(policy, 20)
    with pytest.raises(ValueError):
        tio.bucket_sizes("nope", 8)
    buckets = tio.bucket_sizes("pow2", 20)
    for n in (1, 3, 8, 17, 20, 21):
        assert tio.pick_bucket(buckets, n) == jio.pick_bucket(buckets, n)
    a = np.arange(15, dtype=np.float32).reshape(5, 3)
    for fill in (None, -1.0):
        want = jio.pad_rows_to(a, 8, fill)
        np.testing.assert_array_equal(tio.pad_rows_to(a, 8, fill), want)
        np.testing.assert_array_equal(
            tio.pad_rows_to(mt.nd.array(a), 8, fill).asnumpy(), want)
        np.testing.assert_array_equal(
            tio.pad_rows_to(torch.from_numpy(a), 8, fill).numpy(), want)


def test_staging_counters_with_the_trainer():
    """A consumer fed host arrays copies them itself (``io.h2d_sync``); fed
    arrays already on its device, it counts nothing."""
    x = np.ones((2, 3), np.float32)
    assert not tio.is_staged(x)
    t = tio.ensure_staged(x, mt.cpu(), "test")
    assert tio.is_staged(t, mt.cpu()) and not tio.is_staged(t)
    assert tio.ensure_staged(t, mt.cpu()) is t
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    tr = mt.parallel.SPMDTrainer(
        net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1},
        mesh=mt.parallel.make_mesh({"dp": -1}, [mt.cpu()]))
    tt.reset()
    X, Y = _arrays(8)
    for b in tio.DevicePrefetcher(tio.NDArrayIter(X, Y, 4)):
        tr.step(b.data[0], b.label[0])
    assert tt.counter("io.h2d_sync").value == 0
    tr.step(X[:4], Y[:4])
    assert tt.counter("io.h2d_sync.step").value == 2
