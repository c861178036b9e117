"""Vision datasets (counterpart of
``mxnet_tpu.gluon.data.vision.datasets``; reference
``python/mxnet/gluon/data/vision/datasets.py``): MNIST, FashionMNIST,
CIFAR10/100, ImageRecordDataset and ImageFolderDataset.  They read local
files under ``root`` in the reference's formats and download nothing: a
missing file raises ``FileNotFoundError``.  Images are NDArrays on the
CPU (the data pipeline runs on the host).
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import warnings

import numpy as _np

from ..dataset import Dataset, RecordFileDataset
from ....context import cpu
from ....ndarray.ndarray import array as nd_array

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    """Base class for MNIST/CIFAR-style pre-staged datasets
    (reference: vision/datasets.py:45)."""

    def __init__(self, root, transform):
        super().__init__()
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST handwritten digits from pre-staged idx-format files
    (reference: vision/datasets.py:70)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte.gz", None)
        self._train_label = ("train-labels-idx1-ubyte.gz", None)
        self._test_data = ("t10k-images-idx3-ubyte.gz", None)
        self._test_label = ("t10k-labels-idx1-ubyte.gz", None)
        self._namespace = "mnist"
        super().__init__(root, transform)

    def _read_idx(self, path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            raw = f.read()
        magic = struct.unpack(">I", raw[:4])[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, raw[4:4 + 4 * ndim])
        return _np.frombuffer(raw, dtype=_np.uint8,
                              offset=4 + 4 * ndim).reshape(dims)

    def _find(self, fname):
        for cand in (os.path.join(self._root, fname),
                     os.path.join(self._root, fname[:-3])):
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(
            "%s dataset file %r not found under %s (nothing is downloaded; "
            "put the standard idx files there)" % (
                self._namespace, fname, self._root))

    def _get_data(self):
        if self._train:
            data_file, label_file = self._train_data[0], self._train_label[0]
        else:
            data_file, label_file = self._test_data[0], self._test_label[0]
        label = self._read_idx(self._find(label_file)).astype(_np.int32)
        data = self._read_idx(self._find(data_file))
        data = data.reshape(data.shape + (1,))
        self._data = nd_array(data, ctx=cpu(), dtype=_np.uint8)
        self._label = label


class FashionMNIST(MNIST):
    """FashionMNIST clothing-article images (reference: vision/datasets.py:119)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte.gz", None)
        self._train_label = ("train-labels-idx1-ubyte.gz", None)
        self._test_data = ("t10k-images-idx3-ubyte.gz", None)
        self._test_label = ("t10k-labels-idx1-ubyte.gz", None)
        self._namespace = "fashion-mnist"
        _DownloadedDataset.__init__(self, root, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 image dataset from the pre-staged python pickle batches
    (reference: vision/datasets.py:157)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        self._namespace = "cifar10"
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            batch = pickle.load(fin, encoding="latin1")
        data = _np.asarray(batch["data"], dtype=_np.uint8)
        data = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = batch.get("labels", batch.get("fine_labels"))
        return data, _np.asarray(labels, dtype=_np.int32)

    def _batch_files(self):
        base = os.path.join(self._root, "cifar-10-batches-py")
        if not os.path.isdir(base):
            base = self._root
        if self._train:
            return [os.path.join(base, "data_batch_%d" % i) for i in range(1, 6)]
        return [os.path.join(base, "test_batch")]

    def _get_data(self):
        files = self._batch_files()
        for f in files:
            if not os.path.exists(f):
                raise FileNotFoundError(
                    "%s batch file %r not found (nothing is downloaded; put "
                    "the python-version batches there)"
                    % (self._namespace, f))
        data, label = zip(*[self._read_batch(f) for f in files])
        data = _np.concatenate(data)
        label = _np.concatenate(label)
        self._data = nd_array(data, ctx=cpu(), dtype=_np.uint8)
        self._label = label


class CIFAR100(CIFAR10):
    """CIFAR100 image dataset (reference: vision/datasets.py:214)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        self._train = train
        self._namespace = "cifar100"
        _DownloadedDataset.__init__(self, root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            batch = pickle.load(fin, encoding="latin1")
        data = _np.asarray(batch["data"], dtype=_np.uint8)
        data = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = batch["fine_labels" if self._fine_label else "coarse_labels"]
        return data, _np.asarray(labels, dtype=_np.int32)

    def _batch_files(self):
        base = os.path.join(self._root, "cifar-100-python")
        if not os.path.isdir(base):
            base = self._root
        return [os.path.join(base, "train" if self._train else "test")]


class ImageRecordDataset(RecordFileDataset):
    """Dataset wrapping over a RecordIO file containing images
    (reference: vision/datasets.py:260)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....recordio import unpack
        from ....image import imdecode
        record = super().__getitem__(idx)
        header, img = unpack(record)
        if self._transform is not None:
            return self._transform(imdecode(img, self._flag), header.label)
        return imdecode(img, self._flag), header.label


class ImageFolderDataset(Dataset):
    """A dataset loading image files stored folder-per-class
    (reference: vision/datasets.py:300)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                warnings.warn("Ignoring %s, which is not a directory." % path,
                              stacklevel=3)
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    warnings.warn(
                        "Ignoring %s of type %s. Only support %s" % (
                            filename, ext, ", ".join(self._exts)))
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        from ....image import imread
        img = imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
