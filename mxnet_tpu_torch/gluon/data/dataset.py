"""Datasets (counterpart of ``mxnet_tpu.gluon.data.dataset``; reference
``python/mxnet/gluon/data/dataset.py``): ``Dataset`` with its lazy
``transform`` / ``transform_first``, ``filter``, ``shard``, ``take`` and
``sample``; ``SimpleDataset``, ``ArrayDataset`` and ``RecordFileDataset``
over a RecordIO file and its ``.idx``.
"""
from __future__ import annotations

import os

from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "_TransformedDataset"]


class Dataset:
    """Abstract dataset class (reference: data/dataset.py:31)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """Returns a new dataset with samples filtered by fn."""
        indices = [i for i in range(len(self)) if fn(self[i])]
        return _SampledDataset(self, indices)

    def host_view(self):
        """What a process-pool DataLoader worker indexes: an equivalent
        dataset whose items hold no device arrays (default: this one)."""
        return self

    def shard(self, num_shards, index):
        """Returns a shard of the dataset (reference: dataset.py:71): the
        ``index``-th of ``num_shards`` contiguous parts, the first
        ``len % num_shards`` one longer."""
        if not 0 <= index < num_shards:
            raise ValueError("Shard index of out bound: %d out of %d"
                             % (index, num_shards))
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return _SampledDataset(self, list(range(start, end)))

    def take(self, count):
        if count is None or count > len(self):
            count = len(self)
        return _SampledDataset(self, list(range(count)))

    def sample(self, sampler):
        return _SampledDataset(self, list(sampler))

    def transform(self, fn, lazy=True):
        """Returns a new dataset with each sample transformed by fn
        (reference: dataset.py:124)."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """Transform only the first element of each sample
        (reference: dataset.py:154)."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """Simple Dataset wrapper for lists and arrays
    (reference: dataset.py:183)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


_TransformedDataset = _LazyTransformDataset


class _SampledDataset(Dataset):
    def __init__(self, dataset, indices):
        self._dataset = dataset
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]


class ArrayDataset(Dataset):
    """Dataset of multiple equal-length arrays (reference: dataset.py:211)."""

    def __init__(self, *args):
        if not args:
            raise ValueError("Needs at least 1 arrays")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise ValueError(
                    "All arrays must have the same length; batch %d has "
                    "length %d while the first has length %d."
                    % (i, len(data), self._length))
            if isinstance(data, NDArray) and len(data.shape) == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length

    def host_view(self):
        """An equivalent dataset whose items are host numpy: what a
        process-pool DataLoader worker indexes (workers never touch
        CUDA)."""
        import numpy as _host_np

        def host(d):
            if isinstance(d, NDArray):
                return d.asnumpy()
            if isinstance(d, list):
                # convert ELEMENTS too: a device array inside a list column
                # would re-create the fork hazard this method removes
                return [host(x) for x in d]
            return _host_np.asarray(d)

        out = ArrayDataset.__new__(ArrayDataset)
        out._length = self._length
        out._data = [host(d) for d in self._data]
        return out


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO (.rec) file and its ``.idx`` (reference:
    dataset.py:242); items are the records' bytes.  The reference's copy
    imports ``recordio.IndexedRecordIO``, a name its ``recordio`` does not
    have; this one opens ``MXIndexedRecordIO``."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = MXIndexedRecordIO(self.idx_file, self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
