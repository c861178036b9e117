"""``mx.io``, its in-memory part (counterpart of ``mxnet_tpu.io``):
``DataDesc``, ``DataBatch``, the ``DataIter`` protocol and
``NDArrayIter``.

``NDArrayIter`` keeps the reference's batch order exactly: one
``numpy.random.shuffle`` of the sample order per ``reset()`` when
shuffling, and the same ``pad`` / ``discard`` / ``roll_over`` handling of
the last short batch, so with the same numpy seed both packages give the
same batches.  Batches are NDArrays on the current context (``cuda:0``
unless the caller asks for the CPU); float64 and int64 data arrive as
float32 and int32, as the reference's (32-bit) arrays do, while
``provide_data`` reports the source arrays' dtypes, as the reference's.
The record, image, MNIST and prefetching iterators are not ported yet.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as _np

from .ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]

# numpy dtypes that arrive in 32 bits, as the reference's default arrays
_NARROW = {_np.dtype(_np.float64): _np.float32,
           _np.dtype(_np.int64): _np.int32,
           _np.dtype(_np.uint64): _np.uint32}


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Named shape/dtype descriptor (reference: python/mxnet/io/io.py
    DataDesc)."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), _np.dtype(dtype),
                               layout)


class DataBatch:
    """One batch: list of data arrays + list of label arrays + pad count."""

    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label if label is not None else []
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __repr__(self):
        shapes = [getattr(d, "shape", None) for d in self.data]
        return "DataBatch: data shapes %s" % (shapes,)


class DataIter:
    """Iterator protocol (reference: python/mxnet/io/io.py DataIter).

    Subclasses implement ``next()`` raising StopIteration, plus
    ``provide_data``/``provide_label`` and ``reset()``.
    """

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        raise NotImplementedError

    def __next__(self):
        return self.next()

    # legacy pull-style API
    def iter_next(self):
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            self._next_batch = None
            return False

    def getdata(self):
        return self._next_batch.data

    def getlabel(self):
        return self._next_batch.label

    def getindex(self):
        return self._next_batch.index

    def getpad(self):
        return self._next_batch.pad


def _as_arrays(data, prefix):
    """Normalize dict/list/array input to ordered [(name, ndarray)]."""
    if data is None:
        return []
    if isinstance(data, dict):
        items = list(data.items())
    elif isinstance(data, (list, tuple)):
        items = [("%s%d" % (prefix, i) if i else prefix, d)
                 for i, d in enumerate(data)]
    else:
        items = [(prefix, data)]
    out = []
    for name, d in items:
        if isinstance(d, NDArray):
            d = d.asnumpy()
        out.append((name, _np.asarray(d)))
    return out


class NDArrayIter(DataIter):
    """Batching iterator over in-memory arrays (reference:
    python/mxnet/io/io.py NDArrayIter: shuffle, pad/discard/roll_over
    last-batch handling)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _as_arrays(data, data_name)
        self.label = _as_arrays(label, label_name)
        self.num_data = self.data[0][1].shape[0] if self.data else 0
        for _, d in self.data + self.label:
            assert d.shape[0] == self.num_data, "inconsistent data length"
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._order = _np.arange(self.num_data)
        self.cursor = -batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(n, (self.batch_size,) + d.shape[1:], d.dtype)
                for n, d in self.data]

    @property
    def provide_label(self):
        return [DataDesc(n, (self.batch_size,) + d.shape[1:], d.dtype)
                for n, d in self.label]

    def reset(self):
        """pad: wrap-pad the final short batch. discard: drop it.
        roll_over: its samples lead the NEXT epoch (reference NDArrayIter
        semantics — no duplication within an epoch)."""
        leftover = None
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            leftover = self._order[self.cursor:self.num_data].copy()
        if self.shuffle:
            _np.random.shuffle(self._order)
        if leftover is not None and len(leftover):
            rest = self._order[~_np.isin(self._order, leftover)] \
                if self.shuffle else \
                self._order[:len(self._order) - len(leftover)]
            # leftover samples first, then the rest of the (re)ordered epoch
            self._order = _np.concatenate(
                [leftover, rest[:self.num_data - len(leftover)]])
        self.cursor = -self.batch_size

    def _slice(self, arrs):
        start = self.cursor
        end = start + self.batch_size
        out = []
        for _, d in arrs:
            idx = self._order[start:min(end, self.num_data)]
            part = d[idx]
            if end > self.num_data:  # pad by wrapping
                wrap = self._order[0:end - self.num_data]
                part = _np.concatenate([part, d[wrap]], axis=0)
            out.append(array(part.astype(_NARROW.get(part.dtype,
                                                      part.dtype),
                                         copy=False)))
        return out

    def next(self):
        self.cursor += self.batch_size
        if self.cursor >= self.num_data:
            raise StopIteration
        end = self.cursor + self.batch_size
        pad = max(0, end - self.num_data)
        if pad and self.last_batch_handle in ("discard", "roll_over"):
            # roll_over: leave cursor where it is; reset() rolls the unseen
            # samples into the next epoch
            raise StopIteration
        return DataBatch(self._slice(self.data), self._slice(self.label),
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)
