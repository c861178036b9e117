"""``DataLoader``: mini-batches of a Dataset (counterpart of
``mxnet_tpu.gluon.data.dataloader``; reference
``python/mxnet/gluon/data/dataloader.py:534``).

With ``num_workers=0`` each batch is collated on the calling thread by
``batchify_fn`` (``default_batchify_fn``: NDArrays on the current
context).  With workers, batches are made ahead (``prefetch``, default
twice the workers) on a thread pool, or on a process pool with
``thread_pool=False`` (started by ``start_method``, spawn by default,
each worker indexing the dataset's ``host_view()``).  Workers
never touch CUDA: they collate on the CPU, and the consumer moves each
batch to its current context as it takes it (with ``pin_memory``,
through pinned host memory and a non-blocking copy).
"""
from __future__ import annotations

import concurrent.futures as _cf
import multiprocessing
from concurrent.futures import ThreadPoolExecutor, ProcessPoolExecutor

import numpy as _np
import torch

from ...context import cpu
from ...ndarray.ndarray import NDArray, _wrap, array as nd_array
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Collate a list of samples into a batch (reference:
    ``dataloader.py:126``): NDArrays stack, tuples collate field by field,
    anything else goes through ``numpy.asarray`` (float64 as float32)."""
    if isinstance(data[0], NDArray):
        return nd_array(_np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(list(i)) for i in zip(*data)]
    data = _np.asarray(data)
    return nd_array(data, dtype=data.dtype if data.dtype != _np.float64
                    else _np.float32)


def _to_host(out):
    """A batch's arrays as numpy (what a worker process sends back)."""
    if isinstance(out, NDArray):
        return out.asnumpy()
    if isinstance(out, torch.Tensor):
        return out.numpy()
    if isinstance(out, (list, tuple)):
        return type(out)(_to_host(o) for o in out)
    return out


def _from_host(out):
    if isinstance(out, _np.ndarray):
        return _wrap(torch.from_numpy(out))
    if isinstance(out, (list, tuple)):
        return type(out)(_from_host(o) for o in out)
    return out


def _map_arrays(fn, out):
    if isinstance(out, NDArray):
        return _wrap(fn(out._data))
    if isinstance(out, (list, tuple)):
        return type(out)(_map_arrays(fn, o) for o in out)
    return out


_worker_dataset = None


def _worker_initializer(dataset):
    global _worker_dataset
    _worker_dataset = dataset


def _worker_fn(samples, batchify_fn, dataset):
    """Collate one batch on the CPU (a thread of the pool)."""
    with cpu():
        return batchify_fn([dataset[i] for i in samples])


def _process_worker_fn(samples, batchify_fn):
    """Collate one batch in a worker process; numpy goes back."""
    with cpu():
        return _to_host(batchify_fn([_worker_dataset[i] for i in samples]))


class DataLoader:
    """Loads data from a dataset and returns mini-batches (reference:
    ``dataloader.py:534``)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=True, timeout=120,
                 start_method=None):
        self._pool = None
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._thread_pool = thread_pool
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn
        if self._num_workers > 0:
            if thread_pool:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._num_workers)
            else:
                ctx = multiprocessing.get_context(start_method or "spawn")
                host_ds = dataset.host_view() if hasattr(
                    dataset, "host_view") else dataset
                self._pool = ProcessPoolExecutor(
                    max_workers=self._num_workers, mp_context=ctx,
                    initializer=_worker_initializer, initargs=(host_ds,))

    def __iter__(self):
        if self._num_workers == 0:
            def same_thread():
                for batch in self._batch_sampler:
                    yield self._batchify_fn([self._dataset[i]
                                             for i in batch])
            return same_thread()
        return _PrefetchIter(self)

    def __len__(self):
        return len(self._batch_sampler)

    def __del__(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)


class _PrefetchIter:
    """Batches made ``prefetch`` ahead on the loader's pool, taken in
    order, each moved to the consumer's current context."""

    def __init__(self, loader):
        from ...context import current_context
        self._loader = loader
        self._iter = iter(loader._batch_sampler)
        self._pending = []
        self._device = current_context()
        for _ in range(max(1, loader._prefetch)):
            self._push_next()

    def _push_next(self):
        batch = next(self._iter, None)
        if batch is None:
            return
        loader = self._loader
        if loader._thread_pool:
            fut = loader._pool.submit(_worker_fn, batch,
                                      loader._batchify_fn, loader._dataset)
        else:
            fut = loader._pool.submit(_process_worker_fn, batch,
                                      loader._batchify_fn)
        self._pending.append(fut)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._pending:
            raise StopIteration
        fut = self._pending.pop(0)
        try:
            out = fut.result(timeout=self._loader._timeout)
        except _cf.TimeoutError:
            self._pending.insert(0, fut)
            raise
        except Exception:
            self._push_next()
            raise
        self._push_next()
        if not self._loader._thread_pool:
            out = _from_host(out)
        dev = self._device.torch_device
        if self._loader._pin_memory and dev.type == "cuda":
            out = _map_arrays(lambda t: t.pin_memory().to(
                dev, non_blocking=True), out)
        elif dev.type != "cpu":
            out = _map_arrays(lambda t: t.to(dev), out)
        return out
