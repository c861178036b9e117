"""``mx.io`` — the data iterators (counterpart of ``mxnet_tpu.io``):
``DataDesc``, ``DataBatch``, the ``DataIter`` protocol, ``NDArrayIter``,
``CSVIter``, ``MNISTIter``, ``ResizeIter``, ``ImageRecordIter``, the
prefetchers ``PrefetchingIter`` and ``DevicePrefetcher``, and the staging
and padding helpers ``ensure_staged``, ``is_staged``, ``bucket_sizes``,
``pick_bucket`` and ``pad_rows_to``.

``NDArrayIter`` keeps the reference's batch order exactly: one
``numpy.random.shuffle`` of the sample order per ``reset()`` when
shuffling, and the same ``pad`` / ``discard`` / ``roll_over`` handling of
the last short batch, so with the same numpy seed both packages give the
same batches.  Batches are NDArrays on the current context (``cuda:0``
unless the caller asks for the CPU); float64 and int64 data arrive as
float32 and int32, as the reference's (32-bit) arrays do, while
``provide_data`` reports the source arrays' dtypes, as the reference's.

``DevicePrefetcher`` is the port's own design of the reference's device
staging (which calls ``jax.device_put`` with a sharding): a background
thread pulls host batches, pads them to a bucket, copies each array into
a pinned host buffer and from there to the card on a side CUDA stream,
and records an event; the consumer's stream waits on that event when it
takes the batch, so the training loop gets device tensors and never
blocks on the copy (``io.h2d_async`` counts the staged arrays,
``io.h2d_sync`` the copies a consumer had to make itself).  The thread
runs the inner iterators under ``with mx.cpu():``.
``ImageDetRecordIter`` reads detection records over ``ImageIter``.  Not
ported: ``LibSVMIter`` (it needs the sparse arrays).
"""
from __future__ import annotations

import logging
import queue
import threading
import time as _time
from collections import namedtuple

import numpy as _np
import torch

from . import config as _config
from . import telemetry as _telemetry
from .context import Context, cpu, current_context, resolve_device
from .ndarray.ndarray import NDArray, _wrap, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "ResizeIter", "PrefetchingIter", "DevicePrefetcher", "MNISTIter",
           "ImageRecordIter", "ImageDetRecordIter", "ensure_staged",
           "is_staged", "bucket_sizes", "pick_bucket", "pad_rows_to"]

_LOG = logging.getLogger("mxnet_tpu_torch.io")

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


class _Wrapping(DataIter):
    """An iterator that batches through an inner ``NDArrayIter``."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class CSVIter(_Wrapping):
    """A CSV reader (reference: ``src/io/iter_csv.cc``): the files load
    whole with numpy, then batch as ``NDArrayIter`` (the short last batch
    padded, or dropped when ``round_batch`` is False)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32,
                           ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32,
                                ndmin=1)
            label = label.reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard")
        super().__init__(batch_size)


class MNISTIter(_Wrapping):
    """The MNIST idx-format reader (reference: ``src/io/iter_mnist.cc``):
    images scaled to [0, 1] as ``N x 1 x H x W`` (``flat``: ``N x HW``),
    labels as float32, shuffled by numpy's global stream at each reset
    (``NDArrayIter``).  ``.gz`` files are read through gzip."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 **kwargs):
        import gzip
        import struct

        def read_idx(path):
            op = gzip.open if path.endswith(".gz") else open
            with op(path, "rb") as f:
                magic = struct.unpack(">HBB", f.read(4))
                ndim = magic[2]
                dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
                return _np.frombuffer(f.read(),
                                      dtype=_np.uint8).reshape(dims)

        img = read_idx(image).astype(_np.float32) / 255.0
        lbl = read_idx(label).astype(_np.float32)
        if flat:
            img = img.reshape(img.shape[0], -1)
        else:
            img = img.reshape(img.shape[0], 1, *img.shape[1:])
        self._inner = NDArrayIter({"data": img}, {"softmax_label": lbl},
                                  batch_size, shuffle=shuffle)
        super().__init__(batch_size)


class ResizeIter(DataIter):
    """An iterator cut or extended to ``size`` batches an epoch
    (reference: ``python/mxnet/io/io.py`` ``ResizeIter``): the inner
    iterator restarts when it runs out."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur >= self.size:
            raise StopIteration
        self.cur += 1
        try:
            return self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            return self.data_iter.next()


# --------------------------------------------------------------------- #
# staging and padding
# --------------------------------------------------------------------- #

def _placement_device(placement):
    """A placement (None: the current context; a Context, a
    ``torch.device`` or a device string) as a ``torch.device``."""
    if isinstance(placement, (Context, torch.device, str)) \
            or placement is None:
        return resolve_device(placement)
    raise TypeError("placement must be None, a Context, a torch.device or "
                    "a device string, got %r" % (placement,))


def is_staged(x, placement=None):
    """Whether ``x`` (an NDArray or a tensor) already lives on the
    placement's device (with no placement: on any CUDA device)."""
    if isinstance(x, NDArray):
        x = x._data
    if not isinstance(x, torch.Tensor):
        return False
    if placement is None:
        return x.device.type == "cuda"
    dev = _placement_device(placement)
    return x.device.type == dev.type and (
        dev.index is None or x.device.index == dev.index)


def ensure_staged(x, placement=None, source="step"):
    """``x`` as a tensor on the placement's device (default: the current
    context's).  A tensor already there passes through untouched; anything
    else is copied on the caller's thread and counted as a synchronous
    transfer (``io.h2d_sync`` and ``io.h2d_sync.<source>``): with a
    ``DevicePrefetcher`` in front these stay flat."""
    if isinstance(x, NDArray):
        x = x._data
    dev = _placement_device(placement)
    if isinstance(x, torch.Tensor) and is_staged(x, dev):
        return x
    _telemetry.counter("io.h2d_sync").inc()
    _telemetry.counter("io.h2d_sync." + source).inc()
    t0 = _time.perf_counter()
    out = torch.as_tensor(x).to(dev)
    _telemetry.timer("io.h2d_ms").observe(
        (_time.perf_counter() - t0) * 1e3)
    _telemetry.counter("io.staged_bytes").inc(out.numel()
                                              * out.element_size())
    return out


def bucket_sizes(policy, batch_size):
    """The row counts a short batch may be padded up to: ``"full"`` ->
    ``(batch_size,)``; ``"pow2"`` -> the powers of two below
    ``batch_size``, then ``batch_size``; ``"off"`` -> none."""
    policy = str(policy or "off").strip().lower()
    if policy in ("off", "none", ""):
        return ()
    if policy == "full":
        return (batch_size,)
    if policy == "pow2":
        sizes, b = [], 1
        while b < batch_size:
            sizes.append(b)
            b *= 2
        sizes.append(batch_size)
        return tuple(sizes)
    raise ValueError(
        "io.pad_buckets must be 'off', 'full' or 'pow2', got %r" % (policy,))


def pick_bucket(buckets, n):
    """The smallest bucket that holds ``n`` rows, or None."""
    return next((b for b in buckets if b >= n), None)


def pad_rows_to(arr, target, fill=None):
    """``arr`` padded along axis 0 to ``target`` rows: by wrapping (the
    pad rows repeat the first rows, as ``NDArrayIter``'s pad) or, with
    ``fill``, with that constant (a sentinel id).  Numpy stays numpy, a
    tensor a tensor and an NDArray an NDArray on its device."""
    if isinstance(arr, (NDArray, torch.Tensor)):
        t = arr._data if isinstance(arr, NDArray) else arr
        n = t.shape[0]
        if fill is None:
            idx = torch.arange(target - n, device=t.device) % max(n, 1)
            tail = t[idx]
        else:
            tail = torch.full((target - n,) + tuple(t.shape[1:]), fill,
                              dtype=t.dtype, device=t.device)
        out = torch.cat([t, tail], dim=0)
        return _wrap(out) if isinstance(arr, NDArray) else out
    host = _np.asarray(arr)
    n = host.shape[0]
    if fill is None:
        tail = host[_np.arange(target - n) % max(n, 1)]
    else:
        tail = _np.full((target - n,) + host.shape[1:], fill, host.dtype)
    return _np.concatenate([host, tail], axis=0)


def _shutdown_worker(thread, stop, q, deadline_s=5.0):
    """Stop a prefetch thread: set ``stop``, keep its queue drained so a
    blocked ``put`` returns, and join until ``deadline_s``.  False (and
    ``io.prefetch_thread_leaked``) when it did not stop: the caller must
    not start another on the same inner iterators."""
    stop.set()
    if thread is None:
        return True
    deadline = _time.perf_counter() + deadline_s
    while thread.is_alive():
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        remaining = deadline - _time.perf_counter()
        if remaining <= 0:
            break
        thread.join(timeout=min(0.2, remaining))
    if thread.is_alive():
        _telemetry.counter("io.prefetch_thread_leaked").inc()
        _LOG.warning("prefetch thread did not stop within %.1fs",
                     deadline_s)
        return False
    return True


class _WorkerFailure:
    """What a prefetch thread queues when it fails: the consumer raises
    ``exc`` instead of waiting on an empty queue."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _Prefetcher(DataIter):
    """A background thread that keeps ``depth`` items ahead of the
    consumer in a queue; subclasses make each item (``_produce``)."""

    def __init__(self, iters, depth):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        if depth is None:
            depth = _config.get("io.prefetch_depth")
        self.iters = list(iters)
        self._context = current_context()
        self._queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._thread = None
        self._exhausted = False
        self._start()

    @property
    def provide_data(self):
        return self.iters[0].provide_data

    @property
    def provide_label(self):
        return self.iters[0].provide_label

    def _pull(self):
        from .resilience import call_with_retry
        return [call_with_retry(it.next, kind="io") for it in self.iters]

    def _start(self):
        stop, q = self._stop, self._queue

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            with self._context:
                while not stop.is_set():
                    try:
                        item = self._produce()
                    except StopIteration:
                        put(None)
                        return
                    except BaseException as exc:  # noqa: BLE001
                        put(_WorkerFailure(exc))
                        return
                    if not put(item):
                        return

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="mx-prefetch")
        self._thread.start()

    def reset(self):
        if not _shutdown_worker(self._thread, self._stop, self._queue):
            raise RuntimeError(
                "prefetch thread did not stop within the reset deadline; "
                "recreate the iterator instead of rewinding it")
        for it in self.iters:
            it.reset()
        self._exhausted = False
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._queue.maxsize)
        self._start()

    def _take(self, gauge):
        if self._exhausted:
            raise StopIteration
        _telemetry.gauge(gauge).set(self._queue.qsize())
        item = self._queue.get()
        if item is None:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, _WorkerFailure):
            self._exhausted = True
            raise item.exc
        return item


class PrefetchingIter(_Prefetcher):
    """Double buffering on a background thread (reference:
    ``src/io/iter_prefetcher.h``): the inner iterators' batches, made
    under the creating thread's context, ``depth`` ahead of the consumer
    (``io.prefetch_depth``); ``io.prefetch_queue_depth`` samples the
    queue at each take."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 depth=None):
        super().__init__(iters, depth)

    def _produce(self):
        batches = self._pull()
        return batches[0] if len(batches) == 1 else batches

    def next(self):
        return self._take("io.prefetch_queue_depth")


class _Slot:
    """One pinned host buffer of the ring and the event of the last copy
    out of it."""

    __slots__ = ("host", "copied")

    def __init__(self, like):
        self.host = torch.empty(like.shape, dtype=like.dtype,
                                pin_memory=True)
        self.copied = None


class DevicePrefetcher(_Prefetcher):
    """Device-side prefetch (reference: ``io.py:609``), redesigned for
    the card.

    A background thread pulls each batch from the inner iterators on the
    host (under ``with mx.cpu():``), wrap-pads a short one up to a bucket
    (``io.pad_buckets``; ``DataBatch.pad`` counts the fill rows, and
    integer arrays take ``pad_sentinel`` when it is given) and, with
    ``io.device_prefetch`` on and a CUDA placement, stages it: each array
    is copied into a pinned host buffer of a ring, then from there into a
    new device tensor on a side CUDA stream, after which an event is
    recorded.  ``next()`` hands the batch over with the consumer's
    current stream waiting on that event, so the consumer never blocks on
    the copy.

    Reuse guard.  A pinned buffer is written again only after the event
    of its last copy has completed (the thread waits on it); the ring
    holds ``depth + 2`` buffers an array, so in steady state that event
    is long past.  Device tensors are never reused by the prefetcher:
    each batch gets new ones from the caching allocator on the side
    stream, and ``next()`` marks them used on the consumer's stream
    (``record_stream``), so their memory goes back to the side stream
    only after the work the consumer queued on them has finished.

    ``placement``: where batches go (None: the creating thread's current
    context; a Context, a ``torch.device``, a device string, or a zero-
    argument callable giving one, asked again each batch until it gives
    one).  On a CPU placement the batches stay on the host.  Telemetry:
    ``io.h2d_async`` (arrays staged), ``io.staged_bytes``, the
    ``io.h2d_ms`` timer (host time to queue a batch's copies),
    ``io.ring_occupancy`` (queue size at each take),
    ``io.pad_recompiles_avoided`` and ``io.pad_fallback``."""

    def __init__(self, iters, placement=None, depth=None, buckets=None,
                 rename_data=None, rename_label=None, pad_sentinel=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if depth is None:
            depth = _config.get("io.prefetch_depth")
        if buckets is None:
            buckets = _config.get("io.pad_buckets")
        self._placement = placement
        self._pad_sentinel = pad_sentinel
        self._buckets = bucket_sizes(buckets, iters[0].batch_size)
        self._seen_shapes = set()
        self._ring = {}          # (position, shape, dtype) -> [_Slot]
        self._ring_size = max(1, int(depth)) + 2
        self._ring_next = {}
        self._stream = None
        super().__init__(iters, depth)

    # ---------------------------------------------------------- padding
    def _pad_rows(self, arr, target):
        if self._pad_sentinel is not None and not (
                arr._data if isinstance(arr, NDArray) else
                torch.as_tensor(arr)).is_floating_point():
            return pad_rows_to(arr, target, fill=self._pad_sentinel)
        return pad_rows_to(arr, target)

    def _pad_to_bucket(self, batch):
        if not self._buckets or not batch.data:
            return batch
        n = int(batch.data[0].shape[0])
        target = pick_bucket(self._buckets, n)
        if target is None or target == n:
            return batch
        try:
            data = [self._pad_rows(a, target) for a in batch.data]
            label = [self._pad_rows(a, target) for a in batch.label]
        except (TypeError, ValueError, RuntimeError, IndexError) as exc:
            _telemetry.counter("io.pad_fallback").inc()
            _LOG.warning("bucketed padding failed (%s); staging the batch "
                         "at its own %d rows", exc, n)
            return batch
        if tuple(tuple(a.shape) for a in data) in self._seen_shapes:
            _telemetry.counter("io.pad_recompiles_avoided").inc()
        return DataBatch(
            data, label, pad=int(batch.pad or 0) + target - n,
            index=batch.index,
            provide_data=_repad(batch.provide_data, target),
            provide_label=_repad(batch.provide_label, target))

    # ---------------------------------------------------------- staging
    def _device(self):
        """The placement's device, or None while a lazy placement gives
        none yet."""
        p = self._placement
        if p is None:
            return resolve_device(self._context)
        if callable(p) and not isinstance(p, (Context, torch.device, str)):
            p = p()
            if p is None:
                return None
        return _placement_device(p)

    def _slot(self, pos, t):
        key = (pos, tuple(t.shape), t.dtype)
        ring = self._ring.get(key)
        if ring is None:
            ring = self._ring[key] = [_Slot(t)
                                      for _ in range(self._ring_size)]
            self._ring_next[key] = 0
        i = self._ring_next[key]
        self._ring_next[key] = (i + 1) % len(ring)
        return ring[i]

    def _stage(self, batch, dev):
        """Copy the batch's arrays to ``dev`` on the side stream; returns
        the staged batch and the event its copies end in."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        t0 = _time.perf_counter()
        staged = []
        for pos, a in enumerate(list(batch.data) + list(batch.label)):
            t = a._data if isinstance(a, NDArray) else torch.as_tensor(a)
            slot = self._slot(pos, t)
            if slot.copied is not None:
                slot.copied.synchronize()
            slot.host.copy_(t)
            with torch.cuda.stream(self._stream):
                out = torch.empty(t.shape, dtype=t.dtype, device=dev)
                out.copy_(slot.host, non_blocking=True)
                slot.copied = torch.cuda.Event()
                slot.copied.record(self._stream)
            staged.append(out)
            _telemetry.counter("io.h2d_async").inc()
            _telemetry.counter("io.staged_bytes").inc(t.numel()
                                                      * t.element_size())
        done = torch.cuda.Event()
        done.record(self._stream)
        _telemetry.timer("io.h2d_ms").observe(
            (_time.perf_counter() - t0) * 1e3)
        nd = len(batch.data)
        return DataBatch(staged[:nd], staged[nd:], pad=batch.pad,
                         index=batch.index,
                         provide_data=batch.provide_data,
                         provide_label=batch.provide_label), done

    def _produce(self):
        with cpu():
            batches = [self._pad_to_bucket(b) for b in self._pull()]
        for b in batches:
            self._seen_shapes.add(tuple(tuple(a.shape) for a in b.data))
        dev = self._device() if _config.get("io.device_prefetch") else None
        if dev is None or dev.type != "cuda":
            return [(_host_batch(b), None) for b in batches]
        return [self._stage(b, dev) for b in batches]

    def next(self):
        items = self._take("io.ring_occupancy")
        out = []
        for batch, done in items:
            if done is not None:
                stream = torch.cuda.current_stream(batch.data[0].device)
                stream.wait_event(done)
                tensors = list(batch.data) + list(batch.label)
                for t in tensors:
                    t.record_stream(stream)
                nd = len(batch.data)
                batch.data = [_wrap(t) for t in tensors[:nd]]
                batch.label = [_wrap(t) for t in tensors[nd:]]
            out.append(batch)
        return out[0] if len(out) == 1 else out


def _host_batch(batch):
    """A batch whose numpy arrays are NDArrays on the CPU (what a CPU
    consumer takes without a copy of its own)."""
    def nd(a):
        if isinstance(a, NDArray):
            return a
        if isinstance(a, torch.Tensor):
            return _wrap(a)
        return array(a, ctx=cpu())
    batch.data = [nd(a) for a in batch.data]
    batch.label = [nd(a) for a in batch.label]
    return batch


def _repad(descs, rows):
    if not descs:
        return descs
    out = []
    for d in descs:
        if isinstance(d, DataDesc):
            out.append(DataDesc(d.name, (rows,) + tuple(d.shape[1:]),
                                d.dtype, d.layout))
        else:
            out.append((d[0], (rows,) + tuple(d[1])[1:]) + tuple(d[2:]))
    return out


def ImageRecordIter(path_imgrec, batch_size, data_shape, **kwargs):
    """The classification RecordIO iterator (reference: ``io.py:1045``,
    ``src/io/iter_image_recordio_2.cc``): ``mx.image.ImageIter`` over
    ``path_imgrec`` and its ``.idx``, the augmenter arguments passed
    through.  The native pipeline's tuning arguments
    (``preprocess_threads``, ``prefetch_buffer``, ...) are accepted and
    ignored (``io.decode_workers`` sizes the decode threads);
    ``round_batch=False`` drops the short last batch."""
    from .image import ImageIter
    for ignored in ("preprocess_threads", "prefetch_buffer", "verify_decode",
                    "num_backup_threads"):
        kwargs.pop(ignored, None)
    if not kwargs.pop("round_batch", True):
        kwargs.setdefault("last_batch_handle", "discard")
    return ImageIter(batch_size=batch_size, data_shape=data_shape,
                     path_imgrec=path_imgrec, **kwargs)


class ImageDetRecordIter(DataIter):
    """The detection RecordIO iterator (reference: ``io.py:967``,
    ``src/io/iter_image_det_recordio.cc``).

    Records carry im2rec's flat detection label ``[A, B, extra...,
    objects]``: ``A`` header values (these two included), then objects of
    ``B`` values each, ``[id, xmin, ymin, xmax, ymax, ...]``.  Batches
    hold NCHW float32 data and labels ``(batch, label_pad_width, 5)``,
    each image's objects followed by rows of ``label_pad_value``.  Without
    ``label_pad_width`` the width is the most objects of any record, from
    one scan of the headers (no image is decoded).  Decoding, the
    augmenters (``aug_list``, image-only; none by default) and sharding
    are ``mx.image.ImageIter``'s."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=-1,
                 label_pad_width=-1, label_pad_value=-1.0, shuffle=False,
                 part_index=0, num_parts=1, aug_list=None, **kwargs):
        super().__init__(batch_size)
        from .image.image import ImageIter
        self._img_iter = ImageIter(
            batch_size=batch_size, data_shape=data_shape,
            path_imgrec=path_imgrec, shuffle=shuffle, part_index=part_index,
            num_parts=num_parts, aug_list=aug_list if aug_list is not None
            else [], **kwargs)
        self.data_shape = tuple(data_shape)
        self._pad_value = float(label_pad_value)
        if label_pad_width > 0:
            self._pad_width = label_pad_width
        else:
            from .recordio import unpack
            width = 1
            for key in self._img_iter._keys:
                header, _ = unpack(self._img_iter._rec.read_idx(key))
                width = max(width, len(self._objects(header.label)))
            self._pad_width = width

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size, self._pad_width, 5))]

    def reset(self):
        self._img_iter.reset()

    @staticmethod
    def _objects(flat):
        """The ``(objects, 5)`` rows of one flat detection label."""
        flat = _np.asarray(flat, _np.float32).ravel()
        if flat.size < 2:
            return _np.zeros((0, 5), _np.float32)
        header = int(flat[0])
        owidth = int(flat[1])
        body = flat[header:]
        nobj = len(body) // owidth
        return body[:nobj * owidth].reshape(nobj, owidth)[:, :5]

    def next(self):
        t0 = _time.perf_counter()
        C, H, W = self.data_shape
        samples, pad = self._img_iter._batch_samples()
        batch_data = _np.zeros((self.batch_size, C, H, W), _np.float32)
        width = self._pad_width
        label = _np.full((self.batch_size, width, 5), self._pad_value,
                         _np.float32)
        for slot, d, lab in samples:
            batch_data[slot] = d
            objs = self._objects(lab)
            m = min(len(objs), width)
            label[slot, :m] = objs[:m]
        _telemetry.timer("io.batch_host_ms").observe(
            (_time.perf_counter() - t0) * 1e3)
        return DataBatch([array(batch_data)], [array(label)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
