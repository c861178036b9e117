"""KVStore on one device (counterpart of ``mxnet_tpu.kvstore``).

The push/pull/updater semantics follow the reference
(``kvstore_local.h``): ``push`` sums a list of values (the per-device
copies) into the store, or hands the sum to the updater when one is set
(``set_optimizer``: the update_on_kvstore placement); ``pull`` copies the
stored value into each output.  With one device the sum of one value is
that value, no copy.  ``local``, ``device``, ``nccl`` and the
``local_allreduce_*`` types all mean this one-device store; the
distributed types (``dist_*``) are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from . import optimizer as opt
from .ndarray.ndarray import _wrap

__all__ = ["KVStore", "create"]

_LOCAL_TYPES = ("local", "device", "nccl", "local_allreduce_cpu",
                "local_allreduce_device")
_DIST_TYPES = ("dist_sync", "dist_device_sync", "dist_async",
               "dist_sync_device")


def _normalize(key, value):
    if isinstance(key, (list, tuple)):
        return [str(k) for k in key], list(value)
    return [str(key)], [value]


def _key_int(k):
    try:
        return int(k)
    except ValueError:
        return k


class KVStore:
    """A key-value store for parameter synchronization on one device
    (reference: include/mxnet/kvstore.h:59, python/mxnet/kvstore.py:66)."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        """Initializes one or more key-value pairs (reference:
        kvstore.py:139); a key already present keeps its value."""
        keys, values = _normalize(key, value)
        for k, v in zip(keys, values):
            if k not in self._store:
                self._store[k] = _wrap(v._data.detach())

    @staticmethod
    def _merge(value):
        """The sum of the per-device copies (CommDevice::Reduce,
        src/kvstore/comm.h:451); one value is itself."""
        if isinstance(value, (list, tuple)):
            merged = value[0]._data
            for v in value[1:]:
                merged = merged + v._data.to(merged.device)
            return merged
        return value._data

    def push(self, key, value, priority=0):
        """Pushes (sums) value(s) into the store, or through the updater
        (reference: kvstore.py:178; KVStoreLocal::PushImpl)."""
        keys, values = _normalize(key, value)
        with torch.no_grad():
            for k, v in zip(keys, values):
                merged = self._merge(v)
                if self._updater is not None:
                    self._updater(_key_int(k), _wrap(merged), self._store[k])
                else:
                    self._store[k]._data = merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copies the stored value(s) into ``out`` (reference:
        kvstore.py:248); each output keeps its dtype and device."""
        if out is None:
            raise ValueError("pull needs out=")
        keys, outs = _normalize(key, out)
        for k, o in zip(keys, outs):
            src = self._store[k]._data
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                t._data = src.detach().to(device=t._data.device,
                                          dtype=t._data.dtype)

    def pushpull(self, key, value, out=None, priority=0):
        """Combined push and pull (reference: kvstore.py:290)."""
        self.push(key, value, priority)
        self.pull(key, value if out is None else out, priority)

    def set_optimizer(self, optimizer):
        """Run updates on the store (update_on_kvstore; reference:
        kvstore.py:399)."""
        self._updater = opt.get_updater(optimizer)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Write the store's optimizer states to ``fname``, atomically
        (reference ``kvstore.py:317``)."""
        from .resilience import atomic_write
        if self._updater is None:
            raise RuntimeError("Cannot save states: no optimizer was set")
        with atomic_write(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Read states :meth:`save_optimizer_states` wrote (this
        package's or the reference's)."""
        if self._updater is None:
            raise RuntimeError("Cannot load states: no optimizer was set")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())


def create(name="local"):
    """Creates a KVStore (reference: python/mxnet/kvstore.py:649)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in _DIST_TYPES:
        raise NotImplementedError(
            "kvstore %r is not ported yet: the distributed stores come "
            "with the multi-card slice" % name)
    if name not in _LOCAL_TYPES:
        raise ValueError("Unknown KVStore type %r" % name)
    return KVStore(name)
