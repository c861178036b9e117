"""KVStore (counterpart of ``mxnet_tpu.kvstore``): one device, or the
ranks of a ``torch.distributed`` group.

The push/pull/updater semantics follow the reference
(``kvstore_local.h``): ``push`` sums a list of values (the per-device
copies) into the store, or hands the sum to the updater when one is set
(``set_optimizer``: the update_on_kvstore placement); ``pull`` copies the
stored value into each output.  ``local``, ``device``, ``nccl`` and the
``local_allreduce_*`` types all mean the one-device store.

The distributed types (``dist_sync``, ``dist_device_sync``,
``dist_sync_device``, and ``dist_async``, the reference's documented
synchronous alias) join the process group when they are created
(``parallel.ensure_initialized``: the launcher's environment names it),
and ``push`` sums every rank's value (``parallel.host_allreduce``: the
rows added in rank order, so every rank holds the same sum) before the
store or the updater sees it: the dist_sync contract of the reference's
nightly test, value-exact.  Under 2-bit compression
(``set_gradient_compression({"type": "2bit", ...})`` or the
``kvstore.grad_compress`` knob) the merged value is coded against a
per-key error-feedback residual and only the packed codes (four a byte)
cross the ranks.

``push`` and ``pull`` retry a transient error with backoff
(``resilience.call_with_retry``, kind ``kvstore``, which also draws the
``kvstore`` fault before any key is touched); the dist store's hop draws
``dcn_push`` before it sends, so push's retry re-runs it without applying
anything twice.
"""
from __future__ import annotations

import torch

from . import optimizer as opt
from . import resilience as _resilience
from . import telemetry as _telemetry
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
    """A key-value store for parameter synchronization (reference:
    include/mxnet/kvstore.h:59, python/mxnet/kvstore.py:66)."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        self._compression_params = None
        self._residuals = {}
        self._is_dist = kv_type.startswith("dist")
        if self._is_dist:
            # creating a dist kvstore is the worker's rendezvous, as in
            # the reference (ps::KVWorker construction)
            from .parallel import ensure_initialized
            ensure_initialized()

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        """This worker's rank (reference ``KVStore::get_rank``)."""
        from .parallel.dist import rank
        return rank() if self._is_dist else 0

    @property
    def num_workers(self):
        from .parallel.dist import world_size
        return world_size() if self._is_dist else 1

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

    def _allreduce_dist(self, val):
        """The sum over the workers (the ps-lite server merge,
        kvstore_dist_server.h:349), rows added in rank order."""
        if self.num_workers == 1:
            return val
        # the simulated hop failure: before the hop, so push's retry
        # re-runs it without applying anything twice
        _resilience.inject("dcn_push")
        from .parallel import host_allreduce
        return host_allreduce(val)

    def _allreduce_codes(self, codes):
        """The sum over the workers of 2-bit codes: the wire carries the
        packed form (four codes a byte, 1/16 of the f32 bytes); each worker
        unpacks the others' rows and sums them (int32)."""
        if self.num_workers == 1:
            return codes
        _resilience.inject("dcn_push")
        from .parallel import host_allgather
        from .parallel.compression import note_wire, pack_2bit, unpack_2bit
        from . import tracing as _tracing
        shape, n = codes.shape, codes.numel()
        packed = pack_2bit(codes)
        note_wire(packed.numel(), n * 4)
        with _tracing.span("allreduce_2bit", cat="collective"):
            rows = host_allgather(packed)
            total = torch.zeros(shape, dtype=torch.int32,
                                device=codes.device)
            for w in range(rows.shape[0]):
                total = total + unpack_2bit(rows[w], n).reshape(shape)
        return total

    def _compression_threshold(self):
        from . import config as _config
        params = self._compression_params or {}
        return float(params.get(
            "threshold", _config.get("kvstore.grad_compression_threshold")))

    def _compress(self, k, merged):
        """2-bit codes of ``merged`` against key ``k``'s residual:
        ``(payload, compressed, new_residual)``; the caller commits the
        residual after the hop.  Off unless compression is set (or the
        ``kvstore.grad_compress`` knob is ``2bit``) and there are 2-127
        workers (summed int8 codes must not overflow)."""
        from . import config as _config
        ctype = (self._compression_params or {}).get("type") or \
            _config.get("kvstore.grad_compress")
        if ctype != "2bit" or not 1 < self.num_workers <= 127:
            return merged, False, None
        from .parallel.compression import two_bit_compress
        res = self._residuals.get(k)
        if res is None:
            res = torch.zeros_like(merged)
        codes, new_res = two_bit_compress(merged, res,
                                          self._compression_threshold())
        return codes, True, new_res

    def push(self, key, value, priority=0):
        """Pushes (sums) value(s) into the store, or through the updater
        (reference: kvstore.py:178; KVStoreLocal::PushImpl); a dist store
        sums over the workers first.  A transient error is retried with
        backoff; the ``kvstore`` fault is drawn before any key is merged,
        so a retried injected fault applies nothing twice.  In a
        ``kvstore.push`` span (the 2-bit hop in ``allreduce_2bit``)."""
        from . import tracing as _tracing
        keys, values = _normalize(key, value)
        with _tracing.span("kvstore.push", cat="kvstore", keys=len(keys)):
            _resilience.call_with_retry(self._push_impl, keys, values,
                                        kind="kvstore", inject_faults=True)

    def _push_impl(self, keys, values):
        with torch.no_grad():
            for k, v in zip(keys, values):
                merged = self._merge(v)
                if self._is_dist:
                    payload, compressed, new_res = self._compress(k, merged)
                    if compressed:
                        reduced = self._allreduce_codes(payload)
                        self._residuals[k] = new_res
                        # sum(codes) * threshold: the decompressed sum
                        merged = reduced.to(merged.dtype) * \
                            self._compression_threshold()
                    else:
                        merged = self._allreduce_dist(merged)
                if self._updater is not None:
                    self._updater(_key_int(k), _wrap(merged), self._store[k])
                else:
                    self._store[k]._data = merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copies the stored value(s) into ``out`` (reference:
        kvstore.py:248); each output keeps its dtype and device.  In a
        ``kvstore.pull`` span."""
        if out is None:
            raise ValueError("pull needs out=")
        from . import tracing as _tracing
        keys, outs = _normalize(key, out)
        # a pull is a copy from the store: retrying it is always safe
        with _tracing.span("kvstore.pull", cat="kvstore", keys=len(keys)):
            _resilience.call_with_retry(self._pull_impl, keys, outs,
                                        kind="kvstore", inject_faults=True)

    def _pull_impl(self, keys, outs):
        for k, o in zip(keys, outs):
            src = self._store[k]._data
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                t._data = src.detach().to(device=t._data.device,
                                          dtype=t._data.dtype)

    def pushpull(self, key, value, out=None, priority=0):
        """Combined push and pull (reference: kvstore.py:290)."""
        self.push(key, value, priority)
        self.pull(key, value if out is None else out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` of a stored value (reference:
        kvstore.py:318, ``PullRowSparse``): ``out`` gets a dense array,
        zero except at those rows, which hold the store's values.
        Repeated ids are gathered once (the reference's ``Unique`` on the
        pull keys; ``kvstore.rowsparse_dedup_rows`` counts the repeats).
        Sparse NDArray outputs come with the sparse storage."""
        if out is None:
            raise ValueError("row_sparse_pull needs out=")
        if row_ids is None:
            self.pull(key, out, priority)
            return
        outs = out if isinstance(out, (list, tuple)) else [out]
        keys = key if isinstance(key, (list, tuple)) else [key] * len(outs)
        ids = row_ids if isinstance(row_ids, (list, tuple)) \
            else [row_ids] * len(outs)
        for k, o, rid in zip(keys, outs, ids):
            src = self._store[str(k)]._data
            rows = getattr(rid, "_data", rid)
            rows = torch.as_tensor(rows).reshape(-1).to(
                device=src.device, dtype=torch.int64)
            uniq = torch.unique(rows)
            dup = int(rows.numel()) - int(uniq.numel())
            if dup:
                _telemetry.counter("kvstore.rowsparse_dedup_rows").inc(dup)
            dense = torch.zeros_like(src)
            dense[uniq] = src[uniq]
            o._data = dense.to(device=o._data.device, dtype=o._data.dtype)

    def broadcast(self, key, value, out, priority=0):
        """``init`` then ``pull`` (reference ``kvstore.py:248``)."""
        self.init(key, value)
        self.pull(key, out, priority)

    def set_gradient_compression(self, compression_params):
        """2-bit gradient compression with error feedback (reference
        ``gradient_compression.cc:60``), applied to a dist store's push
        before the hop between workers: ``{"type": "2bit", "threshold":
        0.5}``.  Resets the residuals."""
        params = dict(compression_params or {})
        if params.get("type", "2bit") not in ("2bit", "none"):
            raise ValueError("unknown gradient compression type %r"
                             % (params.get("type"),))
        self._compression_params = params
        self._residuals = {}

    def set_optimizer(self, optimizer):
        """Run updates on the store (update_on_kvstore; reference:
        kvstore.py:399)."""
        self._updater = opt.get_updater(optimizer)

    def set_updater(self, updater):
        """Sets the push updater (reference ``kvstore.py:512``)."""
        self._updater = updater

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Write the store's optimizer states to ``fname``, atomically
        (reference ``kvstore.py:317``)."""
        from .resilience import atomic_write
        if not isinstance(self._updater, opt.Updater):
            raise RuntimeError("Cannot save states: no optimizer was set")
        with atomic_write(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Read states :meth:`save_optimizer_states` wrote (this
        package's or the reference's)."""
        if not isinstance(self._updater, opt.Updater):
            raise RuntimeError("Cannot load states: no optimizer was set")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    def barrier(self):
        """Global barrier across the workers (reference
        ``KVStore::Barrier``)."""
        if self._is_dist and self.num_workers > 1:
            from .parallel import barrier
            barrier()

    def _send_command_to_servers(self, head, body):
        """No servers: every worker merges in the collective."""


def create(name="local"):
    """Creates a KVStore (reference: python/mxnet/kvstore.py:649)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _LOCAL_TYPES + _DIST_TYPES:
        raise ValueError("Unknown KVStore type %r" % name)
    if name == "dist_async":
        # the reference's documented alias: no parameter server, so the
        # async mode's staleness buys nothing and training is synchronous
        import warnings
        warnings.warn(
            "kvstore 'dist_async' runs with SYNCHRONOUS semantics on this "
            "backend (no parameter server). Convergence is "
            "dist_sync-equivalent or better.", stacklevel=2)
    return KVStore(name)
