"""Vocab-sharded embedding tables with deduplicated row-sparse lookups
and updates (counterpart of ``mxnet_tpu.parallel.embedding``).

A recommendation-scale table (10^5..10^9 rows, a batch touching a few
thousand) needs what the dense data-parallel step cannot give:

1. **No full-table replica.**  Over a multi-rank mesh the table is split
   on the vocab axis over one mesh axis: rank ``k`` holds rows
   ``[k * rows_per_shard, (k + 1) * rows_per_shard)`` and the same rows
   of the optimizer state.  A lookup gathers the ids each rank owns and
   sums the answers over the axis (``all_reduce``): the owner adds its
   row to the others' ``-0.0``, which is exact, so a sharded lookup is
   bitwise the one-rank lookup.
2. **Per-batch deduplication with static shapes.**  :func:`dedup_ids`
   sorts the ids, flags the first of each run and numbers the runs with a
   cumulative sum, and writes the unique ids into a ``[size]`` buffer
   filled with a sentinel: the reference's ``jnp.unique(size=,
   fill_value=)``, bitwise, with no wait on the host for the unique
   count.
3. **O(rows-touched) updates.**  :func:`update_unique` hands the unique
   rows and their summed gradients to ``Optimizer.step_rows``, which
   reads and writes only those rows of the table and its state.

Padding contract (the reference's): ids padded by ``io.DevicePrefetcher``
carry a sentinel id ``>= num_rows``.  The lookup returns zero rows for
them and the update drops them.  Out-of-range rows are masked, never
passed to an index op (PyTorch raises on them on the CPU and asserts on
the card, where JAX drops them).

``SPMDTrainer`` routes ``Embedding(sparse_grad=True)`` op calls through
:class:`SparseLookupContext` when ``embedding.sharded`` is on: the table
enters the forward undifferentiated, a zero ``delta`` of shape
``[capacity, dim]`` is added to the gathered unique rows, and the
delta's gradient is the deduplicated row gradient; no dense table
gradient is built.
"""
from __future__ import annotations

import math as _math
import time as _time
from collections import OrderedDict

import numpy as _np
import torch

from .. import numerics as _numerics
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from . import dist as _dist

__all__ = ["ShardedEmbedding", "dedup_ids", "lookup_unique", "update_unique",
           "unique_capacity", "sparse_embedding_params",
           "SparseLookupContext"]


def unique_capacity(n_ids):
    """Static unique-id capacity for a batch of ``n_ids`` indices:
    ``n_ids`` (a batch holds no more distinct ids than elements), capped
    by a positive ``embedding.unique_size``."""
    from .. import config as _cfg
    cap = int(_cfg.get("embedding.unique_size") or 0)
    n = int(n_ids)
    return n if cap <= 0 else min(cap, n)


def dedup_ids(ids, size, sentinel):
    """Deduplicate a batch of ids with static output shapes: ``(uniq,
    inv)``, ``uniq`` ``[size]`` int32 sorted ascending and filled with
    ``sentinel``, ``inv`` the row of ``uniq`` of every flattened input
    position.  With fewer than ``size`` slots, the largest ids are cut
    and their ``inv`` entries are ``>= size``, as ``jnp.unique``'s."""
    flat = ids.reshape(-1).to(torch.int32).to(torch.int64)
    n = flat.numel()
    size = int(size)
    srt, perm = torch.sort(flat, stable=True)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    run = torch.cumsum(first.to(torch.int64), 0) - 1
    buf = torch.full((max(n, size),), int(sentinel), dtype=torch.int64,
                     device=flat.device)
    # every element of a run writes the same value: no winner to pick
    buf.index_put_((run,), srt)
    inv = torch.empty_like(run)
    inv[perm] = run
    return buf[:size].to(torch.int32), inv


def _gather_rows(table, idx, valid, fill):
    """``table[idx]`` where ``valid``, else ``fill``; invalid entries read
    row 0 and are masked (never an out-of-range index)."""
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    vals = table.index_select(0, safe)
    return torch.where(valid[:, None], vals,
                       torch.full((), fill, dtype=table.dtype,
                                  device=table.device))


def _shard(mesh, axis, local_rows):
    """``(base, group, num_rows)`` of this rank's shard of a table split
    over ``axis`` (``local_rows`` rows each)."""
    n = int(mesh.shape[axis])
    return mesh.axis_index(axis) * local_rows, mesh.group((axis,)), \
        local_rows * n


def lookup_unique(table, uniq, mesh=None, axis=None):
    """``table[uniq]``, zero rows for ids outside the table.  Sharded
    (``mesh`` and ``axis``): ``table`` is this rank's shard; each rank
    answers the ids it owns and the answers are summed over ``axis``."""
    u = uniq.to(torch.int64)
    if mesh is None or axis is None:
        num_rows = int(table.shape[0])
        return _gather_rows(table, u, (u >= 0) & (u < num_rows), 0.0)
    base, group, num_rows = _shard(mesh, axis, int(table.shape[0]))
    local = u - base
    owned = (local >= 0) & (local < table.shape[0])
    # the others' -0.0 leave the owner's row as it is (x + -0.0 == x)
    vals = _gather_rows(table, local, owned, -0.0).contiguous()
    _dist.all_reduce_(vals, group=group)
    return torch.where(((u >= 0) & (u < num_rows))[:, None], vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))


def update_unique(optimizer, table, state, uniq, grad_rows, lr, wd, t,
                  mesh=None, axis=None, skip=None):
    """Row-sparse optimizer step on deduplicated ids, in place:
    ``optimizer.step_rows`` over the rows named in ``uniq``; sentinel and
    out-of-table ids (and, sharded, the ids other ranks own) map to an
    out-of-range row, which ``step_rows`` drops.  A set ``skip`` word (the
    nanguard's, a 0-d int32 tensor) maps every row out of the table, on
    the card.  Returns ``(table, state)``."""
    u = uniq.to(torch.int64)
    n = int(table.shape[0])
    if mesh is None or axis is None:
        rows = torch.where((u >= 0) & (u < n), u, torch.full_like(u, n))
    else:
        base, _, _ = _shard(mesh, axis, n)
        local = u - base
        rows = torch.where((local >= 0) & (local < n), local,
                           torch.full_like(local, n))
    if skip is not None:
        rows = torch.where(skip != 0, torch.full_like(rows, n), rows)
    return optimizer.step_rows(table, rows, grad_rows, state, lr, wd, t)


def sparse_embedding_params(fn, mesh, axis):
    """The trainable 2-D ``grad_stype='row_sparse'`` parameters
    (``Embedding(sparse_grad=True)``) and their routing: ``{name:
    {'rows', 'dim', 'axis'}}``, ``axis`` the mesh axis the vocab splits
    over, or None (a whole table on every rank) when the axis has one
    rank or does not divide the rows.  Empty when ``embedding.sharded``
    is off."""
    from .. import config as _cfg
    if not _cfg.get("embedding.sharded"):
        return OrderedDict()
    out = OrderedDict()
    axis_size = int(mesh.shape[axis]) if axis in mesh.axis_names else 1
    for n in fn.trainable:
        p = fn.params[n]
        if p.grad_stype != "row_sparse":
            continue
        shape = p.shape
        if not shape or len(shape) != 2 or not shape[0] or not shape[1]:
            continue  # deferred or not 2-D: the dense path
        rows, dim = int(shape[0]), int(shape[1])
        shard_axis = axis if (axis_size > 1 and rows % axis_size == 0) \
            else None
        out[n] = {"rows": rows, "dim": dim, "axis": shard_axis}
    return out


def _take_fill(rows, inv, cap, n_ids):
    """``rows[inv]``, a NaN row where ``inv >= cap`` (the ids the
    ``embedding.unique_size`` cap cut from a batch of ``n_ids`` ids, as
    the reference's ``jnp.take`` fills them)."""
    if n_ids <= cap:
        # a capacity of at least the id count never cuts an id
        return rows.index_select(0, inv)
    nan = torch.full((1, rows.shape[1]), float("nan"), dtype=rows.dtype,
                     device=rows.device)
    return torch.cat([rows, nan]).index_select(0, inv.clamp(max=cap))


class SparseLookupContext:
    """Routes ``Embedding(sparse_grad=True)`` op calls of one forward of
    ``SPMDTrainer``'s step through the deduplicated (and, over a
    multi-rank mesh, vocab-sharded) lookup.

    ``tables`` maps a routed parameter's name to the tensor its forward
    receives (the whole table, or this rank's shard), ``deltas`` to its
    zero ``[capacity, dim]`` gradient leaf.  The op's ids are this rank's
    rows of the global batch: the context gathers every rank's ids
    (``all_gather`` over the batch axes, in global batch order),
    deduplicates the global batch, gathers the unique rows, adds the
    delta and returns this rank's rows.  One lookup per table and
    forward."""

    def __init__(self, mesh, meta, tables, deltas, batch_axes=("dp",)):
        self._mesh = mesh
        self._meta = meta
        self._deltas = deltas
        self._tables = tables
        self._by_tensor = {id(t): n for n, t in tables.items()}
        self._by_shape = {tuple(t.shape): n for n, t in tables.items()}
        self._batch_axes = tuple(a for a in batch_axes
                                 if a in mesh.axis_names)
        self.records = {}

    def _global_ids(self, ids):
        """``(every rank's ids in global batch order, offset of this
        rank's)``."""
        mesh, axes = self._mesh, self._batch_axes
        nblk = _math.prod(mesh.shape[a] for a in axes)
        if nblk == 1:
            return ids, 0
        group = mesh.group(axes)
        parts = _dist.all_gather(ids, group=group)
        # group ranks are in global rank order; place each block by its
        # index along the batch axes
        members = [r for r in range(mesh.size)
                   if all(mesh.coords(r)[a] == mesh.coords()[a]
                          for a in mesh.axis_names if a not in axes)]
        order = sorted(range(len(members)),
                       key=lambda i: mesh.block_index(axes, members[i]))
        if order != list(range(len(order))):
            parts = parts[torch.tensor(order, device=parts.device)]
        return parts, mesh.block_index(axes) * ids.numel()

    def lookup(self, data, weight):
        """The routed lookup, or None for a weight this context does not
        route (the op then gathers densely)."""
        name = self._by_tensor.get(id(weight))
        if name is None:
            name = self._by_shape.get(tuple(weight.shape))
        if name is None:
            return None
        if name in self.records:
            raise NotImplementedError(
                "sparse-grad embedding %r is looked up more than once per "
                "forward (or shares its shape with another sparse table); "
                "the row-sparse path supports one lookup per table: set "
                "config embedding.sharded=False for this model" % name)
        meta = self._meta[name]
        ids = data.to(torch.int32)
        glob, off = self._global_ids(ids)
        cap = int(self._deltas[name].shape[0])
        uniq, inv = dedup_ids(glob, cap, meta["rows"])
        inv = inv[off:off + ids.numel()]
        table = self._tables[name]
        with torch.no_grad():
            rows = lookup_unique(table, uniq,
                                 self._mesh if meta["axis"] else None,
                                 meta["axis"])
        rows = rows + self._deltas[name].to(rows.dtype)
        # a capture step's collector takes the touched unique rows (the
        # gathered output only repeats them)
        rows = _numerics.tap("embedding.%s.rows" % name, rows)
        self.records[name] = uniq
        return _take_fill(rows, inv, cap, glob.numel()).reshape(
            tuple(ids.shape) + (meta["dim"],))


class ShardedEmbedding:
    """A vocab-sharded embedding table with deduplicated lookups and lazy
    row-sparse updates: the standalone counterpart of the trainer's
    routing, over the same :func:`dedup_ids`, :func:`lookup_unique` and
    :func:`update_unique`, in ``embedding.lookup`` / ``embedding.update``
    spans, with its own ``embedding`` numerics capture source.

    Over a multi-rank mesh every rank passes the same ids (the global
    batch) and gets every row.  Each call feeds the ``embedding.*``
    telemetry: the ``unique_ratio`` gauge, the ``gathered_rows`` /
    ``rows_touched`` counters and the ``lookup_ms`` timer (the lookup
    waits for the device, so the timer measures its work).  The table is
    drawn from ``seed`` with a ``torch.Generator`` on the CPU (the
    reference draws from a JAX key: the two tables differ)."""

    def __init__(self, num_rows, dim, mesh=None, axis=None,
                 dtype=torch.float32, optimizer=None, init_scale=0.01,
                 seed=0):
        from .mesh import data_parallel_mesh
        from .. import optimizer as opt_mod
        self.num_rows = int(num_rows)
        self.dim = int(dim)
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        if axis is None:
            axis = next((a for a in self.mesh.axis_names
                         if int(self.mesh.shape[a]) > 1
                         and self.num_rows % int(self.mesh.shape[a]) == 0),
                        None)
        elif self.num_rows % int(self.mesh.shape[axis]) != 0:
            raise ValueError(
                "num_rows=%d does not divide mesh axis %r (size %d)"
                % (self.num_rows, axis, int(self.mesh.shape[axis])))
        self.axis = axis
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer)
        self.optimizer = optimizer if optimizer is not None \
            else opt_mod.create("sgd")
        if not getattr(self.optimizer, "lazy_update", False) \
                or not hasattr(self.optimizer, "step_rows"):
            raise ValueError(
                "ShardedEmbedding needs an optimizer with a lazy "
                "step_rows path (sgd, adam); got %r"
                % type(self.optimizer).__name__)
        gen = torch.Generator().manual_seed(int(seed))
        full = (torch.randn(self.num_rows, self.dim, generator=gen)
                * init_scale).to(dtype)
        dev = self.mesh.device
        if axis is not None:
            per = self.num_rows // int(self.mesh.shape[axis])
            k = self.mesh.axis_index(axis)
            full = full[k * per:(k + 1) * per]
        self.table = full.to(dev).contiguous()
        self.state = self.optimizer.create_state(0, self.table)
        self._t = 0
        # mx.perf programs of the lookup and the update, made at first use
        self._lookup_prog = None
        self._update_prog = None

    def set_table(self, full):
        """Replace the table with ``full`` (``[num_rows, dim]``; this
        rank keeps its shard)."""
        full = full if isinstance(full, torch.Tensor) \
            else torch.from_numpy(_np.array(full))
        if self.axis is not None:
            per = self.num_rows // int(self.mesh.shape[self.axis])
            k = self.mesh.axis_index(self.axis)
            full = full[k * per:(k + 1) * per]
        self.table = full.to(self.mesh.device, self.table.dtype).clone()
        self.state = self.optimizer.create_state(0, self.table)

    def _mesh_args(self):
        return (self.mesh, self.axis) if self.axis else (None, None)

    def _lookup_rows(self, ids, cap):
        """The lookup's program (counted by mx.perf under the
        ``embedding`` family): ``(unique ids, their rows, the rows of
        every id)``."""
        uniq, inv = dedup_ids(ids, cap, self.num_rows)
        rows = lookup_unique(self.table, uniq, *self._mesh_args())
        out = _take_fill(rows, inv, cap, ids.numel()).reshape(
            tuple(ids.shape) + (self.dim,))
        return uniq, rows, out

    def _update_rows(self, ids, grad, cap, lr, wd):
        """The update's program (counted by mx.perf under the
        ``embedding`` family)."""
        uniq, inv = dedup_ids(ids, cap, self.num_rows)
        gsum = torch.zeros((cap + 1, self.dim), dtype=grad.dtype,
                           device=grad.device)
        # ids the cap cut land in the extra row, which is dropped
        gsum.index_add_(0, inv.clamp(max=cap), grad.reshape(-1, self.dim))
        update_unique(self.optimizer, self.table, self.state, uniq,
                      gsum[:cap].to(self.table.dtype), lr, wd, self._t,
                      *self._mesh_args())

    def lookup(self, ids):
        """Rows for an integer id batch: ``[*ids.shape, dim]``; ids
        ``>= num_rows`` (the pad sentinel) give zero rows.  Runs in an
        ``embedding.lookup`` span; a capture step of the ``embedding``
        source (``numerics.capture``) summarizes the touched unique rows
        as ``embedding.rows``."""
        ids = torch.as_tensor(ids).to(self.mesh.device)
        n = max(int(ids.numel()), 1)
        cap = unique_capacity(n)
        cap_stats = _numerics.should_capture("embedding")
        with _tracing.span("embedding.lookup", cat="embedding"):
            t0 = _time.perf_counter()
            if self._lookup_prog is None:
                from .. import perf as _perf
                self._lookup_prog = _perf.wrap(
                    self._lookup_rows, "embedding", "lookup/%x" % id(self))
            uniq, rows, out = self._lookup_prog(ids, cap)
            n_unique = int((uniq < self.num_rows).sum())
            _telemetry.timer("embedding.lookup_ms").observe(
                (_time.perf_counter() - t0) * 1000.0)
        if cap_stats:
            stats = {}
            _numerics.record(stats, "embedding.rows", rows)
            _numerics.publish("embedding", self._t, stats)
        _telemetry.counter("embedding.gathered_rows").inc(cap)
        _telemetry.gauge("embedding.unique_ratio").set(float(n_unique) / n)
        return out

    @torch.no_grad()
    def update(self, ids, grad, lr, wd=0.0):
        """One lazy row-sparse optimizer step: ``grad`` holds a cotangent
        row an id (``[*ids.shape, dim]``); duplicate ids are summed,
        sentinel ids dropped, and only the touched rows of the table and
        its state are rewritten."""
        ids = torch.as_tensor(ids).to(self.mesh.device)
        grad = torch.as_tensor(grad).to(self.mesh.device)
        self._t += 1
        cap = unique_capacity(max(int(ids.numel()), 1))
        with _tracing.span("embedding.update", cat="embedding"):
            if self._update_prog is None:
                from .. import perf as _perf
                self._update_prog = _perf.wrap(
                    self._update_rows, "embedding", "update/%x" % id(self))
            self._update_prog(ids, grad, cap, lr, wd)
        _telemetry.counter("embedding.rows_touched").inc(cap)
        return self.table
