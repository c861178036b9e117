"""SPMD training step (counterpart of ``mxnet_tpu.parallel.trainer``),
over one rank or a multi-rank mesh.

The reference compiles the whole iteration — forward, backward, gradient
all-reduce, update — into one jitted program over a mesh.  Here the step
is the same sequence in eager PyTorch, one process a device: the f32
master weights (cast to bf16 inside autograd under ``dtype="bfloat16"``)
run the functionalized forward and the loss, ``torch.autograd.grad``
gives the f32 gradients of the masters, and the optimizer updates masters
and state in place (the analog of the reference's donation).  With the
kernel tier on and an optimizer with a fused step, the update of every
dense trainable tensor is one ``optimizer.step_fused_multi`` call: one
launch of K1 (``csrc/sgd_step.cu``, SGD) or K3 (``csrc/adam_step.cu``,
Adam) over the whole list.  With the tier off it is ``optimizer.step``
per tensor.

Over a mesh of N ranks every rank passes the same GLOBAL batch, as every
process of the reference does; a rank keeps its rows (the first axis
split over the batch axes: ``batch_axis``, and ``dcn`` when the mesh has
it), takes the gradients of its rows' share of the global mean loss, and
the gradients are summed over the ranks in one ``all_reduce`` before the
update, so every rank applies the same update.  The parameters are
broadcast from rank 0 when the trainer first materializes them.  Three
routes:

- dense (above);
- row-sparse embeddings: ``Embedding(sparse_grad=True)`` tables under
  ``embedding.sharded`` (default on) take the route of
  ``parallel/embedding.py``.  The forward gathers every rank's ids,
  deduplicates the global batch into a ``[capacity, dim]`` block of
  unique rows (from this rank's vocab shard when the batch axis divides
  the rows, summed over the axis), the delta gradients are summed over
  the ranks, and ``Optimizer.step_rows`` updates only those rows;
- 2-bit compressed DCN sync (``kvstore.grad_compress=2bit`` on a mesh
  with a ``dcn`` axis, no pad, no routed table): each rank's gradient of
  its rows' mean loss, summed over the ICI batch axis, divided by the
  rank count, is coded against its error-feedback residual, and the
  packed codes (four a byte) are gathered over ``dcn`` and summed.

Pad-masked steps (``pad > 0``): the last ``pad`` rows of the global
batch are fill; the loss and gradients average over the others only.

Refused (``NotImplementedError``, never ignored): sharded ``param_specs``,
meshes whose other axes than the batch axes have more than one rank,
BatchNorm statistics over a multi-rank uncompressed step,
``conv.weights_layout=HWIO``, the nanguard (``resilience.nanguard``),
in-step numerics capture (``numerics.capture``), the checkpoint manager
and the sharded checkpoints.

``save_checkpoint`` / ``load_checkpoint`` keep the reference's
single-file checkpoint: a pickle of numpy arrays under the same keys
(``schema``, ``format``, ``step_num``, ``params`` in OIHW, ``opt_state``,
``rng_key``, and ``dcn_residuals`` after compressed steps), published
atomically, so each package reads the other's.  A vocab-sharded table is
gathered whole; rank 0 writes.  A reference checkpoint's ``rng_key`` (a
JAX key) is not read: the two packages' random streams never agree.
"""
from __future__ import annotations

import math
import pickle

import numpy as _np
import torch

from .. import config as _config
from .. import kernels as _kernels
from .. import telemetry as _telemetry
from ..io import ensure_staged
from ..ndarray.ndarray import NDArray, _wrap
from . import dist as _dist
from . import embedding as _pemb
from .functional import functionalize
from .mesh import data_parallel_mesh, _local_rows

__all__ = ["SPMDTrainer", "build_train_step"]

# knobs of reference features the port does not have yet: set, they
# would change what a step computes, so the trainer refuses to run
_UNPORTED_KNOBS = {
    "resilience.nanguard": "the nanguard (non-finite step guard)",
    "numerics.capture": "in-step numerics capture",
}


def _f32(x):
    """A Python float rounded to f32, as a Python float."""
    return float(_np.float32(x))


def _div(x, d):
    """``x / d`` for a Python number ``d`` as one IEEE division on every
    device (the card divides by a Python scalar through its reciprocal);
    the divisor is made by a fill, not copied from the host."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


class SPMDTrainer:
    """Fused-step trainer for a Gluon block on a mesh.

    Usage::

        trainer = SPMDTrainer(net, loss_fn, 'sgd',
                              {'learning_rate': 0.1, 'momentum': 0.9},
                              mesh=make_mesh({'dp': -1}))
        for data, label in loader:      # the global batch, on every rank
            loss = trainer.step(data, label)
        trainer.sync()           # write weights back into the Block

    ``dtype="bfloat16"`` runs forward and backward in bf16 over f32
    masters and f32 optimizer state; the BatchNorm statistics stay f32.
    ``donate`` is accepted for parity: the trainer always updates its own
    copies in place."""

    def __init__(self, block, loss_fn, optimizer, optimizer_params=None,
                 mesh=None, batch_axis="dp", param_specs=None,
                 donate=True, dtype=None):
        from .. import optimizer as opt_mod
        if param_specs:
            raise NotImplementedError(
                "param_specs (sharded parameters) are not ported yet")
        self._check_knobs()
        self.fn = functionalize(block)
        self.block = block
        self.loss_fn = loss_fn
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self.optimizer = optimizer
        self.compute_dtype = torch.bfloat16 if str(dtype) in (
            "bfloat16", "bf16", "torch.bfloat16") else None
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        names = self.mesh.axis_names
        self.batch_axis = batch_axis if batch_axis in names else names[0]
        self._batch_axes = (self.batch_axis, "dcn") \
            if "dcn" in names and self.batch_axis != "dcn" \
            else (self.batch_axis,)
        extra = [a for a in names if a not in self._batch_axes
                 and self.mesh.shape[a] > 1]
        if extra:
            raise NotImplementedError(
                "SPMDTrainer splits the batch over %s; mesh axes %s of more "
                "than one rank (tensor, sequence, pipeline or expert "
                "parallelism) are not ported yet" % (self._batch_axes,
                                                     extra))
        self._n_shards = math.prod(self.mesh.shape[a]
                                   for a in self._batch_axes)
        self.device = self.mesh.device
        self._sparse_embed = _pemb.sparse_embedding_params(
            self.fn, self.mesh, self.batch_axis)
        self._dcn_residuals = None
        self.params = None
        self.opt_state = None
        self._step_num = 0
        self._program = None
        self._program_key = None

    @property
    def batch_sharding(self):
        """The device the step stages this rank's rows on: the
        ``placement`` to hand ``io.DevicePrefetcher``, so ``step`` never
        copies a batch itself."""
        return self.device

    def _routed(self):
        return [n for n in self.fn.trainable if n in self._sparse_embed]

    # ---------------------------------------------------------- materialize
    def _materialize(self, data):
        """Copy the Block's parameters onto this rank's device as the
        trainer's own tensors (masters that require grad, aux state; this
        rank's rows of a vocab-sharded table), rank 0's values on every
        rank, and create the optimizer state.  Deferred shapes are
        resolved by one forward on the first batch."""
        from ..gluon.parameter import DeferredInitializationError
        try:
            vals = self.fn.init_values()
        except DeferredInitializationError:
            self.block(_wrap(data))
            self.fn = functionalize(self.block)
            self._sparse_embed = _pemb.sparse_embedding_params(
                self.fn, self.mesh, self.batch_axis)
            vals = self.fn.init_values()
        self.params = {}
        for n, v in vals.items():
            t = v.detach().to(self.device, copy=True)
            _dist.broadcast_(t, src=0)
            meta = self._sparse_embed.get(n)
            if meta is not None and meta["axis"] is not None:
                t = _local_rows(self.mesh, t, (meta["axis"],)).clone()
            self.params[n] = t
        routed = set(self._routed())
        for n in self.fn.trainable:
            if n not in routed:
                self.params[n].requires_grad_(True)
        self.opt_state = {
            n: self.optimizer.create_state(i, self.params[n].detach())
            for i, n in enumerate(self.fn.trainable)}

    # --------------------------------------------------------------- loss
    def _loss_terms(self, raw, pad, local_mean):
        """``(loss to differentiate, loss to report)`` of this rank's raw
        losses: the mean over the unpadded rows of the global batch (this
        rank's share of it over several ranks), or, for the compressed
        step, the mean over this rank's rows."""
        if pad and raw.dim() == 0:
            raise ValueError(
                "pad-masked step needs per-sample losses: loss_fn reduced "
                "over the batch already — return unreduced losses or drop "
                "pad=")
        rows = int(raw.shape[0]) if raw.dim() else 1
        total = rows * self._n_shards
        valid = total - pad
        if valid <= 0:
            raise ValueError("pad=%d leaves no valid rows in a %d-row batch"
                             % (pad, total))
        if self._n_shards == 1 or local_mean:
            loss = torch.mean(raw[:valid] if pad else raw)
            return loss, loss.detach()
        start = self.mesh.block_index(self._batch_axes) * rows
        mine = raw[:max(0, min(rows, valid - start))] if pad else raw
        per_row = raw[0].numel() if raw.dim() else 1
        count = valid * per_row if raw.dim() else self._n_shards
        local = torch.sum(mine)
        report = local.detach().clone()
        _dist.all_reduce_(report)
        return _div(local, count), _div(report, count)

    def _forward_backward(self, train, aux, tables, deltas, data, label,
                          pad, local_mean):
        """The step's forward and backward at the given masters:
        ``(loss, new_aux, grads, delta_grads, unique ids)``, grads in the
        order of the dense trainables, f32 for f32 masters, contiguous
        (under ``conv.internal_layout=NHWC`` a conv weight's gradient
        comes back channels_last), not yet reduced over ranks; the unique
        ids of each routed table that was looked up."""
        from ..ops import tensor as _tensor_ops
        fn, cdt = self.fn, self.compute_dtype

        def cast(v):
            return v.to(cdt) if cdt is not None and v.dtype == torch.float32 \
                else v
        with torch.enable_grad():
            param_map = dict(aux)  # aux (BN stats) stay f32
            param_map.update({n: cast(v) for n, v in train.items()})
            routed = {n: cast(v) for n, v in tables.items()}
            param_map.update(routed)
            if cdt is not None and data.dtype == torch.float32:
                data = data.to(cdt)  # int inputs (ids) keep their dtype
            ctx = _pemb.SparseLookupContext(
                self.mesh, self._sparse_embed, routed, deltas,
                self._batch_axes) if tables else None
            prev = _tensor_ops.set_embed_context(ctx)
            try:
                (out,), new_aux = fn.apply(param_map, (data,),
                                           training=True)
            finally:
                _tensor_ops.set_embed_context(prev)
            if cdt is not None:
                out = out.float()
            loss, report = self._loss_terms(
                _raw_loss(self.loss_fn, out, label), pad, local_mean)
            masters = list(train.values())
            leaves = masters + list(deltas.values())
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g.contiguous()
                 for w, g in zip(leaves, grads)]
        records = ctx.records if ctx is not None else {}
        return report, new_aux, grads[:len(masters)], \
            dict(zip(deltas, grads[len(masters):])), records

    def _loss_and_grads(self, train, aux, data, label):
        """A one-rank step's forward and backward at the masters ``train``
        (every trainable, dense): ``(loss, new_aux, grads)``, grads in
        ``train``'s order and preprocessed (``rescale_grad``, clipping);
        nothing is reduced over ranks or updated."""
        loss, new_aux, grads, _, _ = self._forward_backward(
            train, aux, {}, {}, data, label, 0, False)
        with torch.no_grad():
            grads = [_preprocess(self.optimizer, g) for g in grads]
        return loss, new_aux, grads

    # ------------------------------------------------- compressed DCN sync
    def _dcn_compress_active(self, pad=0):
        """Whether this step quantizes the DCN gradient hop: the 2-bit
        knob is on, the mesh has a ``dcn`` axis, the step is not
        pad-masked and no table takes the row-sparse route."""
        return (_config.get("kvstore.grad_compress") == "2bit"
                and "dcn" in self.mesh.axis_names and not pad
                and not self._routed())

    def _dcn_sync(self, names, grads):
        """The compressed hop: each gradient, summed over the ICI batch
        axis and divided by the rank count, coded against its residual;
        the packed codes of every tensor gathered over ``dcn`` in one
        collective and summed.  Commits the new residuals; returns the
        decompressed gradients."""
        from .compression import (note_wire, pack_2bit, two_bit_compress,
                                  unpack_2bit)
        mesh = self.mesh
        thr = float(_config.get("kvstore.grad_compression_threshold"))
        ici = tuple(a for a in self._batch_axes if a != "dcn")
        if ici and math.prod(mesh.shape[a] for a in ici) > 1:
            flat = torch.cat([g.reshape(-1) for g in grads])
            _dist.all_reduce_(flat, group=mesh.group(ici))
            grads = _split(flat, grads)
        if self._dcn_residuals is None:
            self._dcn_residuals = {n: torch.zeros_like(g)
                                   for n, g in zip(names, grads)}
        codes, new_res, packed = [], {}, []
        for n, g in zip(names, grads):
            v = _div(g, mesh.size)
            c, r = two_bit_compress(v, self._dcn_residuals[n], thr)
            codes.append(c)
            new_res[n] = r
            packed.append(pack_2bit(c))
        wire = torch.cat(packed)
        rows = _dist.all_gather(wire, group=mesh.group(("dcn",)))
        out, off = [], 0
        for g, p in zip(grads, packed):
            n_el, n_b = g.numel(), p.numel()
            tot = torch.zeros(n_el, dtype=torch.int32, device=g.device)
            for w in range(rows.shape[0]):
                tot = tot + unpack_2bit(rows[w, off:off + n_b], n_el)
            out.append((tot.to(g.dtype) * thr).reshape(g.shape))
            off += n_b
        self._dcn_residuals = new_res
        self._dcn_codes = codes
        note_wire(wire.numel(), sum(g.numel() * 4 for g in grads))
        return out

    # ------------------------------------------------------------ the step
    def _build(self):
        """The step as a closure over this trainer's configuration, the
        analog of the reference's traced program: built once, rebuilt when
        the kernel tier or any knob changes (``config.epoch``)."""
        optimizer = self.optimizer
        fused_opt = _kernels.fused_step_enabled(optimizer)
        if fused_opt:
            # counted once per built step, as the reference counts once per
            # traced program
            _kernels.note_fused_step()
        routed = self._routed()
        dense = [n for n in self.fn.trainable if n not in routed]
        index = {n: i for i, n in enumerate(self.fn.trainable)}
        if routed and not (getattr(optimizer, "lazy_update", False)
                           and hasattr(optimizer, "step_rows")):
            raise ValueError(
                "sparse-grad embedding params %s need an optimizer with a "
                "lazy step_rows path (sgd, adam); %r has none — set config "
                "embedding.sharded=False to train them densely"
                % (routed, type(optimizer).__name__))
        multi = self._n_shards > 1

        @torch.no_grad()
        def step(data, label, t, lrs, wds, pad, compress):
            params, state = self.params, self.opt_state
            train = {n: params[n] for n in dense}
            aux = {n: params[n] for n in self.fn.aux}
            tables = {n: params[n] for n in routed}
            deltas = {}
            if routed:
                cap = _pemb.unique_capacity(data.numel() * self._n_shards)
                ddt = self.compute_dtype
                deltas = {n: torch.zeros(
                    (cap, self._sparse_embed[n]["dim"]),
                    dtype=ddt or tables[n].dtype, device=self.device,
                    requires_grad=True) for n in routed}
            loss, new_aux, grads, dgrads, recs = self._forward_backward(
                train, aux, tables, deltas, data, label, pad, compress)
            if compress:
                grads = self._dcn_sync(dense, grads)
                new_aux = {n: _div(_dist.all_reduce_(v.clone()), self.mesh
                                   .size) if v.is_floating_point() else v
                           for n, v in new_aux.items()}
                loss = _div(_dist.all_reduce_(loss.clone()), self.mesh.size)
            elif multi:
                both = grads + [dgrads[n] for n in routed]
                flat = torch.cat([g.reshape(-1) for g in both])
                _dist.all_reduce_(flat)
                both = _split(flat, both)
                grads = both[:len(grads)]
                dgrads = dict(zip(routed, both[len(grads):]))
            grads = [_preprocess(optimizer, g) for g in grads]
            masters = [params[n] for n in dense]
            states = [state[n] for n in dense]
            lr_d = [lrs[index[n]] for n in dense]
            wd_d = [wds[index[n]] for n in dense]
            if masters and fused_opt and all(
                    w.dtype == torch.float32 for w in masters):
                optimizer.step_fused_multi(masters, grads, states, lr_d,
                                           wd_d, t)
            else:
                for w, g, s, lr, wd in zip(masters, grads, states, lr_d,
                                           wd_d):
                    nw, ns = optimizer.step(w, g, s, lr, wd, t)
                    w.copy_(nw.to(w.dtype))
                    _state_copy(s, ns)
            for n in routed:
                uniq = recs.get(n)
                if uniq is None:
                    continue  # not looked up this forward: no row to touch
                meta = self._sparse_embed[n]
                gv = _preprocess(optimizer, dgrads[n].to(tables[n].dtype))
                _pemb.update_unique(
                    optimizer, tables[n], state[n], uniq, gv,
                    lrs[index[n]], wds[index[n]], t,
                    self.mesh if meta["axis"] else None, meta["axis"])
            for n, v in new_aux.items():
                aux[n].copy_(v)
            if routed:
                # static accounting (no device sync): each routed table
                # gathers and touches ``capacity`` unique rows a step
                rows = cap * len(routed)
                _telemetry.counter("embedding.gathered_rows").inc(rows)
                _telemetry.counter("embedding.rows_touched").inc(rows)
            return loss

        return step

    def _hyper(self, lr_scale=1.0):
        """Per-tensor lr and wd for the current ``num_update`` as f32
        values, lr * lr_scale rounded once in f32, as the reference's
        traced ``lrs[i] * lr_scale``."""
        n = len(self.fn.trainable)
        scale = _np.float32(lr_scale)
        lrs = [float(_np.float32(self.optimizer._get_lr(i)) * scale)
               for i in range(n)]
        wds = [_f32(self.optimizer._get_wd(i)) for i in range(n)]
        return lrs, wds

    @staticmethod
    def _check_knobs():
        for knob, what in _UNPORTED_KNOBS.items():
            if _config.get(knob):
                raise NotImplementedError(
                    "%s is not ported (%s=%r)" % (what, knob,
                                                  _config.get(knob)))
        if _config.get("conv.weights_layout") == "HWIO":
            raise NotImplementedError(
                "conv.weights_layout=HWIO is not ported; use 'ref' (OIHW)")

    def _stage(self, x):
        """This rank's rows of a global-batch array, on its device."""
        if isinstance(x, NDArray):
            x = x._data
        if self._n_shards > 1:
            x = _local_rows(self.mesh, x, self._batch_axes)
        return ensure_staged(x, self.device, "step")

    def step(self, data, label, lr_scale=1.0, pad=0):
        """Run one train step on the global batch ``data`` / ``label``
        (every rank passes the same); returns the global mean loss (a 0-d
        f32 tensor on the device, not synchronised).  ``pad`` counts the
        trailing fill rows of the global batch (``DataBatch.pad``): the
        loss and gradients average over the others (the loss function
        must return per-sample losses)."""
        pad = int(pad or 0)
        self._check_knobs()
        data, label = self._stage(data), self._stage(label)
        if self.params is None:
            self._materialize(data)
        compress = self._dcn_compress_active(pad)
        if compress:
            self._dcn_check()
        elif self._dcn_residuals is not None \
                and not self._dcn_compress_active(0):
            # knob turned off: stale error feedback must not leak into a
            # later re-enable
            self._dcn_residuals = None
        if self._n_shards > 1 and self.fn.aux and not compress:
            raise NotImplementedError(
                "batch statistics over a multi-rank step (SyncBatchNorm: "
                "%s) are not ported yet" % self.fn.aux[:4])
        key = (_kernels.enabled(), _config.epoch())
        if self._program is None or key != self._program_key:
            self._program, self._program_key = self._build(), key
        self._step_num += 1
        self.optimizer.num_update = self._step_num
        lrs, wds = self._hyper(lr_scale)
        return self._program(data, label, self._step_num, lrs, wds, pad,
                             compress)

    def _dcn_check(self):
        extra = [a for a in self.mesh.axis_names
                 if a not in ("dcn", self.batch_axis)]
        if extra:
            raise NotImplementedError(
                "kvstore.grad_compress=2bit supports data-parallel meshes "
                "('dcn' + the batch axis); this mesh also has axes %s"
                % (extra,))

    # ------------------------------------------------------ whole values
    def _full(self, n):
        """Parameter ``n`` whole on this rank (a vocab-sharded table
        gathered over its axis)."""
        v = self.params[n].detach()
        meta = self._sparse_embed.get(n)
        if meta is None or meta["axis"] is None:
            return v
        parts = _dist.all_gather(v, group=self.mesh.group((meta["axis"],)))
        return parts.reshape((-1,) + tuple(v.shape[1:]))

    def _full_state(self, n):
        meta = self._sparse_embed.get(n)
        if meta is None or meta["axis"] is None:
            return self.opt_state[n]
        group = self.mesh.group((meta["axis"],))
        return _tree(self.opt_state[n], lambda s: _dist.all_gather(
            s, group=group).reshape((-1,) + tuple(s.shape[1:])))

    def sync(self):
        """Write the trainer's weights and aux state back into the
        Block's Parameters (a vocab-sharded table gathered whole)."""
        self.fn.write_back({n: self._full(n) for n in self.params})

    # --------------------------------------------------------- checkpoints
    def save_checkpoint(self, path):
        """Write the weights (f32 masters and aux state), the optimizer
        state, the step count and the compressed step's residuals to
        ``path``, atomically: a pickle of numpy arrays in the reference's
        format (``parallel/trainer.py:1131``), which ``load_checkpoint``
        of either package reads.  Over several ranks every rank takes
        part in gathering the sharded tables and rank 0 writes."""
        from ..random import _STATE
        from ..resilience import CKPT_SCHEMA, atomic_write
        if self.params is None:
            raise RuntimeError("save_checkpoint: the trainer has taken no "
                               "step, so it holds no weights yet")
        host = {
            "schema": CKPT_SCHEMA,
            "format": _FORMAT,
            "step_num": self._step_num,
            "params": {n: _host(self._full(n)) for n in self.params},
            "opt_state": {n: _tree(self._full_state(n), _host)
                          for n in self.opt_state},
            # this package's stream position (seed, draws): the shape of a
            # reference key, which the reference restores and nothing draws
            "rng_key": _np.array([_STATE.seed_val & 0xFFFFFFFF,
                                  _STATE.counter & 0xFFFFFFFF], _np.uint32),
        }
        if self._dcn_residuals is not None:
            group = self.mesh.group(("dcn",))
            host["dcn_residuals"] = {
                n: _host(_dist.all_gather(r, group=group))
                for n, r in self._dcn_residuals.items()}
        if self.mesh.rank == 0:
            with atomic_write(path, "wb") as f:
                pickle.dump(host, f, protocol=4)
        _dist.barrier("checkpoint")

    def load_checkpoint(self, path):
        """Restore a checkpoint of either package; the next step continues
        bitwise where the saved run left off.  Names pair up after each
        net's own top prefix (``convert.pair_names``).  A truncated or
        unreadable file, a file that is not an SPMDTrainer checkpoint, one
        of a newer schema or one of another network raises
        ``resilience.CheckpointCorruptError``."""
        from ..convert import _own_prefix, pair_names
        from ..optimizer.optimizer import _ReferenceUnpickler
        from ..random import _STATE
        from ..resilience import CKPT_SCHEMA, CheckpointCorruptError
        try:
            with open(path, "rb") as f:
                host = _ReferenceUnpickler(f).load()
        except (OSError, EOFError, pickle.UnpicklingError, AttributeError,
                ImportError, IndexError, ValueError, TypeError) as exc:
            raise CheckpointCorruptError(
                "checkpoint %s is unreadable (%s: %s)"
                % (path, type(exc).__name__, exc)) from exc
        if not isinstance(host, dict) or not (
                {"step_num", "params", "opt_state"} <= set(host)):
            raise CheckpointCorruptError(
                "checkpoint %s is not an SPMDTrainer checkpoint (missing "
                "step_num/params/opt_state)" % path)
        if int(host.get("schema", 1)) > CKPT_SCHEMA:
            raise CheckpointCorruptError(
                "checkpoint %s was written by a newer schema (%s > %s)"
                % (path, host.get("schema"), CKPT_SCHEMA))
        names = list(self.fn.params)
        try:
            pairs = pair_names(names, list(host["params"]),
                               _own_prefix(self.block, names))
            missing = [n for n in self.fn.trainable
                       if pairs[n] not in host["opt_state"]]
        except ValueError as exc:
            raise CheckpointCorruptError(
                "checkpoint %s is another network's: %s" % (path, exc)) \
                from exc
        if missing:
            raise CheckpointCorruptError(
                "checkpoint %s has no optimizer state for %s"
                % (path, missing[:4]))
        dev = self.device

        def place(n):
            meta = self._sparse_embed.get(n)
            axis = meta["axis"] if meta is not None else None

            def leaf(a):
                t = torch.as_tensor(a)
                if axis is not None:
                    t = _local_rows(self.mesh, t, (axis,))
                return t.to(dev, copy=True)
            return leaf
        self.params = {n: place(n)(host["params"][pairs[n]]) for n in names}
        routed = set(self._routed())
        for n in self.fn.trainable:
            if n not in routed:
                self.params[n].requires_grad_(True)
        self.opt_state = {n: _tree(host["opt_state"][pairs[n]], place(n))
                          for n in self.fn.trainable}
        self._step_num = int(host["step_num"])
        self.optimizer.num_update = self._step_num
        self._program = None
        self._dcn_residuals = None
        dres = host.get("dcn_residuals")
        if dres and "dcn" in self.mesh.axis_names:
            k, n_dcn = self.mesh.axis_index("dcn"), self.mesh.shape["dcn"]
            if all(_np.asarray(v).shape[0] == n_dcn for v in dres.values()):
                self._dcn_residuals = {
                    n: torch.as_tensor(dres[pairs[n]][k]).to(dev, copy=True)
                    for n in self.fn.trainable if pairs[n] in dres}
            # a world with another dcn extent restarts the error feedback
        if host.get("format") == _FORMAT and "rng_key" in host:
            _STATE.seed_val, _STATE.counter = (int(v)
                                               for v in host["rng_key"])
        return self._step_num

    # ------------------------------------------------- not ported (refuse)
    def attach_checkpoint_manager(self, manager, auto_resume=True):
        raise NotImplementedError("the checkpoint manager is not ported")

    def save_checkpoint_sharded(self, path):
        raise NotImplementedError("sharded checkpoints are not ported")

    load_checkpoint_sharded = save_checkpoint_sharded


# the ``format`` of this package's checkpoints (the reference writes
# "mxnet_tpu-spmd-ckpt"; either loads)
_FORMAT = "mxnet_tpu_torch-spmd-ckpt"


def _split(flat, like):
    """``flat`` cut into tensors shaped as ``like``."""
    out, off = [], 0
    for g in like:
        out.append(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return out


def _host(t):
    """A tensor as a numpy copy on the host (bf16 widened to f32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _tree(state, leaf):
    """``leaf`` over a state tree (None, an array, or tuples of them)."""
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return tuple(_tree(s, leaf) for s in state)
    return leaf(state)


def _state_copy(state, new):
    if state is None:
        return
    if isinstance(state, torch.Tensor):
        state.copy_(new)
        return
    for s, n in zip(state, new):
        _state_copy(s, n)


def _preprocess(optimizer, grad):
    if optimizer.rescale_grad == 1.0 and optimizer.clip_gradient is None:
        return grad  # ``grad * 1.0`` is exact: skip the pass
    g = grad * optimizer.rescale_grad
    if optimizer.clip_gradient is not None:
        g = torch.clamp(g, -optimizer.clip_gradient, optimizer.clip_gradient)
    return g


def _raw_loss(loss_fn, out, label):
    """The loss function on NDArrays (Gluon losses), or on tensors when it
    is a plain callable; as f32."""
    try:
        loss = loss_fn(_wrap(out), _wrap(label))
    except (TypeError, AttributeError):
        loss = loss_fn(out, label)
    loss = loss._data if isinstance(loss, NDArray) else loss
    return loss.float()


def build_train_step(block, loss_fn, optimizer, optimizer_params=None,
                     mesh=None, **kw):
    """An SPMDTrainer and its step: ``(trainer, trainer.step)``."""
    tr = SPMDTrainer(block, loss_fn, optimizer, optimizer_params, mesh=mesh,
                     **kw)
    return tr, tr.step
