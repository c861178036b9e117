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
the gradients are summed over the batch axes in one ``all_reduce``
before the update, so every rank applies the same update.  Ranks along
the other axes see the same rows, as the reference's batch sharding
gives.  The parameters are broadcast from rank 0 when the trainer first
materializes them.

``param_specs`` (``{name: PartitionSpec}``, the reference's) split
parameters over mesh axes: each rank stores its block of the parameter
and of its optimizer state, the forward gathers the whole tensor over
the spec's axes (``collectives.unshard``), and its backward takes this
rank's block of the gradient, which the batch axes' ``all_reduce`` then
sums.  The update (K1 or K3 over the list) runs on the blocks; a
checkpoint gathers them whole.  Three routes:

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

BatchNorm over several ranks: in the forward of a multi-rank step
(dense, row-sparse or ``param_specs``) every BatchNorm's training
statistics are the global batch's (``ops.nn.set_batch_stats_context``
with the batch axes: the per-rank sums summed in one collective whose
backward sums the cotangents, the reference's cross-replica sums), so
the moving statistics the step returns are the same on every rank.  A
pad-masked step's fill rows count in the statistics, as they do in the
reference's BatchNorm, though the loss masks them.  The compressed DCN
step keeps the reference's shard-local statistics (its body runs under
``shard_map``): each rank's BatchNorm sees its own rows, and the moving
statistics are averaged over every axis of the mesh after the step.

Resilience (``mx.resilience``), wired where the reference wires it:

- the nanguard (``resilience.nanguard=skip|abort``): after the gradient
  all-reduce the loss and the gradients (and the row-sparse tables'
  delta gradients) are reduced to one int32 skip word on the card
  (``resilience.skip_word``; summed over the mesh when ``param_specs``
  or other axes leave each rank its own gradient blocks, so every rank
  skips alike).  K1/K3 take the word and write nothing when
  it is set; the unfused optimizer route, the BatchNorm statistics, the
  row-sparse rows (every row mapped out of the table) and the 2-bit
  residuals select their old values on the card.  A bad step thus leaves
  the weights, the optimizer state, the statistics and the residuals as
  they were, with no host sync; the step count advances, as the
  reference's does.  The streak of bad steps stays on the card and
  ``resilience.watch_streak`` reads it once the step has completed
  (over several ranks at a fixed lag of two steps, blocking, so every
  rank learns of a crossing at the same step and none enters a
  collective its peers have left); ``step`` checks the abort first
  (``maybe_abort_nonfinite``, with a checkpoint of the last good state);
- the ``nan`` fault poisons the batch of the step it names;
- ``attach_checkpoint_manager``: the manager's every-N saves after each
  step, restore (falling back past corrupt files), the preemption and
  abort saves; over several processes the manager takes the coordinated
  protocol (``elastic.coordinate``);
- ``mx.elastic``'s per-step preemption agreement when ``elastic.dir`` is
  set, then ``resilience.exit_on_preempt``.

Observability (``mx.telemetry``, ``mx.tracing``, ``mx.numerics``), where
the reference wires it: each step runs under
``telemetry.step_scope("spmd")`` and the ``spmd.step`` span (the batch's
staging in ``spmd.shard_batch``, a rebuilt step in ``spmd.compile``) and
counts ``fused_steps`` (``fused_compiles`` a build, ``host_syncs`` two an
lr/wd change).  Under ``numerics.capture=step:N`` every Nth step
summarizes ``out``, ``loss``, then each trainable's ``grad.<name>`` (after
the all-reduce and ``rescale_grad``/clipping) and ``update.<name>`` (its
value after the update), with the forward's own taps first, and
publishes them without a host sync (``numerics.publish``); such a step
runs the uncompressed sync.  With the nanguard on, each step holds a
replay of its batch (``numerics.hold_replay``): on the abort it re-runs
on copies of the state with the skip word off, so the candidate update
shows what the bad step would have written.

Refused (``NotImplementedError``, never ignored): the row-sparse route
and the compressed step on meshes whose other axes than the batch axes
have more than one rank, a ``param_specs`` entry for a routed table and
``conv.weights_layout=HWIO``.

``save_checkpoint`` / ``load_checkpoint`` keep the reference's
single-file checkpoint: a pickle of numpy arrays under the same keys
(``schema``, ``format``, ``step_num``, ``params`` in OIHW, ``opt_state``,
``rng_key``, and ``dcn_residuals`` after compressed steps), published
atomically, so each package reads the other's.  A vocab-sharded table is
gathered whole; rank 0 writes.  A reference checkpoint's ``rng_key`` (a
JAX key) is not read: the two packages' random streams never agree.

``save_checkpoint_sharded`` / ``load_checkpoint_sharded`` write a
directory through ``torch.distributed.checkpoint``: every rank writes
only its own blocks of the ``param_specs``-sharded tensors and of their
optimizer state (a replicated tensor is written once), each block keyed
by its offsets in the whole tensor, and a load reads into the trainer's
current sharding whatever blocks overlap this rank's.  The reference's
sharded format is an orbax directory, which this package does not read
(and the reverse): the single-file format is the one the two packages
share.
"""
from __future__ import annotations

import functools
import math
import os
import pickle

import numpy as _np
import torch

from .. import config as _config
from .. import elastic as _elastic
from .. import kernels as _kernels
from .. import numerics as _numerics
from .. import profiler as _profiler
from .. import resilience as _resilience
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..io import ensure_staged
from ..ndarray.ndarray import NDArray, _wrap
from . import dist as _dist
from . import embedding as _pemb
from .collectives import local_block, unshard
from .functional import functionalize
from .mesh import (PartitionSpec, data_parallel_mesh, _local_rows,
                   _spec_axes)

__all__ = ["SPMDTrainer", "build_train_step"]

def _f32(x):
    """A Python float rounded to f32, as a Python float."""
    return float(_np.float32(x))


def _div(x, d):
    """``x / d`` for a Python number ``d`` as one IEEE division on every
    device (the card divides by a Python scalar through its reciprocal);
    the divisor is made by a fill, not copied from the host."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def _step_signature(args, kwargs):
    """mx.perf's signature of an SPMDTrainer step call ``(data, label, t,
    lrs, wds, pad, compress, stats)``: the batch's shapes, whether the
    step compresses and whether it captures statistics."""
    from .. import perf as _perf
    return (_perf.shape_key(args[:2]), bool(args[6]),
            args[7] is not None or kwargs.get("stats") is not None)


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
        self._extra_axes = [a for a in names if a not in self._batch_axes
                            and self.mesh.shape[a] > 1]
        self._param_specs = {n: PartitionSpec(*s) for n, s in
                             (param_specs or {}).items()}
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
        self._ckpt_manager = None
        self._nan_streak = None
        self._hyper_host = None  # the last step's (lrs, wds)

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
        rank of a multi-rank mesh, and create the optimizer state.
        Deferred shapes are resolved by one forward on the first batch."""
        from ..gluon.parameter import DeferredInitializationError
        try:
            vals = self.fn.init_values()
        except DeferredInitializationError:
            self.block(_wrap(data))
            self.fn = functionalize(self.block)
            self._sparse_embed = _pemb.sparse_embedding_params(
                self.fn, self.mesh, self.batch_axis)
            vals = self.fn.init_values()
        unknown = sorted(set(self._param_specs) - set(vals))
        if unknown:
            raise ValueError("param_specs names %s are not parameters of "
                             "the block (%s)" % (unknown, sorted(vals)))
        self.params = {}
        for n, v in vals.items():
            t = v.detach().to(self.device, copy=True)
            if self.mesh.size > 1:
                # a rank-local (one-device) mesh calls no collective
                _dist.broadcast_(t, src=0)
            spec = self._spec_of(n)
            if spec is not None:
                t = local_block(t, self.mesh, spec).clone()
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
        _dist.all_reduce_(report, group=self._batch_group())
        return _div(local, count), _div(report, count)

    def _batch_group(self):
        return self.mesh.group(self._batch_axes)

    def _whole(self, n, v):
        """A dense trainable's whole value for the forward: ``v`` itself,
        or gathered over its ``param_specs`` axes (its backward takes
        this rank's block of the gradient)."""
        spec = self._param_specs.get(n)
        return v if spec is None else unshard(v, self.mesh, spec)

    def _forward_backward(self, train, aux, tables, deltas, data, label,
                          pad, local_mean, stats=None):
        """The step's forward and backward at the given masters:
        ``(loss, new_aux, grads, delta_grads, unique ids)``, grads in the
        order of the dense trainables, f32 for f32 masters, contiguous
        (under ``conv.internal_layout=NHWC`` a conv weight's gradient
        comes back channels_last), not yet reduced over ranks; the unique
        ids of each routed table that was looked up.  ``stats`` (a dict)
        takes the forward's taps, then ``out`` and ``loss``."""
        from ..ops import nn as _nn_ops
        from ..ops import tensor as _tensor_ops
        fn, cdt = self.fn, self.compute_dtype

        def cast(v):
            return v.to(cdt) if cdt is not None and v.dtype == torch.float32 \
                else v
        with torch.enable_grad():
            param_map = dict(aux)  # aux (BN stats) stay f32
            param_map.update({n: self._whole(n, cast(v))
                              for n, v in train.items()})
            routed = {n: cast(v) for n, v in tables.items()}
            param_map.update(routed)
            if cdt is not None and data.dtype == torch.float32:
                data = data.to(cdt)  # int inputs (ids) keep their dtype
            ctx = _pemb.SparseLookupContext(
                self.mesh, self._sparse_embed, routed, deltas,
                self._batch_axes) if tables else None
            bn_stats = (self.mesh, self._batch_axes) \
                if self._n_shards > 1 and not local_mean else None
            prev = _tensor_ops.set_embed_context(ctx)
            prev_stats = _nn_ops.set_batch_stats_context(bn_stats)
            try:
                if stats is not None:
                    # the model's own taps (the routed tables' touched
                    # rows, a transformer's layer_out) fill the collector
                    with _numerics.collect() as sink:
                        (out,), new_aux = fn.apply(param_map, (data,),
                                                   training=True)
                    stats.update(sink)
                else:
                    (out,), new_aux = fn.apply(param_map, (data,),
                                               training=True)
            finally:
                _tensor_ops.set_embed_context(prev)
                _nn_ops.set_batch_stats_context(prev_stats)
            if cdt is not None:
                out = out.float()
            loss, report = self._loss_terms(
                _raw_loss(self.loss_fn, out, label), pad, local_mean)
            if stats is not None:
                _numerics.record(stats, "out", out)
                _numerics.record(stats, "loss", report)
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
        if routed and (self._extra_axes or set(routed)
                       & set(self._param_specs)):
            raise NotImplementedError(
                "the row-sparse embedding route of %s is not ported on a "
                "mesh with axes %s besides the batch axes, nor under "
                "param_specs" % (routed, self._extra_axes))
        if routed and not optimizer.lazy_rows():
            raise ValueError(
                "sparse-grad embedding params %s need an optimizer with a "
                "lazy step_rows path (sgd, adam); %r has none — set config "
                "embedding.sharded=False to train them densely"
                % (routed, type(optimizer).__name__))
        multi = self._n_shards > 1
        guarded = bool(_resilience.nanguard_mode())
        # sharded parameters leave each rank its own blocks of gradients:
        # their words are summed over the world, so every rank skips alike
        shared_word = self.mesh.size > 1 and bool(
            self._param_specs or self._extra_axes)

        @torch.no_grad()
        def step(data, label, t, lrs, wds, pad, compress, stats=None,
                 guard=guarded):
            """The step; returns ``(loss, skip word or None)``.  ``stats``
            (a dict) takes the step's numerics sites; ``guard=False``
            drops the skip word (the forensics replay)."""
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
                train, aux, tables, deltas, data, label, pad, compress,
                stats)
            if compress:
                old_res = self._dcn_residuals
                grads = self._dcn_sync(dense, grads)
                new_aux = {n: _div(_dist.all_reduce_(v.clone()), self.mesh
                                   .size) if v.is_floating_point() else v
                           for n, v in new_aux.items()}
                loss = _div(_dist.all_reduce_(loss.clone()), self.mesh.size)
            elif multi:
                both = grads + [dgrads[n] for n in routed]
                flat = torch.cat([g.reshape(-1) for g in both])
                _dist.all_reduce_(flat, group=self._batch_group())
                both = _split(flat, both)
                grads = both[:len(grads)]
                dgrads = dict(zip(routed, both[len(grads):]))
            word = keep = None
            if guard:
                # one word over the loss and the reduced gradients, the
                # same on every rank; a set word drops every write below
                word = _resilience.skip_word(loss, grads, dgrads)
                if shared_word:
                    word = _dist.all_reduce_(
                        word.to(self.device),
                        group=self.mesh.group(self.mesh.axis_names))
                keep = word == 0
                if compress:
                    # a dropped step takes back its quantization error
                    prev = old_res if old_res is not None else {
                        n: torch.zeros_like(r)
                        for n, r in self._dcn_residuals.items()}
                    self._dcn_residuals = _resilience.select_tree(
                        keep, self._dcn_residuals, prev)
            grads = [_preprocess(optimizer, g) for g in grads]
            gvs = {n: _preprocess(optimizer, dgrads[n].to(tables[n].dtype))
                   for n in routed if recs.get(n) is not None}
            if stats is not None:
                by_name = dict(zip(dense, grads), **gvs)
                for n in self.fn.trainable:
                    if n in by_name:
                        _numerics.record(stats, "grad." + n, by_name[n])
            masters = [params[n] for n in dense]
            states = [state[n] for n in dense]
            lr_d = [lrs[index[n]] for n in dense]
            wd_d = [wds[index[n]] for n in dense]
            if masters and fused_opt and all(
                    w.dtype == torch.float32 for w in masters):
                optimizer.step_fused_multi(masters, grads, states, lr_d,
                                           wd_d, t, skip=word)
            else:
                for w, g, s, lr, wd in zip(masters, grads, states, lr_d,
                                           wd_d):
                    nw, ns = optimizer.step(w, g, s, lr, wd, t)
                    nw = nw.to(w.dtype)
                    if guard:
                        nw = torch.where(keep, nw, w)
                        ns = _resilience.select_tree(keep, ns, s)
                    w.copy_(nw)
                    _state_copy(s, ns)
            for n in routed:
                uniq = recs.get(n)
                if uniq is None:
                    continue  # not looked up this forward: no row to touch
                meta = self._sparse_embed[n]
                _pemb.update_unique(
                    optimizer, tables[n], state[n], uniq, gvs[n],
                    lrs[index[n]], wds[index[n]], t,
                    self.mesh if meta["axis"] else None, meta["axis"],
                    skip=word)
            for n, v in new_aux.items():
                aux[n].copy_(v if keep is None else torch.where(keep, v,
                                                                aux[n]))
            if stats is not None:
                for n in self.fn.trainable:
                    _numerics.record(stats, "update." + n, params[n])
            if routed:
                # static accounting (no device sync): each routed table
                # gathers and touches ``capacity`` unique rows a step
                rows = cap * len(routed)
                _telemetry.counter("embedding.gathered_rows").inc(rows)
                _telemetry.counter("embedding.rows_touched").inc(rows)
            return loss, word

        from .. import perf as _perf
        # mx.perf counts the step at its first call per signature and
        # feeds the spmd source's MFU (the dense and the sparse step as
        # the reference registers them).  The signature is the batch's
        # shapes and the two flags that change what runs: the per-tensor
        # lr/wd tuples and the trainer's state decide no shape
        return _perf.wrap(step, "spmd", "%s/%x" % (
            "sparse" if routed else "dense", id(self)), source="spmd",
            signature=_step_signature)

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
        must return per-sample losses).

        Around the step, as the reference's: the nanguard's abort check
        (``NonFiniteStepError`` once the device has reported the streak,
        after the forensics replay, the flight-recorder report and a
        checkpoint of the last good state), the ``nan`` fault, the
        telemetry step scope and the ``spmd.step`` span, the attached
        checkpoint manager's every-N save, ``mx.elastic``'s preemption
        agreement, and a pending preemption's save and exit."""
        pad = int(pad or 0)
        self._check_knobs()
        _resilience.maybe_abort_nonfinite("spmd", save_fn=self._preempt_save)
        shape = tuple(int(d) for d in getattr(data, "shape", ())) or None
        with _telemetry.step_scope(
                "spmd", samples=shape[0] - pad if shape else None,
                shape=shape, mesh={n: int(self.mesh.shape[n])
                                   for n in self.mesh.axis_names},
                default_path="fused"), \
                _tracing.span("spmd.step", cat="spmd"):
            loss = self._step_impl(data, label, lr_scale, pad)
        if self._ckpt_manager is not None and \
                self._ckpt_manager.due(self._step_num):
            self._save_through(self._ckpt_manager)
        if _elastic.active():
            # every rank adopts a preemption at this same step boundary,
            # so the coordinated checkpoint below sees one world
            _elastic.maybe_cluster_preempt(self._step_num)
        if _resilience.preempt_requested():
            _resilience.exit_on_preempt(save_fn=self._preempt_save)
        return loss

    def _step_impl(self, data, label, lr_scale, pad):
        with _tracing.span("spmd.shard_batch", cat="spmd"):
            data, label = self._stage(data), self._stage(label)
        if _resilience.faults_active("nan") and _resilience.should_inject(
                "nan", step=self._step_num + 1):
            data = _resilience.poison_batch(data)
        if self.params is None:
            self._materialize(data)
        # a capture step runs the uncompressed sync, so the statistics see
        # the raw gradients (the reference's instrumented variant)
        cap = _numerics.should_capture("spmd")
        compress = (not cap) and self._dcn_compress_active(pad)
        if compress:
            self._dcn_check()
        elif self._dcn_residuals is not None \
                and not self._dcn_compress_active(0):
            # knob turned off: stale error feedback must not leak into a
            # later re-enable
            self._dcn_residuals = None
        key = (_kernels.enabled(), _config.epoch())
        if self._program is None or key != self._program_key:
            with _tracing.span("spmd.compile", cat="spmd"):
                self._program, self._program_key = self._build(), key
            _profiler.counter_increment("fused_compiles")
        self._step_num += 1
        self.optimizer.num_update = self._step_num
        lrs, wds = self._hyper(lr_scale)
        if (lrs, wds) != self._hyper_host:
            # new lr/wd values reach the card (the reference's two
            # uploads of changed hyperparameters)
            self._hyper_host = (lrs, wds)
            _profiler.counter_increment("host_syncs", 2)
        stats = {} if cap else None
        t = self._step_num
        loss, word = self._program(data, label, t, lrs, wds, pad, compress,
                                   stats)
        if word is not None:
            if self._nan_streak is None:
                self._nan_streak = torch.zeros((), dtype=torch.int32,
                                               device=word.device)
            self._nan_streak = _resilience.guarded_streak(
                word == 0, self._nan_streak)
            # over several ranks the host reads the streak two steps
            # behind, blocking, so every rank aborts at the same step
            _resilience.watch_streak(
                "spmd", self._nan_streak,
                lag=2 if self.mesh.size > 1 else 0)
            _numerics.hold_replay("spmd", functools.partial(
                self._replay_stats, data, label, t, lrs, wds, pad))
        if stats is not None:
            _numerics.publish("spmd", self._step_num, stats)
        _profiler.counter_increment("fused_steps")
        return loss

    def _replay_stats(self, data, label, t, lrs, wds, pad):
        """The nanguard's forensics: one step on ``data`` / ``label`` with
        every site summarized, on copies of the weights, optimizer state
        and statistics and without the skip word, so the candidate update
        shows what the bad step would have written; the trainer's own
        state is left as it was.  Returns the stats mapping."""
        saved = self.params, self.opt_state
        with torch.no_grad():
            self.params = {}
            for n, v in saved[0].items():
                self.params[n] = v.detach().clone().requires_grad_(
                    v.requires_grad)
            self.opt_state = {n: _tree(s, torch.clone)
                              for n, s in saved[1].items()}
        stats = {}
        try:
            self._program(data, label, t, lrs, wds, pad, False, stats,
                          guard=False)
        finally:
            self.params, self.opt_state = saved
        return stats

    def _dcn_check(self):
        extra = [a for a in self.mesh.axis_names
                 if a not in ("dcn", self.batch_axis)]
        if extra:
            raise NotImplementedError(
                "kvstore.grad_compress=2bit supports data-parallel meshes "
                "('dcn' + the batch axis); this mesh also has axes %s"
                % (extra,))

    # ------------------------------------------------------ whole values
    def _spec_of(self, n):
        """The PartitionSpec of parameter ``n`` on this mesh (a
        vocab-sharded table's rows over its axis), or None if whole."""
        meta = self._sparse_embed.get(n)
        if meta is not None and meta["axis"] is not None:
            return PartitionSpec(meta["axis"])
        return self._param_specs.get(n)

    @torch.no_grad()
    def _full(self, n):
        """Parameter ``n`` whole on this rank (gathered over its
        :meth:`_spec_of` axes)."""
        v = self.params[n].detach()
        spec = self._spec_of(n)
        return v if spec is None else unshard(v, self.mesh, spec)

    @torch.no_grad()
    def _full_state(self, n):
        spec = self._spec_of(n)
        if spec is None:
            return self.opt_state[n]
        return _tree(self.opt_state[n],
                     lambda s: unshard(s, self.mesh, spec))

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
        part in gathering the sharded tables and rank 0 writes (its aux
        state, which the synchronised statistics make every rank's)."""
        host = self._checkpoint_host()
        if self.mesh.rank == 0:
            self._write_checkpoint(path, host)
        _dist.barrier("checkpoint")

    def _checkpoint_host(self):
        """The checkpoint's values on the host (every rank takes part in
        gathering the sharded ones)."""
        from ..random import _STATE
        from ..resilience import CKPT_SCHEMA
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
        return host

    @staticmethod
    def _write_checkpoint(path, host):
        """Publish ``host`` (:meth:`_checkpoint_host`) at ``path``
        atomically; no collective."""
        from ..resilience import atomic_write
        with atomic_write(path, "wb") as f:
            pickle.dump(host, f, protocol=4)

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
            spec = self._spec_of(n)

            def leaf(a):
                t = torch.as_tensor(a)
                if spec is not None:
                    t = local_block(t, self.mesh, spec)
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

    # --------------------------------------------------- checkpoint manager
    def attach_checkpoint_manager(self, manager, auto_resume=True):
        """Wire a ``resilience.CheckpointManager`` into the step: its
        every-N save after each step, the preemption save, and the
        nanguard abort's save of the last good state.  With
        ``auto_resume`` the newest good checkpoint is restored now (a
        corrupt newest file is skipped); returns the restored step, or
        None on a cold start.  Over several processes the manager takes
        the coordinated protocol (``elastic.coordinate``: rank 0 writes,
        a world-stamped manifest, a barrier)."""
        if _dist.world_size() > 1:
            manager = _elastic.coordinate(manager, mesh=self.mesh)
        self._ckpt_manager = manager
        if auto_resume:
            return manager.restore(self.load_checkpoint)
        return None

    def _preempt_save(self):
        """The preemption and abort checkpoint, through the attached
        manager."""
        if self._ckpt_manager is not None and self.params is not None:
            self._save_through(self._ckpt_manager)

    def _save_through(self, manager):
        """Save the current step through ``manager``: every rank takes
        part in gathering the checkpoint's values (the collectives), and
        the manager's writer (rank 0 under the coordinated protocol)
        writes them, retried without any collective."""
        host = self._checkpoint_host()
        manager.save(self._step_num,
                     lambda path: self._write_checkpoint(path, host))

    # -------------------------------------------------- sharded checkpoints
    def _block_key(self, prefix, n, t):
        """``prefix@o0,o1,...``: the key of this rank's block ``t`` of
        parameter ``n`` (or of its state), by the block's offsets in the
        whole tensor."""
        spec = self._spec_of(n)
        offs = []
        for d, size in enumerate(t.shape):
            part = spec[d] if spec is not None and d < len(spec) else None
            offs.append(0 if part is None else self.mesh.block_index(
                _spec_axes(part)) * size)
        return "%s@%s" % (prefix, ",".join(map(str, offs)))

    def _sharded_items(self, saved_name=None):
        """``[(prefix, name, tensor)]`` of every tensor a sharded
        checkpoint holds: the parameters, then each optimizer state's
        leaves; ``saved_name`` maps a name to the one its prefix
        carries."""
        key = saved_name or (lambda n: n)
        items = [("params/" + key(n), n, v.detach())
                 for n, v in self.params.items()]
        for n, st in self.opt_state.items():
            items += [("opt_state/%s/%d" % (key(n), i), n, leaf)
                      for i, leaf in enumerate(_state_leaves(st))]
        return items

    def _dcp_kwargs(self):
        # a rank-local mesh takes no part in the other ranks' collectives
        return {"no_dist": True} if self.mesh.size == 1 else {}

    def save_checkpoint_sharded(self, path):
        """Write a sharded checkpoint directory through
        ``torch.distributed.checkpoint``: each rank writes only its blocks
        (a replicated tensor once), with the step count and this
        package's random-stream position.  Every rank of the mesh calls
        it.  Refuses to overwrite a directory that is not such a
        checkpoint."""
        import torch.distributed.checkpoint as dcp
        from ..random import _STATE
        if self.params is None:
            raise RuntimeError("save_checkpoint_sharded: the trainer has "
                               "taken no step, so it holds no weights yet")
        path = os.path.abspath(path)
        if os.path.isdir(path) and os.listdir(path) and not os.path.exists(
                os.path.join(path, ".metadata")):
            raise ValueError("%s exists and is not a sharded checkpoint; "
                             "refusing to overwrite it" % path)
        state = {self._block_key(p, n, t): t
                 for p, n, t in self._sharded_items()}
        state["meta/step_num"] = torch.tensor(self._step_num,
                                              dtype=torch.int64)
        state["meta/rng"] = torch.tensor([_STATE.seed_val, _STATE.counter],
                                         dtype=torch.int64)
        dcp.save(state, checkpoint_id=path, **self._dcp_kwargs())

    @torch.no_grad()
    def load_checkpoint_sharded(self, path):
        """Load a directory :meth:`save_checkpoint_sharded` wrote into this
        trainer's current sharding: each rank reads the saved blocks that
        overlap its own and copies the overlap.  Returns the step count.
        A directory without the checkpoint's metadata (an interrupted
        save, a wrong path) raises ``resilience.CheckpointCorruptError``;
        names pair up after each net's own prefix."""
        import torch.distributed.checkpoint as dcp
        from ..convert import _own_prefix, pair_names
        from ..random import _STATE
        from ..resilience import CheckpointCorruptError
        path = os.path.abspath(path)
        if not os.path.isdir(path) or not os.path.exists(
                os.path.join(path, ".metadata")):
            raise CheckpointCorruptError(
                "%s is not a sharded checkpoint (no .metadata: an "
                "interrupted save or a wrong path)" % path)
        try:
            saved = dcp.FileSystemReader(path).read_metadata() \
                .state_dict_metadata
        except Exception as exc:  # noqa: BLE001 — any unreadable metadata
            raise CheckpointCorruptError(
                "the metadata of %s is unreadable (%s: %s)"
                % (path, type(exc).__name__, exc)) from exc
        if self.params is None:
            self._materialize(None)
        blocks = {}  # prefix -> [(offsets, key)]
        for key in saved:
            if "@" in key:
                prefix, offs = key.rsplit("@", 1)
                blocks.setdefault(prefix, []).append(
                    (tuple(int(o) for o in offs.split(",") if o), key))
        names = list(self.fn.params)
        saved_names = sorted({p[len("params/"):] for p in blocks
                              if p.startswith("params/")})
        try:
            pairs = pair_names(names, saved_names,
                               _own_prefix(self.block, names))
        except ValueError as exc:
            raise CheckpointCorruptError(
                "sharded checkpoint %s is another network's: %s"
                % (path, exc)) from exc
        plan, buffers = [], {}
        for prefix, n, t in self._sharded_items(pairs.__getitem__):
            mine = [int(o) for o in self._block_key(prefix, n, t)
                    .rsplit("@", 1)[1].split(",") if o]
            for offs, key in blocks.get(prefix, ()):
                size = tuple(saved[key].size)
                lo = [max(a, b) for a, b in zip(offs, mine)]
                hi = [min(a + s, b + e) for a, s, b, e in
                      zip(offs, size, mine, t.shape)]
                if any(h <= l for l, h in zip(lo, hi)):
                    continue
                if key not in buffers:
                    buffers[key] = torch.empty(
                        size, dtype=saved[key].properties.dtype)
                plan.append((t, key, offs, mine, lo, hi))
        buffers["meta/step_num"] = torch.zeros((), dtype=torch.int64)
        buffers["meta/rng"] = torch.zeros(2, dtype=torch.int64)
        dcp.load(buffers, checkpoint_id=path, **self._dcp_kwargs())
        for t, key, offs, mine, lo, hi in plan:
            src, dst = buffers[key], t
            for d, (l, h) in enumerate(zip(lo, hi)):
                src = src.narrow(d, l - offs[d], h - l)
                dst = dst.narrow(d, l - mine[d], h - l)
            dst.copy_(src)
        self._step_num = int(buffers["meta/step_num"])
        self.optimizer.num_update = self._step_num
        self._program = None
        self._dcn_residuals = None
        _STATE.seed_val, _STATE.counter = (int(v)
                                           for v in buffers["meta/rng"])
        return self._step_num


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


def _state_leaves(state):
    """The tensors of an optimizer state tree, in order."""
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [t for s in state for t in _state_leaves(s)]
    return [state]


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
