"""Trainer — applies an Optimizer to a set of Parameters (counterpart of
``mxnet_tpu.gluon.trainer``).

Reference: ``python/mxnet/gluon/trainer.py:27``.  The imperative Gluon
loop: ``loss.backward()`` under ``autograd.record()`` fills each
Parameter's grad buffer, and ``step(batch_size)`` sets
``rescale_grad = scale / batch_size``, reduces the gradients through the
kvstore (``push`` then ``pull``; the identity on one device) and runs the
optimizer's ``Updater`` on every Parameter whose ``grad_req`` is not
``'null'``, in the order of the sorted Parameter names.
``update_on_kvstore`` defaults to True for a distributed kvstore
(``dist_*``: every rank pushes its gradients, the store sums them over
the ranks and runs the updater on the sum) and to False otherwise, as
the reference's ``_create_kvstore`` decides.  ``compression_params``
(``{"type": "2bit", "threshold": t}``) go to the kvstore, whose dist
push then sends 2-bit codes with error feedback.

A Parameter on several contexts (``initialize(ctx=[...])``) keeps one
copy a context.  ``step`` sums the copies' gradients over the contexts
(in context order, on the first copy's device; every copy's buffer then
holds the sum, as after MXNet's kvstore pull), updates the first copy
once and writes the new value to every other copy.  So a step over the
slices of ``split_and_load`` is the step of one context over the whole
batch, up to the order of the sums.

A row-sparse gradient (``Embedding(sparse_grad=True)``) under an
optimizer with a lazy row step (``Optimizer.lazy_rows``: SGD, Adam)
updates only the rows its lookups read since the last step
(``Parameter.take_rows``), as the reference's ``RowSparseNDArray``
gradient does (``gluon/trainer.py:298-306``, ``optimizer.py:214-230``):
a row no lookup read sees no weight decay and no momentum or moment
decay, and a looked-up row with a zero gradient does.  The kvstore's
updater takes a dense sum and the union of the rows over several ranks
is not taken, so ``update_on_kvstore`` and a kvstore of more than one
worker raise for such a parameter, with the reason.

``save_states`` writes the optimizer states and the optimizer to a
file atomically (``Updater.get_states(dump_optimizer=True)``);
``load_states`` reads the port's files and the reference's (a pickle of
numpy arrays and the reference's Optimizer, read without importing the
reference: ``optimizer.Updater.set_states``).

Resilience, as in the reference: under ``resilience.nanguard`` the
update checks the gradients on the host (one sync a step) and skips a
non-finite step (``gluon.nonfinite_steps``); ``step`` checks the abort
first and finishes a pending preemption last, both through the save
``set_preemption_save`` registers.  The abort's forensics replay
summarizes the live gradients (``grad.<name>``).

Observability, as in the reference: ``step`` runs under
``telemetry.step_scope("gluon")`` and the ``gluon.step`` span, with the
``gluon.allreduce`` and ``gluon.opt_update`` spans inside; under
``numerics.capture=step:N`` every Nth update summarizes each
parameter's ``grad.<name>`` before its update and ``update.<name>``
after, and publishes them without a host sync.
"""
from __future__ import annotations

import torch

from .. import numerics as _numerics
from .. import optimizer as opt
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..kvstore import create as _create_kvstore
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """Applies an Optimizer on a set of Parameters (reference
    ``trainer.py:27``)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[key] for key in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got %s." % (type(params)))
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    "got list of %s." % (type(param)))
            self._param2idx[param.name] = i
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._params_to_init = list(self._params)
        self._preempt_save = None
        self._numerics_t = 0  # updates run, the capture's step index

    def set_preemption_save(self, fn):
        """Register ``fn()`` (e.g. a closure over ``save_parameters`` and
        :meth:`save_states`) as the checkpoint a preemption
        (``resilience.on_preempt=save_and_exit``) or a nanguard abort
        writes before the process exits or raises."""
        self._preempt_save = fn

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]

    def _init_kvstore(self):
        kvstore = self._kvstore_params["kvstore"]
        update_on_kvstore = self._kvstore_params["update_on_kvstore"]
        if kvstore:
            kv = _create_kvstore(kvstore) if isinstance(kvstore, str) \
                else kvstore
            if update_on_kvstore is None:
                # update on the store iff it is distributed (reference
                # model.py _create_kvstore)
                update_on_kvstore = "dist" in kv.type
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            lazy = [p.name for p in self._params if self._lazy(p)]
            if lazy and (update_on_kvstore or kv.num_workers > 1):
                raise NotImplementedError(
                    "gluon.Trainer: the lazy row-sparse update of %s is not "
                    "ported with update_on_kvstore (the store's updater "
                    "takes a dense sum) nor over %d workers (the union of "
                    "the rows the ranks read is not taken); pass "
                    "update_on_kvstore=False on one worker, or train on "
                    "SPMDTrainer's row-sparse route" % (lazy,
                                                        kv.num_workers))
            self._kvstore = kv
            self._update_on_kvstore = update_on_kvstore
            if update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        else:
            self._kvstore = None
            self._update_on_kvstore = False
        self._kv_initialized = True

    def _init_params(self):
        """Hand each initialized Parameter to the kvstore; deferred ones
        wait for their first forward."""
        pending = []
        if self._kvstore:
            for param in self._params_to_init:
                if param._deferred_init:
                    pending.append(param)
                else:
                    self._kvstore.init(self._param2idx[param.name],
                                       param.list_data()[0])
        self._params_to_init = pending

    def _ready(self):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def batch_placement(self):
        """Where input batches belong: the device of the first initialized
        Parameter (None while all are deferred: the current context).
        Hand it to ``io.DevicePrefetcher`` (``placement=
        trainer.batch_placement``), so batches arrive next to the
        weights."""
        for param in self._params:
            if param._data is not None:
                return param.data()._data.device
        return None

    def step(self, batch_size, ignore_stale_grad=False):
        """One parameter update (reference ``trainer.py:305``): gradients
        rescaled by ``1 / batch_size``, reduced, then applied.  The
        nanguard's abort check comes first and a pending preemption's
        save and exit last, as in the reference."""
        from .. import resilience as _resilience
        _resilience.maybe_abort_nonfinite("gluon",
                                          save_fn=self._preempt_save)
        with _telemetry.step_scope("gluon", samples=int(batch_size),
                                   default_path="eager"), \
                _tracing.span("gluon.step", cat="gluon"):
            rescale_grad = self._scale / batch_size
            self._check_and_rescale_grad(rescale_grad)
            self._ready()
            with _tracing.span("gluon.allreduce", cat="gluon"):
                self._allreduce_grads()
            with _tracing.span("gluon.opt_update", cat="gluon"):
                self._update(ignore_stale_grad)
        if _resilience.preempt_requested():
            _resilience.exit_on_preempt(save_fn=self._preempt_save)

    def _check_and_rescale_grad(self, scale):
        if self._update_on_kvstore and self._kv_initialized and \
                self._kvstore and self._optimizer.rescale_grad != scale:
            raise UserWarning(
                "Possible change in the `batch_size` from previous `step` "
                "detected. Optimizer gradient normalizing factor will not "
                "change w.r.t new batch_size when update_on_kvstore=True")
        self._optimizer.rescale_grad = scale

    def allreduce_grads(self):
        """Reduce the gradients without updating (reference
        ``trainer.py:335``)."""
        self._ready()
        if self._kvstore and self._update_on_kvstore:
            raise RuntimeError(
                "allreduce_grads() when parameters are updated on kvstore "
                "is not supported. Try setting `update_on_kvstore` to "
                "False when creating trainer.")
        self._allreduce_grads()

    def _allreduce_grads(self):
        for param in self._params:
            if param.grad_req != "null":
                param._sum_grads()
        if not self._kvstore:
            return
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            grad = param.list_grad()[0]
            if self._update_on_kvstore:
                self._kvstore.pushpull(i, grad, out=param.list_data()[0],
                                       priority=-i)
                param._broadcast_data()
            else:
                self._kvstore.push(i, [grad], priority=-i)
                self._kvstore.pull(i, [grad], priority=-i)
                param._broadcast_grad()

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply already-reduced gradients (reference ``trainer.py:374``)."""
        self._ready()
        if self._kvstore and self._update_on_kvstore:
            raise RuntimeError(
                "update() when parameters are updated on kvstore is not "
                "supported. Try setting `update_on_kvstore` to False when "
                "creating trainer.")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _lazy(self, param):
        return param.grad_stype == "row_sparse" and \
            self._optimizer.lazy_rows()

    def _update(self, ignore_stale_grad=False):
        if self._kvstore and self._update_on_kvstore:
            return
        from .. import resilience as _resilience
        self._numerics_t += 1
        stats = {} if _numerics.should_capture("gluon") else None
        if _resilience.nanguard_mode():
            # the forensics replay of the eager loop: the live gradients
            # (a bad step skips the update, and the abort comes before the
            # next backward writes them)
            def _replay(params=self._params):
                sink = {}
                for p in params:
                    if p.grad_req != "null":
                        _numerics.record(sink, "grad." + p.name,
                                         p.list_grad()[0])
                return sink
            _numerics.hold_replay("gluon", _replay)
            # the eager loop: one host sync a step, as the reference's
            grads = [p.list_grad()[0] for p in self._params
                     if p.grad_req != "null"]
            if int(_resilience.skip_word(grads)):
                _resilience.report_nonfinite("gluon")
                return
            _resilience.note_finite("gluon")
        updater = self._updaters[0]
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            weight, grad = param.list_data()[0], param.list_grad()[0]
            if stats is not None:
                _numerics.record(stats, "grad." + param.name, grad)
            if self._lazy(param):
                rows = param.take_rows()
                if rows is None:
                    rows = torch.empty(0, dtype=torch.int32)
                updater.update_rows(i, rows, grad, weight)
            else:
                updater(i, grad, weight)
            param._broadcast_data()
            if stats is not None:
                _numerics.record(stats, "update." + param.name,
                                 param.list_data()[0])
        if stats:
            _numerics.publish("gluon", self._numerics_t, stats)

    def save_states(self, fname):
        """Save the optimizer states and the optimizer to ``fname``,
        atomically (reference ``trainer.py:318``)."""
        from ..resilience import atomic_write
        self._ready()
        if self._update_on_kvstore:
            if self._params_to_init:
                raise RuntimeError("Cannot save trainer states when some "
                                   "parameters are not yet initialized in "
                                   "kvstore.")
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with atomic_write(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load states that :meth:`save_states` wrote, in this package or
        in the reference (reference ``trainer.py:336``); the loaded
        optimizer replaces this Trainer's, with this Trainer's
        Parameters."""
        self._ready()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            self._updaters[0].set_states(states)
            self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = {i: param for i, param
                                      in enumerate(self._params)}
