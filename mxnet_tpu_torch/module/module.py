"""Module — a symbol bound to one Executor (counterpart of
``mxnet_tpu.module.module``).

Reference: ``python/mxnet/module/module.py:40``.  One Executor carries
the whole batch on one device, and ``update`` applies the optimizer
directly (the reference's ``update_on_kvstore=False`` path: the kvstore
types ``local``, ``device`` and their kin all mean this).

The train step is FUSED when it may be: ``forward_backward`` defers the
batch and ``update`` runs ``Executor.fused_step_fn``, one step that takes
the forward, the gradients and the optimizer update of every parameter
in place (through the optimizer's fused kernel when the kernel tier is
on: K3 for Adam, K1 for SGD).  The stage-at-a-time eager step (forward,
backward, then the ``Updater`` per parameter) runs instead under
``NaiveEngine``, ``module.fused_step=off``, an optimizer that is not
``jit_safe``, ``inputs_need_grad``, a grad_req other than "write", or a
Module subclass.  Explicit ``forward()`` / ``backward()`` calls are
always eager; observing outputs, gradients or parameters between
``forward_backward`` and ``update`` replays the deferred batch eagerly
first (``module.eager_replays`` counts it).  ``fused_steps`` /
``eager_steps`` count the steps of each route in telemetry.

Parameters are the Module's own tensors, updated in place:
``init_params`` / ``set_params`` copy what they are given, and
``get_params`` returns copies.  Not ported (raise NotImplementedError
when asked for): the nanguard, numerics capture, Monitor, and optimizer
state in checkpoints.
"""
from __future__ import annotations

import logging

import torch

from .. import config as _config
from .. import optimizer as opt_mod
from .. import telemetry as _telemetry
from ..base import torch_dtype
from ..context import resolve_device
from ..initializer import InitDesc, Uniform
from ..kvstore import _DIST_TYPES, _LOCAL_TYPES
from ..ndarray.ndarray import NDArray, _wrap
from .base_module import BaseModule

__all__ = ["Module"]

# knobs of reference features the port does not have yet: set, they would
# change what a step computes, so the Module refuses to train
_UNPORTED_KNOBS = {
    "resilience.nanguard": "the nanguard (non-finite step guard)",
    "numerics.capture": "in-step numerics capture",
}


def _norm_shapes(shapes, names):
    """``[(name, shape)]`` from DataDescs, pairs or bare shapes; and
    ``{name: dtype}`` where a DataDesc names one."""
    out, dtypes = [], {}
    for i, s in enumerate(shapes or []):
        if hasattr(s, "name"):
            out.append((s.name, tuple(s.shape)))
            if getattr(s, "dtype", None) is not None:
                dtypes[s.name] = s.dtype
        elif isinstance(s, tuple) and len(s) == 2 and isinstance(s[0], str):
            out.append((s[0], tuple(s[1])))
        else:
            out.append((names[i], tuple(s)))
    return out, dtypes


class Module(BaseModule):
    """Symbolic Module (reference ``python/mxnet/module/module.py:40``);
    see the module docstring for its two train-step routes.  ``context``
    is where the executor's arrays live (``cuda:0`` by default)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if group2ctxs:
            raise NotImplementedError("group2ctxs placement is not ported")
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise NotImplementedError(
                    "one context per Module: data parallelism over several "
                    "cards is not ported")
            context = context[0]
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._context = context
        self._fixed_param_names = set(fixed_param_names or [])
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._data_shapes = None
        self._label_shapes = None
        self._inputs_need_grad = False
        # the batch forward_backward deferred for the fused step
        self._pending_batch = None
        # the fused route's optimizer state (by parameter name) and step
        self._fused_state = {}
        self._fused_t = 0

    # ------------------------------------------------------------- binding
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self._data_shapes, dtypes = _norm_shapes(data_shapes,
                                                 self._data_names)
        self._label_shapes, ldtypes = _norm_shapes(label_shapes,
                                                   self._label_names)
        dtypes.update(ldtypes)
        device = resolve_device(self._context)
        shapes = dict(self._data_shapes + self._label_shapes)
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        args = {}
        for name, shp in zip(self._symbol.list_arguments(), arg_shapes):
            if shp is None:
                raise ValueError("cannot infer shape of %r from data shapes "
                                 "%s" % (name, shapes))
            args[name] = _wrap(torch.zeros(
                shp, dtype=torch_dtype(dtypes.get(name)), device=device))
        aux = {}
        for name, shp in zip(self._aux_names, aux_shapes):
            if shp is None:
                raise ValueError("cannot infer shape of aux %r" % (name,))
            aux[name] = _wrap(torch.zeros(shp, device=device))
        req = {}
        for n in args:
            if n in self._data_names:
                req[n] = "write" if inputs_need_grad else "null"
            elif n in self._label_names or n in self._fixed_param_names:
                req[n] = "null"
            else:
                req[n] = grad_req if for_training else "null"
        grads = {n: _wrap(torch.zeros_like(args[n]._data))
                 for n, r in req.items() if r != "null"}
        from ..symbol.symbol import Executor
        self._exec = Executor(self._symbol, device, args, grads, req, aux)
        self.binded = True
        self.for_training = for_training
        self._inputs_need_grad = inputs_need_grad
        self._pending_batch = None

    # -------------------------------------------------------------- params
    def init_params(self, initializer="default", arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Set each parameter from ``arg_params`` / ``aux_params`` (copied)
        or else from ``initializer`` (``Uniform(0.01)`` by default, the
        reference's; drawn from ``mx.random``'s stream), called with an
        ``InitDesc`` of the parameter's attrs, so a variable's own
        ``init=`` (its ``__init__`` attr) takes precedence."""
        if not self.binded:
            raise RuntimeError("bind() first")
        if self.params_initialized and not force_init:
            return
        if initializer == "default":
            initializer = Uniform(0.01)
        from ..symbol.symbol import _copy_onto
        attrs = self._symbol.attr_dict()
        for names, pool, given in (
                (self._param_names, self._exec.arg_dict, arg_params),
                (self._aux_names, self._exec.aux_dict, aux_params)):
            for name in names:
                arr = pool[name]
                if given and name in given:
                    arr._data = _copy_onto(given[name], arr._data)
                elif initializer is not None:
                    initializer(InitDesc(name, attrs.get(name, {})), arr)
                elif pool is self._exec.arg_dict and not allow_missing:
                    raise RuntimeError("no initializer and no value for %r"
                                       % (name,))
        self.params_initialized = True

    def get_params(self):
        """``(arg_params, aux_params)``: copies, which later steps leave
        as they are."""
        self._check_ready()
        self._flush_pending()
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: v.copy() for n, v in self._exec.aux_dict.items()}
        return arg, aux

    # ----------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer and its ``Updater``.  ``kvstore`` may be a
        local type (or a local ``KVStore``), which all mean the one-device
        update here, or None; a distributed type raises."""
        self._check_ready()
        if self.optimizer_initialized and not force_init:
            return
        kv_type = kvstore if isinstance(kvstore, str) or kvstore is None \
            else getattr(kvstore, "type", None)
        if kv_type in _DIST_TYPES:
            raise ValueError("kvstore=%r: Module has no parameter-server "
                             "path; the distributed stores are not ported"
                             % (kv_type,))
        if kv_type is not None and kv_type not in _LOCAL_TYPES:
            raise ValueError("kvstore=%r is not a recognized mode; expected "
                             "one of %s or None"
                             % (kv_type, list(_LOCAL_TYPES)))
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **dict(optimizer_params))
        # as the reference: the names go to ``param_idx2name`` and the
        # optimizer's idx2name stays as created, so every parameter takes
        # the optimizer's wd (biases too)
        optimizer.param_idx2name = dict(enumerate(self._param_names))
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self._fused_state = {}
        self._fused_t = 0
        self.optimizer_initialized = True

    # ------------------------------------------------------ fused train step
    def _fused_active(self):
        """Whether the next forward_backward + update may run as one fused
        step (the module docstring lists the conditions)."""
        if not (self.binded and self.optimizer_initialized
                and self.for_training) or type(self) is not Module:
            return False
        if self._inputs_need_grad or \
                not getattr(self._optimizer, "jit_safe", False):
            return False
        req = self._exec.grad_req
        wrt = [n for n, r in req.items() if r != "null"]
        if not wrt or any(req[n] != "write" for n in wrt):
            return False
        from .. import engine as _engine
        return _engine.fused_step_allowed() \
            and _config.get("module.fused_step") != "off"

    def _flush_pending(self):
        """Replay a deferred batch through the eager forward + backward,
        so that what is observed before ``update`` is the reference's
        stage-at-a-time state."""
        batch = self._pending_batch
        if batch is None:
            return
        self._pending_batch = None
        _telemetry.counter("module.eager_replays").inc()
        BaseModule.forward_backward(self, batch)

    def _feeds(self, data_batch):
        """``{name: tensor}`` of the batch's data and labels, on the
        executor's device."""
        dev = self._exec._device
        pairs = list(zip(self._data_shapes, data_batch.data))
        if self._label_shapes and data_batch.label:
            pairs += list(zip(self._label_shapes, data_batch.label))
        return {name: (arr._data if isinstance(arr, NDArray)
                       else torch.as_tensor(arr)).to(dev)
                for (name, _), arr in pairs}

    def _run_fused(self, data_batch):
        """One fused step (``Executor.fused_step_fn``): forward, backward
        and the in-place update of every trainable parameter."""
        exec_ = self._exec
        optimizer = self._optimizer
        feeds = self._feeds(data_batch)
        exec_._feed_inputs(feeds)  # arg_dict matches the eager route's
        req = exec_.grad_req
        wrt = tuple(sorted(n for n in exec_.arg_dict
                           if req.get(n, "null") != "null"))
        feed_sig = tuple((n, tuple(v.shape), str(v.dtype))
                         for n, v in sorted(feeds.items()))
        fn = exec_.fused_step_fn(wrt, optimizer, feed_sig)
        idxs = tuple(self._param_names.index(n) for n in wrt)
        state = self._fused_state
        for n, i in zip(wrt, idxs):
            if n not in state:
                state[n] = optimizer.create_state(
                    i, exec_.arg_dict[n]._data)
        # one step count for every parameter; eager steps taken before
        # fusion began count too, and the Updater's counts agree after
        self._fused_t = max(self._fused_t, optimizer.num_update) + 1
        t = self._fused_t
        optimizer.num_update = max(optimizer.num_update, t)
        for i in idxs:
            optimizer._index_update_count[i] = t
        lrs = [optimizer._get_lr(i) for i in idxs]
        wds = [optimizer._get_wd(i) for i in idxs]
        # t is a Python int, as on the eager route: Adam's bias correction
        # is then the same on both routes (the reference's jitted step
        # takes it in f32 from a traced int32, 6e-6 away: 1 - 0.999 in f32)
        outs, aux_updates = fn(feeds, state, t, lrs, wds)
        for n, v in aux_updates.items():
            if n in exec_.aux_dict:
                exec_.aux_dict[n]._data = v
        exec_.outputs = [_wrap(o) for o in outs]
        _telemetry.counter("fused_steps").inc()

    def _check_unported(self):
        for knob, what in _UNPORTED_KNOBS.items():
            if _config.get(knob):
                raise NotImplementedError(
                    "%s (%s=%r) is not ported: Module cannot honour it"
                    % (what, knob, _config.get(knob)))

    # ------------------------------------------------------------- running
    def forward_backward(self, data_batch):
        self._check_unported()
        if self._fused_active():
            # a second deferral without update(): the first batch's
            # outputs and aux write-backs land first, in order
            self._flush_pending()
            self._pending_batch = data_batch
            return
        super().forward_backward(data_batch)

    def forward(self, data_batch, is_train=None):
        self._check_ready()
        self._flush_pending()
        if is_train is None:
            is_train = self.for_training
        self._exec.forward(is_train=is_train, **self._feeds(data_batch))

    def backward(self, out_grads=None):
        self._check_ready()
        self._flush_pending()
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer (reference ``module.py:646``): a deferred
        batch runs as one fused step, else the ``Updater`` updates each
        parameter from ``grad_dict``."""
        if not self.optimizer_initialized:
            raise RuntimeError("init_optimizer() first")
        self._check_unported()
        batch = self._pending_batch
        if batch is not None:
            self._pending_batch = None
            self._run_fused(batch)
            return
        _telemetry.counter("eager_steps").inc()
        for i, name in enumerate(self._param_names):
            g = self._exec.grad_dict.get(name)
            if g is not None:
                self._updater(i, g, self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        self._flush_pending()
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        if not self._inputs_need_grad:
            raise RuntimeError("bind(inputs_need_grad=True) first")
        self._flush_pending()
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._flush_pending()
        eval_metric.update_dict(
            {n: lab for (n, _), lab in zip(self._label_shapes, labels)}
            if self._label_shapes else {},
            dict(zip(self._symbol.list_outputs(), self._exec.outputs)))

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return [(n, tuple(o.shape)) for n, o in
                zip(self._symbol.list_outputs(), self._exec.outputs)]

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json`` and ``prefix-%04d.params``; optimizer
        states are not saved yet (asking for them raises)."""
        if save_optimizer_states:
            raise NotImplementedError("optimizer states in checkpoints are "
                                      "not ported")
        from ..model import save_checkpoint
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
