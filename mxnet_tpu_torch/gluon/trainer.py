"""Trainer — applies an Optimizer to a set of Parameters (counterpart of
``mxnet_tpu.gluon.trainer``).

Reference: ``python/mxnet/gluon/trainer.py:27``.  The imperative Gluon
loop: ``loss.backward()`` under ``autograd.record()`` fills each
Parameter's grad buffer, and ``step(batch_size)`` sets
``rescale_grad = scale / batch_size``, reduces the gradients through the
kvstore (``push`` then ``pull``; the identity on one device) and runs the
optimizer's ``Updater`` on every Parameter whose ``grad_req`` is not
``'null'``, in the order of the sorted Parameter names.  On one device
``update_on_kvstore`` defaults to False, as the reference's
``_create_kvstore`` decides.

Not ported, and raising ``NotImplementedError`` when asked for: gradient
compression, the nanguard and numerics-capture knobs
(``resilience.nanguard``, ``numerics.capture``), ``set_preemption_save``,
and ``save_states`` / ``load_states`` (files).
"""
from __future__ import annotations

from .. import config as _config
from .. import optimizer as opt
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
        if compression_params is not None:
            raise NotImplementedError(
                "gradient compression is not ported (compression_params)")
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    "got list of %s." % (type(param)))
            self._param2idx[param.name] = i
            self._params.append(param)
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._params_to_init = list(self._params)

    def set_preemption_save(self, fn):
        raise NotImplementedError(
            "preemption saves are not ported (set_preemption_save)")

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
                # one device: update locally (reference model.py
                # _create_kvstore)
                update_on_kvstore = False
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
                                       param.data())
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

    @staticmethod
    def _check_options():
        for knob in ("resilience.nanguard", "numerics.capture"):
            if _config.get(knob):
                raise NotImplementedError(
                    "gluon.Trainer does not port %s" % knob)

    def step(self, batch_size, ignore_stale_grad=False):
        """One parameter update (reference ``trainer.py:305``): gradients
        rescaled by ``1 / batch_size``, reduced, then applied."""
        self._check_options()
        rescale_grad = self._scale / batch_size
        self._check_and_rescale_grad(rescale_grad)
        self._ready()
        self._allreduce_grads()
        self._update(ignore_stale_grad)

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
        if not self._kvstore:
            return
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if self._update_on_kvstore:
                self._kvstore.pushpull(i, param.grad(), out=param.data(),
                                       priority=-i)
            else:
                grads = param.list_grad()
                self._kvstore.push(i, grads, priority=-i)
                self._kvstore.pull(i, grads, priority=-i)

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply already-reduced gradients (reference ``trainer.py:374``)."""
        self._check_options()
        self._ready()
        if self._kvstore and self._update_on_kvstore:
            raise RuntimeError(
                "update() when parameters are updated on kvstore is not "
                "supported. Try setting `update_on_kvstore` to False when "
                "creating trainer.")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        if self._kvstore and self._update_on_kvstore:
            return
        updater = self._updaters[0]
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            updater(i, param.grad(), param.data())

    def save_states(self, fname):
        raise NotImplementedError(
            "Trainer.save_states is not ported (optimizer states to a "
            "file); Updater.get_states gives them as bytes")

    def load_states(self, fname):
        raise NotImplementedError(
            "Trainer.load_states is not ported (optimizer states from a "
            "file); Updater.set_states takes them as bytes")
