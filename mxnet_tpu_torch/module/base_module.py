"""BaseModule — the training-loop contract (counterpart of
``mxnet_tpu.module.base_module``).

Reference: ``python/mxnet/module/base_module.py``: ``fit`` (:409-530)
runs bind -> init_params -> init_optimizer -> per batch
``train_step`` (forward_backward + update) and ``update_metric``;
``score``, ``predict`` and ``iter_predict`` evaluate.  ``train_step``
checks the nanguard's abort first and runs under
``telemetry.step_scope("module")`` and the ``module.step`` span; ``fit``
installs a ``monitor`` on the executor (``tic`` / ``toc_print`` around
each step) and finishes a pending preemption after the step in flight
(``resilience.on_preempt=save_and_exit``: the epoch-end callbacks
checkpoint, then the process exits 0).
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from .. import telemetry as _telemetry
from .. import tracing as _tracing

__all__ = ["BaseModule"]


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ------------------------------------------------------------ abstract
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    # ------------------------------------------------------------ concrete
    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def train_step(self, data_batch):
        """One optimization step on ``data_batch``: forward_backward then
        update (one fused step in ``Module`` when it may run fused).  Each
        step feeds the ``module.step`` telemetry timer (host seconds), one
        JSONL step record when the step log is on, and opens the
        ``module.step`` span.  Under ``resilience.nanguard`` the abort
        (``NonFiniteStepError``) lands here, at the start of a step after
        the device reported the streak."""
        from .. import resilience as _resilience
        _resilience.maybe_abort_nonfinite("module")
        with _telemetry.step_scope("module", batch=data_batch), \
                _tracing.span("module.step", cat="module"):
            self.forward_backward(data_batch)
            self.update()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """The training loop (reference ``base_module.py:409-530``)."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        from .. import resilience as _resilience
        from ..callback import BatchEndParam
        from ..initializer import Uniform
        if initializer is None:
            initializer = Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params,
                            force_init=force_init)
        eval_metric = metric_mod.create(eval_metric)
        if validation_metric is None:
            validation_metric = eval_metric
        if monitor is not None and getattr(self, "_exec", None) is not None:
            # the reference installs the monitor on every executor at bind
            monitor.install(self._exec)
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.train_step(data_batch)
                if monitor is not None:
                    monitor.toc_print()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(params)
                if _resilience.preempt_requested():
                    # the step in flight is done: checkpoint through the
                    # epoch-end callbacks, flush, exit 0
                    if epoch_end_callback is not None:
                        arg_params, aux_params = self.get_params()
                        for cb in _as_list(epoch_end_callback):
                            cb(epoch, self.symbol, arg_params, aux_params)
                    _resilience.exit_on_preempt(logger=self.logger)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_params, aux_params = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params, aux_params)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None,
              reset=True, epoch=0, sparse_row_id_fn=None):
        """``eval_metric`` over ``eval_data`` (inference forwards);
        returns its name-value pairs."""
        from ..callback import BatchEndParam
        self._check_ready()
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(params)
        if score_end_callback is not None:
            params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                   eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True,
                     sparse_row_id_fn=None):
        """Yield ``(outputs, nbatch, batch)`` per batch, the pad
        stripped."""
        self._check_ready()
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            outs = self.get_outputs()
            if batch.pad:
                outs = [o[:o.shape[0] - batch.pad] for o in outs]
            yield outs, nbatch, batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """The outputs over ``eval_data``, the pad stripped; merged along
        the batch axis unless ``merge_batches`` is False."""
        outputs = [outs for outs, _, _ in self.iter_predict(
            eval_data, num_batch=num_batch, reset=reset)]
        if not outputs:
            return []
        if merge_batches:
            from ..ndarray import concat
            merged = [concat(*[b[i] for b in outputs], dim=0)
                      for i in range(len(outputs[0]))]
            if len(merged) == 1 and not always_output_list:
                return merged[0]
            return merged
        return outputs

    def _check_ready(self):
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind() and init_params() first")

    def save_params(self, fname):
        from ..model import pack_params
        from ..ndarray.ndarray import save
        arg_params, aux_params = self.get_params()
        save(fname, pack_params(arg_params, aux_params))

    def load_params(self, fname):
        from ..model import unpack_params
        from ..ndarray.ndarray import load
        arg_params, aux_params = unpack_params(load(fname))
        self.set_params(arg_params, aux_params)
