"""BucketingModule — variable-length training with one Module a bucket
(counterpart of ``mxnet_tpu.module.bucketing_module``).

Reference: ``python/mxnet/module/bucketing_module.py:40``: ``sym_gen``
builds one graph a bucket key, each bound in its own Module, and every
bucket trains the same parameters through one optimizer.

Here the buckets share the parameters outright: a bucket Module's
parameter and aux NDArrays ARE the default bucket's (``_share_params``),
so a bucket switch copies nothing and an update, in place on those
tensors, is what every bucket reads next.  The reference instead copies
every parameter into the bucket at each switch and back out at each
update; the numbers are the same.  One optimizer, its ``Updater`` and
the fused route's state (``module.FusedState``: the per-name moments and
the step count) serve every bucket, so a switch keeps Adam's moments and
its count.  ``context`` (one, or a list: the first carries the batch)
and ``group2ctxs`` go to every bucket's Module.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise ValueError("default_bucket_key is required")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._work_load_list = work_load_list
        self._group2ctxs = group2ctxs
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None

    def _gen_module(self, bucket_key, data_shapes, label_shapes):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        mod = Module(sym, data_names, label_names, logger=self.logger,
                     context=self._context,
                     work_load_list=self._work_load_list,
                     fixed_param_names=self._fixed_param_names,
                     group2ctxs=self._group2ctxs)
        mod.bind(data_shapes, label_shapes,
                 for_training=self.for_training)
        return mod

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        mod = self._gen_module(self._default_bucket_key, data_shapes,
                               label_shapes)
        self._buckets = {self._default_bucket_key: mod}
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def _share_params(self, mod):
        """Bind ``mod``'s parameters and aux states to the default bucket's
        NDArrays.  A parameter the default bucket lacks raises, as the
        reference's set-params-only copy does."""
        default = self._buckets[self._default_bucket_key]
        for names, pool, shared in (
                (mod._param_names, mod._exec.arg_dict,
                 default._exec.arg_dict),
                (mod._aux_names, mod._exec.aux_dict,
                 default._exec.aux_dict)):
            for name in names:
                if name not in shared:
                    raise ValueError("bucket parameter %r is not in the "
                                     "default bucket's graph" % (name,))
                if tuple(shared[name].shape) != tuple(pool[name].shape):
                    raise ValueError(
                        "bucket parameter %r has shape %s, the default "
                        "bucket's %s" % (name, tuple(pool[name].shape),
                                         tuple(shared[name].shape)))
                pool[name] = shared[name]
        mod.params_initialized = default.params_initialized

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Select (creating on first use) the Module of ``bucket_key``,
        which shares the default bucket's parameters."""
        if not self.binded:
            raise RuntimeError("bind() first")
        if bucket_key not in self._buckets:
            mod = self._gen_module(bucket_key, data_shapes, label_shapes)
            self._share_params(mod)
            if self.optimizer_initialized:
                self._share_optimizer(mod)
            self._buckets[bucket_key] = mod
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer="default", arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if not self.binded:
            raise RuntimeError("bind() first")
        if self.params_initialized and not force_init:
            return
        self._buckets[self._default_bucket_key].init_params(
            initializer, arg_params, aux_params, allow_missing, force_init,
            allow_extra)
        for mod in self._buckets.values():
            mod.params_initialized = True
        self.params_initialized = True

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """ONE optimizer, updater and fused-route state for every bucket
        (reference ``bucketing_module.py:40``)."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind() and init_params() first")
        if self.optimizer_initialized and not force_init:
            return
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(kvstore, optimizer, optimizer_params,
                               force_init)
        for key, mod in self._buckets.items():
            if key != self._default_bucket_key:
                self._share_optimizer(mod)
        self.optimizer_initialized = True

    def _share_optimizer(self, mod):
        default = self._buckets[self._default_bucket_key]
        mod._optimizer = default._optimizer
        mod._updater = default._updater
        mod._fused_shared = default._fused_shared
        mod.optimizer_initialized = True

    def _switch_to(self, data_batch):
        prev = self._curr_module
        key = getattr(data_batch, "bucket_key", None)
        if key is None:
            key = self._default_bucket_key
        self.switch_bucket(key, data_batch.provide_data,
                           data_batch.provide_label)
        if prev is not None and prev is not self._curr_module:
            # a batch deferred on another bucket replays before that
            # bucket is left
            prev._flush_pending()

    def forward_backward(self, data_batch):
        # whole pairs go to the bucket's Module, so its fused step runs
        if not self.binded:
            raise RuntimeError("bind() first")
        self._switch_to(data_batch)
        self._curr_module.forward_backward(data_batch)

    def forward(self, data_batch, is_train=None):
        if not self.binded:
            raise RuntimeError("bind() first")
        self._switch_to(data_batch)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)
