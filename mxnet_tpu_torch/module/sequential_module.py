"""``SequentialModule``: modules chained head to tail (counterpart of
``mxnet_tpu.module.sequential_module``).

Reference: ``python/mxnet/module/sequential_module.py``.  ``add`` takes
the ``take_labels`` and ``auto_wiring`` metas; ``bind`` and ``forward``
run the modules in order, each module's outputs the next one's data, and
``backward`` runs them in reverse, each module's input gradients the
previous one's ``out_grads``.  Every module after the first is bound
with ``inputs_need_grad``, so each runs its eager step.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from ..io import DataBatch

__all__ = ["SequentialModule"]


def _pairs(shapes):
    """``(name, shape)`` pairs from pairs or DataDescs (the reference's
    copy unpacks a DataDesc as a pair and fails on ``provide_data``)."""
    return [(s.name, tuple(s.shape)) if hasattr(s, "name")
            else (s[0], tuple(s[1])) for s in shapes]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        """Append a module; ``take_labels=True`` routes the chain's labels
        to it, ``auto_wiring=True`` renames the previous module's outputs
        to this module's data names (reference sequential_module.py:63)."""
        for key in kwargs:
            if key not in (self.META_TAKE_LABELS, self.META_AUTO_WIRING):
                raise ValueError("unknown meta %r" % key)
        self._modules.append(module)
        self._metas.append(dict(kwargs))
        self.binded = False
        self.params_initialized = False
        return self

    # ------------------------------------------------------------ plumbing
    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes or []

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if not self._modules:
            raise RuntimeError("add() at least one module before bind")
        if shared_module is not None:
            raise ValueError("shared_module is not supported by "
                             "SequentialModule")
        if self.binded and not force_rebind:
            return
        self._label_shapes = label_shapes
        cur_shapes = data_shapes
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            take_labels = meta.get(self.META_TAKE_LABELS, False)
            if meta.get(self.META_AUTO_WIRING, False) and i > 0:
                # previous outputs feed this module's data slots by order
                cur_shapes = [(name, shape) for name, (_, shape) in
                              zip(module.data_names, _pairs(cur_shapes))]
            module.bind(
                cur_shapes,
                label_shapes=label_shapes if take_labels else None,
                for_training=for_training,
                # interior modules must expose input grads so backward
                # chains through; the first honors the caller's choice
                inputs_need_grad=(inputs_need_grad if i == 0 else True),
                force_rebind=force_rebind, grad_req=grad_req)
            cur_shapes = self._infer_output_shapes(module, cur_shapes,
                                                   label_shapes
                                                   if take_labels else None)
        self.binded = True
        self.for_training = for_training

    @staticmethod
    def _infer_output_shapes(module, in_shapes, label_shapes):
        """Output shapes at BIND time (before any forward): prefer the
        module's own report, fall back to symbol shape inference."""
        try:
            shapes = module.output_shapes
            if shapes:
                return shapes
        except Exception:  # noqa: BLE001 — e.g. executor not run yet
            pass
        sym = getattr(module, "_symbol", None)
        if sym is None:
            raise ValueError(
                "cannot infer output shapes of %r at bind time"
                % type(module).__name__)
        known = dict(_pairs(list(in_shapes) + list(label_shapes or [])))
        _, out_shapes, _ = sym.infer_shape(**known)
        return list(zip(sym.list_outputs(), out_shapes))

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if not self.binded:
            raise RuntimeError("bind() first")
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params, aux_params=aux_params,
                               allow_missing=True, force_init=force_init,
                               allow_extra=True)
        self.params_initialized = True

    def get_params(self):
        arg, aux = {}, {}
        for module in self._modules:
            a, x = module.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init,
                         allow_extra=allow_extra)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    # ------------------------------------------------------------- compute
    def forward(self, data_batch, is_train=None):
        self._check_ready()
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            # outputs become the next module's data; labels ride along so
            # a take_labels module downstream can consume them
            batch = DataBatch(module.get_outputs(), data_batch.label)

    def backward(self, out_grads=None):
        self._check_ready()
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        if not self.optimizer_initialized:
            raise RuntimeError("init_optimizer() first")
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        # every take_labels module contributes (reference dispatches to all
        # META_TAKE_LABELS modules, module/sequential_module.py); only when
        # none is flagged does the tail module report
        any_taken = False
        for module, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels, pre_sliced)
                any_taken = True
        if not any_taken:
            self._modules[-1].update_metric(eval_metric, labels, pre_sliced)
