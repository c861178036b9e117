"""``PythonModule`` and ``PythonLossModule``: modules computed by user
Python (counterpart of ``mxnet_tpu.module.python_module``).

Reference: ``python/mxnet/module/python_module.py``.  A ``PythonModule``
has no parameters and its compute is the subclass's own code; a
``PythonLossModule`` is a loss head whose ``backward`` supplies the
gradient fed to the module below it in a ``SequentialModule`` (the
custom-loss escape hatch).
"""
from __future__ import annotations

import logging

import numpy as _np

from .base_module import BaseModule
from ..ndarray.ndarray import NDArray, array

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """A module implemented in Python: subclasses override
    ``_compute_output_shapes`` (and usually ``forward``)."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # ----------------------------------------------------------- metadata
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes or []

    @property
    def output_shapes(self):
        return self._output_shapes

    # ------------------------------------------------------------- params
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if not self.binded:
            raise RuntimeError("bind() first")
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if self._label_shapes:
            eval_metric.update_dict(
                {n: l for (n, _), l in zip(self._label_shapes, labels)},
                dict(zip(self._output_names, self.get_outputs())))

    # --------------------------------------------------------------- bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self._data_shapes = [tuple(d) if isinstance(d, (list, tuple))
                             else (d.name, d.shape) for d in data_shapes]
        self._label_shapes = ([tuple(d) if isinstance(d, (list, tuple))
                               else (d.name, d.shape)
                               for d in label_shapes]
                              if label_shapes else None)
        self._output_shapes = self._compute_output_shapes()
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    def _compute_output_shapes(self):
        """Subclass hook: output shapes from self._data_shapes /
        self._label_shapes (reference python_module.py:160)."""
        raise NotImplementedError


class PythonLossModule(PythonModule):
    """A Python loss head: forward is (by default) identity on its single
    input; backward supplies the hand-written gradient
    (reference python_module.py:191)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise ValueError("PythonLossModule is a terminal loss head: "
                             "backward takes no out_grads")
        if not self.for_training:
            raise RuntimeError("backward needs bind(for_training=True)")
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, NDArray):
                grad = array(_np.asarray(grad),
                             ctx=self._scores._data.device)
            self._scores_grad = grad
        else:
            raise NotImplementedError(
                "pass grad_func to PythonLossModule or override backward")

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
