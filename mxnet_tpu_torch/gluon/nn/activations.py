"""Activation layers (counterpart of ``mxnet_tpu.gluon.nn.activations``):
``Activation`` ('relu', 'sigmoid', 'tanh', 'softrelu', 'softsign').  The
parametric activations are not ported yet."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    """Applies an activation function (reference
    ``nn/activations.py:30``)."""

    def __init__(self, activation, **kwargs):
        # the prefix counter's hint is the activation's name: set it first
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._act_type)
