"""Activation layers (counterpart of ``mxnet_tpu.gluon.nn.activations``):
``Activation`` ('relu', 'sigmoid', 'tanh', 'softrelu', 'softsign') and
the parametric ones over the ``LeakyReLU`` op (leaky, prelu, elu, selu,
gelu), and ``Swish``."""
from __future__ import annotations

from ..block import HybridBlock
from ...initializer import Constant

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


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


class LeakyReLU(HybridBlock):
    """``max(0, x) + alpha * min(0, x)`` (reference
    ``nn/activations.py:77``)."""

    def __init__(self, alpha, **kwargs):
        assert alpha >= 0, \
            "Slope coefficient for LeakyReLU must be no less than 0."
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope, one for all channels, 0.25 at
    first (reference ``nn/activations.py:117``)."""

    def __init__(self, alpha_initializer=Constant(0.25), **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    """Exponential linear unit (reference ``nn/activations.py:148``)."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled exponential linear unit (reference
    ``nn/activations.py:178``)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """Gaussian error linear unit (reference ``nn/activations.py:199``)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)`` (reference ``nn/activations.py:220``)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
