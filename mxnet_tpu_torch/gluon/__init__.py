"""Gluon (counterpart of ``mxnet_tpu.gluon``): Blocks, Parameters, the
layers, the losses and the model zoo.  The Gluon ``Trainer`` is not
ported yet; ``parallel.SPMDTrainer`` trains a Block."""
from .parameter import Parameter, ParameterDict  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from . import nn, loss, model_zoo  # noqa: F401
