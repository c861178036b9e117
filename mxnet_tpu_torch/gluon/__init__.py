"""Gluon (counterpart of ``mxnet_tpu.gluon``): Blocks, Parameters, the
layers, the losses, the model zoo and the imperative ``Trainer``
(``parallel.SPMDTrainer`` trains a Block as one functional step)."""
from .parameter import Parameter, ParameterDict  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, loss, model_zoo  # noqa: F401
