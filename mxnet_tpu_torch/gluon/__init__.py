"""Gluon (counterpart of ``mxnet_tpu.gluon``): Blocks, Parameters, the
layers, the losses, the utilities, the model zoo and the imperative
``Trainer`` (``parallel.SPMDTrainer`` trains a Block as one functional
step).  ``data``, ``rnn`` and ``contrib`` are not ported yet."""
from . import parameter, block, trainer  # noqa: F401
from .parameter import Parameter, ParameterDict, Constant  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, loss, utils, model_zoo  # noqa: F401
