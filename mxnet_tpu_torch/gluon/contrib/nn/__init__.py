"""Contrib layers (counterpart of ``mxnet_tpu.gluon.contrib.nn``;
reference ``python/mxnet/gluon/contrib/nn/basic_layers.py``)."""
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__  # noqa: F401
