"""Contrib CNN layers (counterpart of ``mxnet_tpu.gluon.contrib.cnn``;
reference ``python/mxnet/gluon/contrib/cnn/``)."""
from .conv_layers import DeformableConvolution  # noqa: F401

__all__ = ["DeformableConvolution"]
