"""Contrib datasets and samplers (counterpart of
``mxnet_tpu.gluon.contrib.data``; reference
``python/mxnet/gluon/contrib/data/``)."""
from .sampler import IntervalSampler  # noqa: F401
from .text import WikiText2, WikiText103  # noqa: F401

__all__ = ["IntervalSampler", "WikiText2", "WikiText103"]
