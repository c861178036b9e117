"""Contrib blocks (counterpart of ``mxnet_tpu.gluon.contrib``; reference
``python/mxnet/gluon/contrib/``).  ``rnn`` and ``data`` are ported;
``nn``, ``cnn`` and ``estimator`` are not yet."""
from . import rnn, data  # noqa: F401
