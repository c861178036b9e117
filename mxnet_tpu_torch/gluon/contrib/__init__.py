"""Contrib blocks (counterpart of ``mxnet_tpu.gluon.contrib``; reference
``python/mxnet/gluon/contrib/``).  ``rnn``, ``cnn`` and ``data`` are
ported; ``nn`` and ``estimator`` are not yet."""
from . import rnn, cnn, data  # noqa: F401
