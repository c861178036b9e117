"""Contrib blocks (counterpart of ``mxnet_tpu.gluon.contrib``; reference
``python/mxnet/gluon/contrib/``).  ``rnn``, ``cnn``, ``data`` and
``nn`` are ported; ``estimator`` is not yet."""
from . import rnn, cnn, data, nn  # noqa: F401
