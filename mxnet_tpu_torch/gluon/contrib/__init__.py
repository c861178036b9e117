"""Contrib blocks (counterpart of ``mxnet_tpu.gluon.contrib``; reference
``python/mxnet/gluon/contrib/``).  Only ``rnn`` is ported; ``nn``,
``cnn``, ``data`` and ``estimator`` are not yet."""
from . import rnn  # noqa: F401
