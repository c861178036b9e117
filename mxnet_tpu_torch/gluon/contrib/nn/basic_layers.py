"""Contrib layers (counterpart of
``mxnet_tpu.gluon.contrib.nn.basic_layers``): Concurrent,
HybridConcurrent, Identity, SparseEmbedding, SyncBatchNorm and
PixelShuffle1D/2D/3D, under the reference's names and signatures.

``SyncBatchNorm`` is ``BatchNorm`` with ``num_devices`` accepted and
unused, as in the reference: its statistics are the global batch's
wherever every BatchNorm's are, inside a multi-rank
``parallel.SPMDTrainer`` step (``ops.nn.set_batch_stats_context``), and
this rank's own elsewhere (an imperative ``gluon.Trainer`` over the dist
kvstore, say), as the reference's are outside its batch-sharded
program.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import BatchNorm, Embedding, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class Concurrent(Sequential):
    """Runs its Blocks on the same input and concatenates their outputs
    along ``axis`` (reference ``contrib/nn/basic_layers.py:34``)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as F
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Runs its HybridBlocks on the same input and concatenates their
    outputs along ``axis`` (reference ``contrib/nn/basic_layers.py:70``)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    """Returns its input (reference ``contrib/nn/basic_layers.py:106``)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Embedding):
    """``Embedding`` whose weight's gradient is row-sparse
    (``sparse_grad=True``; reference ``contrib/nn/basic_layers.py:130``)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer,
                         sparse_grad=True, **kwargs)


class SyncBatchNorm(BatchNorm):
    """BatchNorm over the batch of every device (reference
    ``contrib/nn/basic_layers.py:184``); ``num_devices`` is accepted and
    unused (module doc)."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)


def _factors(factor, n):
    try:
        return (int(factor),) * n
    except TypeError:
        out = tuple(int(f) for f in factor)
        assert len(out) == n, "wrong length {}".format(len(out))
        return out


class PixelShuffle1D(HybridBlock):
    """``(N, C*f, W) -> (N, C, W*f)`` (reference
    ``contrib/nn/basic_layers.py:263``)."""

    def __init__(self, factor):
        super().__init__()
        self._factor = int(factor)

    def hybrid_forward(self, F, x):
        f = self._factor
        n, c, w = x.shape
        x = F.reshape(x, shape=(n, c // f, f, w))
        x = F.transpose(x, axes=(0, 1, 3, 2))
        return F.reshape(x, shape=(n, c // f, w * f))

    def __repr__(self):
        return "{}({})".format(self.__class__.__name__, self._factor)


class PixelShuffle2D(HybridBlock):
    """``(N, C*f1*f2, H, W) -> (N, C, H*f1, W*f2)`` (reference
    ``contrib/nn/basic_layers.py:305``)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = _factors(factor, 2)

    def hybrid_forward(self, F, x):
        f1, f2 = self._factors
        n, c, h, w = x.shape
        x = F.reshape(x, shape=(n, c // (f1 * f2), f1, f2, h, w))
        x = F.transpose(x, axes=(0, 1, 4, 2, 5, 3))
        return F.reshape(x, shape=(n, c // (f1 * f2), h * f1, w * f2))

    def __repr__(self):
        return "{}({})".format(self.__class__.__name__, self._factors)


class PixelShuffle3D(HybridBlock):
    """``(N, C*f1*f2*f3, D, H, W) -> (N, C, D*f1, H*f2, W*f3)`` (reference
    ``contrib/nn/basic_layers.py:357``)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = _factors(factor, 3)

    def hybrid_forward(self, F, x):
        f1, f2, f3 = self._factors
        n, c, d, h, w = x.shape
        x = F.reshape(x, shape=(n, c // (f1 * f2 * f3), f1, f2, f3, d, h,
                                w))
        x = F.transpose(x, axes=(0, 1, 5, 2, 6, 3, 7, 4))
        return F.reshape(x, shape=(n, c // (f1 * f2 * f3), d * f1, h * f2,
                                   w * f3))

    def __repr__(self):
        return "{}({})".format(self.__class__.__name__, self._factors)
