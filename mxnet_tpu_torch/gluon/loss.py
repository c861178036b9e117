"""Losses (counterpart of ``mxnet_tpu.gluon.loss``): the ``Loss`` base
and ``SoftmaxCrossEntropyLoss``.  The other losses are not ported yet."""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """Scale by ``sample_weight`` (broadcast) and the scalar ``weight``
    (reference ``loss.py:36``)."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        assert isinstance(weight, (float, int)), "weight must be a number"
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape)


class Loss(HybridBlock):
    """Base class of the losses (reference ``loss.py:59``)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (self.__class__.__name__,
                                            self._batch_axis, self._weight)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax + cross-entropy with sparse (class index, float) or dense
    labels; a per-example loss, the mean over the non-batch axes
    (reference ``loss.py:268``)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
