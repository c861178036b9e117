"""Losses (counterpart of ``mxnet_tpu.gluon.loss``): the ``Loss`` base
and the reference's eighteen losses, each the reference's expression
over the ``mx.nd`` ops.  ``CTCLoss`` takes the last class as the blank,
as the reference's layer does."""
from __future__ import annotations

import math

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]


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


class L2Loss(Loss):
    """``0.5 * (pred - label)^2`` (reference ``loss.py:90``)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L1Loss(Loss):
    """``|pred - label|`` (reference ``loss.py:135``)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of logits (the stable ``relu(x) - x*y +
    softplus(-|x|)``) or of probabilities, with an optional ``pos_weight``
    (reference ``loss.py:179``)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    F.Activation(-F.abs(pred), act_type="softrelu")
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = (pred - pred * label + log_weight
                        * (F.Activation(-F.abs(pred), act_type="softrelu")
                           + F.relu(-pred)))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight)
                         + F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` log-probabilities unless
    ``from_logits=False`` (reference ``loss.py:344``)."""

    def __init__(self, from_logits=True, axis=-1, weight=None,
                 batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class CTCLoss(Loss):
    """Connectionist temporal classification over the ``CTCLoss`` op,
    the last class the blank (reference ``loss.py:404``)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        assert layout in ["NTC", "TNC"], \
            "Only 'NTC' and 'TNC' layouts for pred are supported. Got: %s" \
            % layout
        assert label_layout in ["NT", "TN"], \
            "Only 'NT' and 'TN' layouts for label are supported. Got: %s" \
            % label_layout
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, 0, 1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, 0, 1)
        loss = F.CTCLoss(pred, label, pred_lengths, label_lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None,
                         blank_label="last")
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Smoothed L1: quadratic below ``rho``, linear above (reference
    ``loss.py:469``)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)`` (reference ``loss.py:523``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label)^2`` (reference ``loss.py:572``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))`` for signed or binary labels
    (reference ``loss.py:621``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if self._label_format not in ["signed", "binary"]:
            raise ValueError("label_format can only be signed or binary, "
                             "recieved %s." % label_format)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class TripletLoss(Loss):
    """``max(|positive - pred|^2 - |negative - pred|^2 + margin, 0)``
    (reference ``loss.py:676``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, the Stirling term with
    ``compute_full`` (reference ``loss.py:724``)."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = _reshape_like(F, target, pred)
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling_factor = (target * F.log(target) - target
                               + 0.5 * F.log(2 * target * math.pi))
            stirling_factor = stirling_factor * (target > 1)
            loss = loss + stirling_factor
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` for label 1, ``max(0, cos - margin)`` otherwise
    (reference ``loss.py:784``)."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = _reshape_like(F, input1, input2)
        cos_dist = self._cosine_similarity(F, input1, input2)
        label = label.reshape((-1, 1))
        loss = F.where(label == 1, 1 - cos_dist,
                       F.relu(cos_dist - self._margin))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)

    def _cosine_similarity(self, F, x, y, axis=-1):
        x_norm = F.norm(x, axis=axis).reshape((-1, 1))
        y_norm = F.norm(y, axis=axis).reshape((-1, 1))
        x_dot_y = F.sum(x * y, axis=axis).reshape((-1, 1))
        eps_arr = F.full((1, 1), 1e-12, ctx=x.context)
        return x_dot_y / F.broadcast_maximum(x_norm * y_norm, eps_arr)
