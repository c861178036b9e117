"""Evaluation metrics (counterpart of ``mxnet_tpu.metric``, kept as its
own copy: the metric arithmetic is host numpy).

Capability parity with ``python/mxnet/metric.py`` (EvalMetric registry:
Accuracy/TopK/F1/MCC/MAE/MSE/RMSE/CrossEntropy/NLL/Pearson/Perplexity/
Composite/Custom), re-designed around three pieces of shared machinery
instead of the reference's per-class accumulation fields:

* ``_Tally`` — one weighted-sum accumulator kept at two scopes (the
  resettable local window and the whole run), replacing the duplicated
  sum_metric/global_sum_metric bookkeeping;
* ``_Confusion`` — binary confusion COUNTS as 2x2 matrices per scope;
  precision/recall/F1/MCC are pure functions of a matrix;
* ``EvalMetric.update`` iterates (label, pred) pairs once and defers the
  per-pair math to ``_measure``, so most metrics are a single method.

Metric math runs on host numpy: updates are small reductions over already
materialized outputs, so keeping them off-device avoids recompiles and
device syncs in the training hot loop.
"""
from __future__ import annotations

import math

import numpy

from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "PCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register"]

_METRIC_REGISTRY = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _alias(*names):
    def deco(klass):
        for n in names:
            _METRIC_REGISTRY[n.lower()] = klass
        return klass
    return deco


def create(metric, *args, **kwargs):
    """Create a metric from a name, callable, list, or instance."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        bundle = CompositeEvalMetric()
        for item in metric:
            bundle.add(create(item, *args, **kwargs))
        return bundle
    if isinstance(metric, str):
        klass = _METRIC_REGISTRY.get(metric.lower())
        if klass is None:
            raise ValueError("unknown metric %r (registered: %s)"
                             % (metric, sorted(_METRIC_REGISTRY)))
        return klass(*args, **kwargs)
    raise TypeError("metric should be str, callable, list or EvalMetric")


def _host(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Validate that label/pred collections (or arrays) line up."""
    a = labels.shape if shape else len(labels)
    b = preds.shape if shape else len(preds)
    if a != b:
        raise ValueError("labels %s do not match predictions %s" % (a, b))
    if wrap:
        labels = [labels] if isinstance(labels, NDArray) else labels
        preds = [preds] if isinstance(preds, NDArray) else preds
    return labels, preds


def _paired(labels, preds):
    """Yield (label, pred) numpy pairs from parallel collections."""
    if isinstance(labels, NDArray):
        labels = [labels]
    if isinstance(preds, NDArray):
        preds = [preds]
    if len(labels) != len(preds):
        raise ValueError("got %d labels for %d predictions"
                         % (len(labels), len(preds)))
    for label, pred in zip(labels, preds):
        yield _host(label), _host(pred)


class _Tally:
    """A weighted sum kept at two scopes: the resettable window ('local'
    in the reference API) and the whole run ('global')."""

    __slots__ = ("wsum", "n", "run_wsum", "run_n")

    def __init__(self):
        self.clear_all()

    def add(self, value, weight):
        self.wsum += value
        self.n += weight
        self.run_wsum += value
        self.run_n += weight

    def mean(self):
        return self.wsum / self.n if self.n else float("nan")

    def run_mean(self):
        return self.run_wsum / self.run_n if self.run_n else float("nan")

    def clear_window(self):
        self.wsum = 0.0
        self.n = 0

    def clear_all(self):
        self.wsum = 0.0
        self.n = 0
        self.run_wsum = 0.0
        self.run_n = 0


class EvalMetric:
    """Base metric.  Reference API surface (metric.py:43): update/
    update_dict, get/get_global, get_name_value, reset/reset_local; the
    accumulator behind it is a `_Tally` exposed through compatibility
    properties (sum_metric & co.)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._has_global_stats = kwargs.pop("has_global_stats", False)
        self._kwargs = kwargs
        self._tally = _Tally()
        self.reset()

    # -- compatibility accessors onto the tally ---------------------------
    @property
    def sum_metric(self):
        return self._tally.wsum

    @sum_metric.setter
    def sum_metric(self, v):
        self._tally.wsum = v

    @property
    def num_inst(self):
        return self._tally.n

    @num_inst.setter
    def num_inst(self, v):
        self._tally.n = v

    @property
    def global_sum_metric(self):
        return self._tally.run_wsum

    @global_sum_metric.setter
    def global_sum_metric(self, v):
        self._tally.run_wsum = v

    @property
    def global_num_inst(self):
        return self._tally.run_n

    @global_num_inst.setter
    def global_num_inst(self, v):
        self._tally.run_n = v

    # ---------------------------------------------------------------------
    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = dict(self._kwargs)
        config.update(metric=self.__class__.__name__, name=self.name,
                      output_names=self.output_names,
                      label_names=self.label_names)
        return config

    def update_dict(self, label, pred):
        pred = ([pred[n] for n in self.output_names]
                if self.output_names is not None else list(pred.values()))
        label = ([label[n] for n in self.label_names]
                 if self.label_names is not None else list(label.values()))
        self.update(label, pred)

    def update(self, labels, preds):
        """Default path: per-pair `_measure` -> weighted tally."""
        for label, pred in _paired(labels, preds):
            value, weight = self._measure(label, pred)
            self._tally.add(value, weight)

    def _measure(self, label, pred):
        """Return (value_sum, weight) for one label/pred pair."""
        raise NotImplementedError()

    def reset(self):
        self._tally.clear_all()

    def reset_local(self):
        self._tally.clear_window()

    def get(self):
        return (self.name, self._tally.mean())

    def get_global(self):
        if self._has_global_stats:
            return (self.name, self._tally.run_mean())
        return self.get()

    @staticmethod
    def _listify(pair):
        name, value = pair
        name = name if isinstance(name, list) else [name]
        value = value if isinstance(value, list) else [value]
        return list(zip(name, value))

    def get_name_value(self):
        return self._listify(self.get())

    def get_global_name_value(self):
        if self._has_global_stats:
            return self._listify(self.get_global())
        return self.get_name_value()

    # kept for subclasses/backwards-compat with the reference's protected API
    def _update(self, metric, inst):
        self._tally.add(metric, inst)


@register
@_alias("composite")
class CompositeEvalMetric(EvalMetric):
    """Several metrics updated and reported together."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError("metric index %d out of range [0, %d)"
                              % (index, len(self.metrics)))

    def update_dict(self, labels, preds):
        if self.label_names is not None:
            labels = dict(zip(self.label_names, labels))
        if self.output_names is not None:
            preds = dict(zip(self.output_names, preds))
        for m in self.metrics:
            m.update_dict(labels, preds)

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def reset_local(self):
        for m in getattr(self, "metrics", []):
            m.reset_local()

    def _collect(self, getter):
        names, values = [], []
        for m in self.metrics:
            for n, v in self._listify(getter(m)):
                names.append(n)
                values.append(v)
        return (names, values)

    def get(self):
        return self._collect(lambda m: m.get())

    def get_global(self):
        return self._collect(lambda m: m.get_global())

    def get_config(self):
        config = super().get_config()
        config["metrics"] = [m.get_config() for m in self.metrics]
        return config


@register
@_alias("acc")
class Accuracy(EvalMetric):
    """Fraction of samples whose argmax prediction equals the label."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.axis = axis

    def _measure(self, label, pred):
        if pred.ndim > label.ndim:
            pred = numpy.argmax(pred, axis=self.axis)
        pred = pred.astype("int64").ravel()
        label = label.astype("int64").ravel()
        check_label_shapes(label, pred)
        return float((pred == label).sum()), label.size


@register
@_alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    """Fraction of samples whose label lands in the k highest scores.

    Ties are broken toward LOWER class indices (matching a stable
    descending sort of the scores), so the result is deterministic.
    """

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        if top_k <= 1:
            raise ValueError("TopKAccuracy needs top_k > 1 "
                             "(k==1 is plain Accuracy)")
        super().__init__("%s_%d" % (name, top_k), top_k=top_k,
                         output_names=output_names, label_names=label_names,
                         has_global_stats=True)
        self.top_k = top_k

    def _measure(self, label, pred):
        if pred.ndim == 1:
            pred = pred[None, :]
        if pred.ndim != 2:
            raise ValueError("TopKAccuracy expects (N,) or (N, C) scores, "
                             "got %s" % (pred.shape,))
        label = label.astype("int64").ravel()
        if label.shape[0] != pred.shape[0]:
            raise ValueError("label/pred batch mismatch: %d vs %d"
                             % (label.shape[0], pred.shape[0]))
        k = min(self.top_k, pred.shape[1])
        # stable argsort on the negated scores -> deterministic tie-breaks
        ranked = numpy.argsort(-pred.astype("float64"), axis=1,
                               kind="stable")[:, :k]
        hits = (ranked == label[:, None]).any(axis=1)
        return float(hits.sum()), label.shape[0]


# ----------------------------------------------------------- confusion f1

def _confusion_precision(m):
    tp, fp = m[1, 1], m[0, 1]
    return tp / (tp + fp) if tp + fp else 0.0


def _confusion_recall(m):
    tp, fn = m[1, 1], m[1, 0]
    return tp / (tp + fn) if tp + fn else 0.0


def _confusion_f1(m):
    p, r = _confusion_precision(m), _confusion_recall(m)
    return 2 * p * r / (p + r) if p + r else 0.0


def _confusion_mcc(m):
    tn, fp, fn, tp = m[0, 0], m[0, 1], m[1, 0], m[1, 1]
    if not m.sum():
        return 0.0
    denom = 1.0
    for t in ((tp + fp), (tp + fn), (tn + fp), (tn + fn)):
        if t:
            denom *= t
    return (tp * tn - fp * fn) / math.sqrt(denom)


class _Confusion:
    """Binary confusion counts, rows=truth cols=decision, window + run."""

    def __init__(self):
        self.window = numpy.zeros((2, 2))
        self.run = numpy.zeros((2, 2))

    def observe(self, label, pred):
        label = label.astype("int64").ravel()
        decided = pred.argmax(axis=1).astype("int64").ravel() \
            if pred.ndim == 2 else (pred.ravel() > 0.5).astype("int64")
        if label.shape != decided.shape:
            raise ValueError("label/pred shape mismatch: %s vs %s"
                             % (label.shape, decided.shape))
        if label.min(initial=0) < 0 or label.max(initial=0) > 1:
            raise ValueError("binary metrics need labels in {0, 1}")
        counts = numpy.zeros((2, 2))
        numpy.add.at(counts, (label, decided), 1)
        self.window += counts
        self.run += counts

    def clear_window(self):
        self.window[:] = 0

    def clear_all(self):
        self.window[:] = 0
        self.run[:] = 0


class _ConfusionMetric(EvalMetric):
    """Shared frame for F1 and MCC: feed the confusion object, then either
    average per-batch scores (macro) or score the cumulative matrix
    (micro)."""

    _score = None  # staticmethod(matrix -> float), set by subclass

    def __init__(self, name, output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self._conf = _Confusion()
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        for label, pred in _paired(labels, preds):
            self._conf.observe(label, pred)
        score = type(self)._score
        if self.average == "macro":
            # one data point per update() call; run scope scores the
            # cumulative matrix (reference semantics)
            self._tally.wsum += score(self._conf.window)
            self._tally.n += 1
            self._tally.run_wsum += score(self._conf.run)
            self._tally.run_n += 1
            self._conf.clear_window()
        else:
            self._tally.n = self._conf.window.sum()
            self._tally.run_n = self._conf.run.sum()

    def get(self):
        if self.average == "macro":
            return (self.name, self._tally.mean())
        if not self._conf.window.sum():
            return (self.name, float("nan"))
        return (self.name, type(self)._score(self._conf.window))

    def get_global(self):
        if self.average == "macro":
            return (self.name, self._tally.run_mean())
        if not self._conf.run.sum():
            return (self.name, float("nan"))
        return (self.name, type(self)._score(self._conf.run))

    def reset(self):
        super().reset()
        if hasattr(self, "_conf"):
            self._conf.clear_all()

    def reset_local(self):
        super().reset_local()
        self._conf.clear_window()


@register
class F1(_ConfusionMetric):
    """Binary F1 (harmonic mean of precision and recall)."""

    _score = staticmethod(_confusion_f1)

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, average=average)


@register
class MCC(_ConfusionMetric):
    """Matthews correlation coefficient over the binary confusion matrix."""

    _score = staticmethod(_confusion_mcc)

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, average=average)


# --------------------------------------------------------------- likelihood

def _picked_probs(label, pred):
    """Probability each sample's model assigned to its true class."""
    label = label.astype("int64").ravel()
    flat = pred.reshape(-1, pred.shape[-1])
    if label.shape[0] != flat.shape[0]:
        raise ValueError("label count %d != prediction rows %d"
                         % (label.shape[0], flat.shape[0]))
    return flat[numpy.arange(label.shape[0]), label], label


@register
class Perplexity(EvalMetric):
    """exp(mean negative log likelihood), optionally skipping a pad label."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names,
                         has_global_stats=True)
        self.ignore_label = ignore_label
        self.axis = axis

    def _measure(self, label, pred):
        probs, label = _picked_probs(label, pred)
        if self.ignore_label is not None:
            keep = label != self.ignore_label
            probs = numpy.where(keep, probs, 1.0)
            count = int(keep.sum())
        else:
            count = label.size
        nll = -float(numpy.log(numpy.maximum(probs, 1e-10)).sum())
        return nll, count

    def get(self):
        m = self._tally.mean()
        return (self.name, math.exp(m) if m == m else float("nan"))

    def get_global(self):
        m = self._tally.run_mean()
        return (self.name, math.exp(m) if m == m else float("nan"))


@register
@_alias("ce")
class CrossEntropy(EvalMetric):
    """Mean -log p(true class) over predicted probability rows."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.eps = eps

    def _measure(self, label, pred):
        probs, label = _picked_probs(label, pred)
        return float(-numpy.log(probs + self.eps).sum()), label.size


@register
@_alias("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    """Alias semantics of CrossEntropy under the reference's nll name."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names,
                         label_names=label_names)


# --------------------------------------------------------------- regression

class _RegressionMetric(EvalMetric):
    """Per-batch error statistic of (label - pred)."""

    def __init__(self, name, output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    @staticmethod
    def _error(diff):
        raise NotImplementedError

    def _measure(self, label, pred):
        label = label.reshape(label.shape[0], -1)
        pred = pred.reshape(pred.shape[0], -1)
        n = pred.shape[0]
        return self._error(label - pred) * n, n


@register
class MAE(_RegressionMetric):
    """Mean absolute error."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _error(diff):
        return float(numpy.abs(diff).mean())


@register
class MSE(_RegressionMetric):
    """Mean squared error."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _error(diff):
        return float((diff ** 2).mean())


@register
class RMSE(_RegressionMetric):
    """Root mean squared error (per batch, then averaged)."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _error(diff):
        return float(numpy.sqrt((diff ** 2).mean()))


@register
@_alias("pearsonr")
class PearsonCorrelation(EvalMetric):
    """Pearson r; macro = mean per-batch r, micro = streaming moments."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def reset(self):
        super().reset()
        # shifted-moment accumulators for the micro (streaming) estimate;
        # moments are taken about a pivot (the first seen value) so the
        # n*Σxx - (Σx)² cancellation never sees large absolute magnitudes
        self._m = numpy.zeros(6)  # n, Σl, Σp, Σll, Σpp, Σlp  (pivot-shifted)
        self._pivot = None

    def update(self, labels, preds):
        for label, pred in _paired(labels, preds):
            check_label_shapes(label, pred, False, True)
            label = label.ravel().astype(numpy.float64)
            pred = pred.ravel().astype(numpy.float64)
            if self.average == "macro":
                self._tally.add(float(numpy.corrcoef(pred, label)[0, 1]), 1)
            else:
                if self._pivot is None:
                    self._pivot = (float(label[0]), float(pred[0])) \
                        if label.size else (0.0, 0.0)
                label = label - self._pivot[0]
                pred = pred - self._pivot[1]
                self._m += [label.size, label.sum(), pred.sum(),
                            (label * label).sum(), (pred * pred).sum(),
                            (label * pred).sum()]
                self._tally.add(0.0, 1)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        if self.average == "macro":
            return (self.name, self._tally.mean())
        n, sl, sp, sll, spp, slp = self._m
        cov = n * slp - sl * sp
        spread = math.sqrt(max(n * sll - sl * sl, 0.0)) * \
            math.sqrt(max(n * spp - sp * sp, 0.0))
        return (self.name, cov / spread if spread else float("nan"))


@register
class PCC(EvalMetric):
    """Multiclass Matthews/Pearson correlation from a streaming K x K
    confusion matrix (reference: metric.py:1473).

    Computed in the standard trace form: with s total samples, c the
    confusion trace, p_k predicted-class counts and t_k true-class counts,
    MCC = (c*s - p.t) / sqrt((s^2 - p.p)(s^2 - t.t)) — algebraically the
    K-class generalization of the binary MCC; the matrix grows on demand
    when new class ids appear."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def reset(self):
        super().reset()
        self._window = numpy.zeros((0, 0), numpy.float64)
        self._run = numpy.zeros((0, 0), numpy.float64)

    def reset_local(self):
        super().reset_local()
        self._window = numpy.zeros((0, 0), numpy.float64)

    @staticmethod
    def _grown(conf, k):
        if k <= conf.shape[0]:
            return conf
        out = numpy.zeros((k, k), numpy.float64)
        out[:conf.shape[0], :conf.shape[0]] = conf
        return out

    def update(self, labels, preds):
        for label, pred in _paired(labels, preds):
            label = numpy.asarray(_host(label)).ravel().astype(numpy.int64)
            p = numpy.asarray(_host(pred))
            pred_ids = p.argmax(-1).ravel().astype(numpy.int64) \
                if p.ndim > 1 and p.shape[-1] > 1 else \
                numpy.round(p.ravel()).astype(numpy.int64)
            check_label_shapes(label, pred_ids)
            k = int(max(label.max(), pred_ids.max())) + 1
            # each scope grows independently (after reset_local the window
            # is smaller than the run matrix), so scatter into each at its
            # own size
            self._window = self._grown(self._window, k)
            self._run = self._grown(self._run, k)
            numpy.add.at(self._window, (label, pred_ids), 1.0)
            numpy.add.at(self._run, (label, pred_ids), 1.0)
            self._tally.add(0.0, label.size)

    @staticmethod
    def _score(conf):
        s = conf.sum()
        if s == 0:
            return float("nan")
        c = numpy.trace(conf)
        t = conf.sum(axis=1)   # true-class counts
        p = conf.sum(axis=0)   # predicted-class counts
        denom = math.sqrt(max(s * s - (p * p).sum(), 0.0)) * \
            math.sqrt(max(s * s - (t * t).sum(), 0.0))
        return float((c * s - (t * p).sum()) / denom) if denom else 0.0

    def get(self):
        return (self.name, self._score(self._window))

    def get_global(self):
        return (self.name, self._score(self._run))


@register
class Loss(EvalMetric):
    """Average of an already-computed loss output."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            self._tally.add(float(_host(pred).sum()), pred.size)


@register
class Torch(Loss):
    """Compat alias kept for reference script parity."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    """Compat alias kept for reference script parity."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """Wraps feval(label, pred) -> value or (sum, count)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names,
                         has_global_stats=True)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels if isinstance(labels, list) else [labels],
                               preds if isinstance(preds, list) else [preds])
        for label, pred in _paired(labels, preds):
            out = self._feval(label, pred)
            if isinstance(out, tuple):
                self._tally.add(*out)
            else:
                self._tally.add(out, 1)

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Lift a bare numpy feval into a CustomMetric."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
