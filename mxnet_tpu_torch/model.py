"""Checkpoint helpers (counterpart of ``mxnet_tpu.model``; reference
``python/mxnet/model.py:394-442``): ``prefix-symbol.json`` and
``prefix-NNNN.params`` in the JAX package's formats (its symbol JSON and
``nd.save``'s npz container), so each package loads the other's
checkpoints; ``load_checkpoint`` also reads Apache MXNet's own files
(``compat``).  Both files are written atomically, retried on an I/O
error (``resilience.call_with_retry``).  ``FeedForward`` is the legacy
estimator over the Module.
"""
from __future__ import annotations

import warnings

import numpy as _np

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "pack_params", "unpack_params", "FeedForward"]


def pack_params(arg_params, aux_params):
    """One flat dict with ``arg:``/``aux:`` prefixes (the params-file
    convention of checkpoints and ``BaseModule.save_params``)."""
    packed = {("arg:%s" % k): v for k, v in arg_params.items()}
    packed.update({("aux:%s" % k): v for k, v in aux_params.items()})
    return packed


def unpack_params(loaded):
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params``."""
    from .ndarray.ndarray import save
    from .resilience import call_with_retry
    if symbol is not None:
        call_with_retry(symbol.save, "%s-symbol.json" % prefix,
                        kind="ckpt_write")
    call_with_retry(save, "%s-%04d.params" % (prefix, epoch),
                    pack_params(arg_params, aux_params), kind="ckpt_write")


def load_params(prefix, epoch):
    """``(arg_params, aux_params)`` from ``prefix-%04d.params``, on the
    current context."""
    from .ndarray.ndarray import load
    return unpack_params(load("%s-%04d.params" % (prefix, epoch)))


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)``."""
    from .symbol.symbol import load
    arg_params, aux_params = load_params(prefix, epoch)
    return load("%s-symbol.json" % prefix), arg_params, aux_params


class FeedForward:
    """The deprecated single-output estimator (reference ``model.py:70``):
    ``fit`` / ``predict`` / ``score`` / ``save`` / ``load`` / ``create``
    over the Module training loop, numpy inputs wrapped in
    ``NDArrayIter``.

    Where the reference's copy has faults (``ADVICE.md``), this one
    follows Apache MXNet: ``predict`` and ``score`` on a model that was
    neither fitted nor loaded raise instead of running on freshly drawn
    weights; ``allow_extra_params`` allows entries of ``arg_params`` the
    graph does not have (the reference maps it onto ``allow_missing``);
    ``score`` calls its ``batch_end_callback`` after each batch."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, **kwargs):
        warnings.warn("mxnet_tpu_torch.model.FeedForward has been "
                      "deprecated. Please use mxnet_tpu_torch.mod.Module "
                      "instead.",
                      DeprecationWarning, stacklevel=2)
        if callable(symbol) and not hasattr(symbol, "list_arguments"):
            self.sym_gen = symbol
            self.symbol = None
        else:
            self.symbol = symbol
            self.sym_gen = None
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        if initializer is None:
            from .initializer import Uniform
            initializer = Uniform(0.01)
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs.copy()
        self._module = None

    # ----------------------------------------------------------- data prep
    def _label_name(self):
        # the reference binds the label positionally to the symbol's single
        # label argument; with name-matched Module feeding, derive the name
        # from the graph instead ('sm' output -> 'sm_label')
        if self.symbol is not None:
            labels = [n for n in self.symbol.list_arguments()
                      if n.endswith("label")]
            if len(labels) == 1:
                return labels[0]
        return "softmax_label"

    def _init_iter(self, X, y, is_train):
        from . import io as io_mod
        from .ndarray.ndarray import NDArray
        if isinstance(X, (_np.ndarray, NDArray)):
            if y is None:
                if is_train:
                    raise ValueError("y must be specified when X is "
                                     "numpy.ndarray")
                y = _np.zeros(int(X.shape[0]))
            y = _np.asarray(y)
            if y.dtype == _np.float64:
                y = y.astype(_np.float32)  # x64 posture: canonicalize
            if y.ndim == 2 and y.shape[1] == 1:
                y = y.flatten()
            if y.ndim != 1:
                raise ValueError("Label must be 1D or 2D (with 2nd "
                                 "dimension being 1)")
            if int(X.shape[0]) != int(y.shape[0]):
                raise ValueError("The numbers of data points and labels "
                                 "not equal")
            bs = min(int(X.shape[0]), self.numpy_batch_size)
            return io_mod.NDArrayIter(X, y, bs, shuffle=is_train,
                                      last_batch_handle="roll_over"
                                      if is_train else "pad",
                                      label_name=self._label_name())
        if not isinstance(X, io_mod.DataIter):
            raise TypeError("X must be DataIter, NDArray or numpy.ndarray")
        return X

    def _init_eval_iter(self, eval_data):
        from . import io as io_mod
        if eval_data is None:
            return None
        if isinstance(eval_data, (tuple, list)) and len(eval_data) == 2:
            data = _np.asarray(eval_data[0])
            if data.dtype == _np.float64:
                data = data.astype(_np.float32)
            label = _np.asarray(eval_data[1])
            return self._init_iter(data, label, is_train=True)
        if not isinstance(eval_data, io_mod.DataIter):
            raise TypeError("Eval data must be DataIter or a "
                            "(data, label) pair")
        return eval_data

    def _build_module(self, data):
        from .module import Module
        sym = self.symbol
        if self.sym_gen is not None:
            sym = self.sym_gen(getattr(data, "default_bucket_key", None))
            self.symbol = sym
        data_names = tuple(d.name for d in data.provide_data)
        label_names = tuple(d.name for d in (data.provide_label or ()))
        self._module = Module(sym, data_names=data_names,
                              label_names=label_names, context=self.ctx)
        return self._module

    # ------------------------------------------------------------ training
    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None,
            monitor=None, eval_end_callback=None,
            eval_batch_end_callback=None):
        data = self._init_iter(X, y, is_train=True)
        eval_data = self._init_eval_iter(eval_data)
        mod = self._build_module(data)
        # ctor **kwargs (learning_rate/wd/momentum...) feed the optimizer.
        # NOTE: unlike the reference, no rescale_grad=1/batch_size default —
        # this framework's output-op backwards already batch-mean their
        # gradients (ops/nn.py _smo_bwd), the same convention Module.fit
        # users rely on; adding it would double-normalize
        opt_params = dict(self.kwargs)
        mod.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=opt_params,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    # ----------------------------------------------------------- inference
    def _init_predictor(self, data):
        """The bound predictor, cached by shape signature (the reference
        keeps its executor and rebinds only on a shape change), set from
        the model's parameters: a missing one raises, and so does an
        extra one unless ``allow_extra_params``."""
        if self.arg_params is None:
            raise RuntimeError("FeedForward: predict/score need parameters; "
                               "fit() or load() the model first")
        sig = (tuple(data.provide_data),
               tuple(data.provide_label or ()))
        cached = getattr(self, "_pred_cache", None)
        if cached is not None and cached[0] == sig:
            mod = cached[1]
        else:
            mod = self._build_module(data)
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label, for_training=False)
            self._pred_cache = (sig, mod)
        if not self.allow_extra_params:
            known = set(mod.symbol.list_arguments()) | set(
                mod.symbol.list_auxiliary_states())
            extra = sorted((set(self.arg_params) | set(
                self.aux_params or {})) - known)
            if extra:
                raise ValueError("FeedForward: parameters the graph does "
                                 "not have: %s (allow_extra_params=True "
                                 "allows them)" % extra[:8])
        mod.init_params(initializer=None, arg_params=self.arg_params,
                        aux_params=self.aux_params, allow_missing=False,
                        force_init=True,
                        allow_extra=self.allow_extra_params)
        return mod

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """Per-output numpy predictions over the whole iterator
        (reference model.py:693)."""
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        mod = self._init_predictor(X)
        outputs, datas, labels = [], [], []
        for i, batch in enumerate(X):
            if num_batch is not None and i == num_batch:
                break
            mod.forward(batch, is_train=False)
            pad = batch.pad
            outs = [o.asnumpy() for o in mod.get_outputs()]
            n = outs[0].shape[0] - pad
            outputs.append([o[:n] for o in outs])
            if return_data:
                datas.append([d.asnumpy()[:n] for d in batch.data])
                labels.append([l.asnumpy()[:n] for l in batch.label])
        if not outputs:
            raise ValueError("predict got no batches from the iterator "
                             "(exhausted iter with reset=False, or "
                             "num_batch=0)")
        merged = [_np.concatenate([b[i] for b in outputs])
                  for i in range(len(outputs[0]))]
        result = merged[0] if len(merged) == 1 else merged
        if return_data:
            data_m = [_np.concatenate([b[i] for b in datas])
                      for i in range(len(datas[0]))]
            label_m = [_np.concatenate([b[i] for b in labels])
                       for i in range(len(labels[0]))]
            return (result, data_m[0] if len(data_m) == 1 else data_m,
                    label_m[0] if len(label_m) == 1 else label_m)
        return result

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """Metric over the iterator (reference model.py:762)."""
        from . import metric as metric_mod
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        mod = self._init_predictor(X)
        for i, batch in enumerate(X):
            if num_batch is not None and i == num_batch:
                break
            mod.forward(batch, is_train=False)
            mod.update_metric(eval_metric, batch.label)
            if batch_end_callback is not None:
                from .callback import BatchEndParam
                params = BatchEndParam(epoch=0, nbatch=i,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for cb in (batch_end_callback if isinstance(
                        batch_end_callback, (list, tuple))
                        else [batch_end_callback]):
                    cb(params)
        return eval_metric.get()[1]

    # ------------------------------------------------------- serialization
    def save(self, prefix, epoch=None, remove_amp_cast=True):
        if epoch is None:
            epoch = self.num_epoch
        if epoch is None:
            raise ValueError("save: give an epoch (num_epoch is None)")
        save_checkpoint(prefix, epoch, self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None,
               epoch_size=None, optimizer="sgd", initializer=None,
               eval_data=None, eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Construct + fit in one call (reference model.py:973)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
