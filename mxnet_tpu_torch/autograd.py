"""Autograd user API (counterpart of ``mxnet_tpu.autograd``): the
record/pause scopes, ``mark_variables``, ``backward``, ``grad`` and the
custom ``Function``, over the tape of ``_tape.py``.

``record`` / ``pause`` / ``train_mode`` / ``predict_mode`` set the two
flags layers read: ``is_training`` (BatchNorm uses batch statistics and
updates its moving ones) and ``is_recording`` (ops on the tape's arrays
record).  ``parallel.SPMDTrainer`` does not use the tape: it runs its
functionalized forward with recording off and differentiates its own
tensors with ``torch.autograd``.
"""
from __future__ import annotations

import torch

from . import _tape
from .ndarray.ndarray import NDArray, _wrap

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]

is_recording = _tape.is_recording
is_training = _tape.is_training
set_recording = _tape.set_recording
set_training = _tape.set_training


class _RecordingStateScope:
    """Set (recording, training) for a block; ``None`` leaves a flag as
    it is."""

    def __init__(self, is_record, train_mode_):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode_
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)

    def __exit__(self, *exc):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    """Scope: ops on the tape's arrays inside are recorded for
    ``backward()``."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark NDArrays as tape leaves with the given grad buffers
    (reference ``autograd.py:62``)."""
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, r in zip(variables, gradients, grad_reqs):
        _tape.mark_variable(v, g, r)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into the marked leaves' grad buffers."""
    if isinstance(heads, NDArray):
        heads = [heads]
        if isinstance(head_grads, NDArray):
            head_grads = [head_grads]
    _tape.backward(heads, head_grads, retain_graph, train_mode)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` as new
    NDArrays (zeros where a variable is not reached); ``.grad`` buffers
    are left alone.  With ``create_graph=True`` the results are on the
    tape and can be differentiated again; ``retain_graph`` defaults to
    ``create_graph``."""
    if isinstance(heads, NDArray):
        heads = [heads]
    if isinstance(variables, NDArray):
        variables = [variables]
    if isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    for v in variables:
        if v._grad_req is None:
            raise ValueError("variables passed to grad() must have "
                             "attach_grad() called or be marked variables")
    retain = retain_graph if retain_graph is not None else create_graph
    outs = _tape.grad_arrays(heads, variables, head_grads,
                             retain_graph=retain, create_graph=create_graph)
    res = []
    for g, v in zip(outs, variables):
        arr = _wrap(torch.zeros_like(v._data.detach()) if g is None else g)
        arr._on_tape = bool(create_graph and g is not None
                            and g.requires_grad)
        res.append(arr)
    return res


class _Bridge(torch.autograd.Function):
    """Runs a user :class:`Function`'s ``forward`` and ``backward`` (on
    NDArrays) as one PyTorch autograd node."""

    @staticmethod
    def forward(ctx, fn, template, *tensors):
        it = iter(tensors)
        args = [_wrap(next(it)) if isinstance(x, NDArray) else x
                for x in template]
        out = fn.forward(*args)
        ctx.fn = fn
        ctx.multi = isinstance(out, (tuple, list))
        outs = list(out) if ctx.multi else [out]
        return tuple(o._data for o in outs) if ctx.multi else outs[0]._data

    @staticmethod
    def backward(ctx, *grads):
        gs = ctx.fn.backward(*[_wrap(g) for g in grads])
        if isinstance(gs, NDArray) or not isinstance(gs, (tuple, list)):
            gs = [gs]
        return (None, None) + tuple(
            g._data if isinstance(g, NDArray) else g for g in gs)


class Function:
    """User-defined differentiable function (reference
    ``autograd.py:110``): subclass it and write ``forward`` and
    ``backward`` on NDArrays; ``save_for_backward`` keeps what backward
    needs.  Under ``record()`` a call is one node of the tape."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        nd_inputs = [x for x in inputs if isinstance(x, NDArray)]
        if not (is_recording() and any(x._on_tape for x in nd_inputs)):
            return self.forward(*inputs)
        tensors = [_tape.record_tensor(x) for x in nd_inputs]
        out = _Bridge.apply(self, inputs, *tensors)
        multi = isinstance(out, tuple)
        outs = [_wrap(o) for o in (out if multi else (out,))]
        for o in outs:
            o._on_tape = True
        return outs if multi else outs[0]
