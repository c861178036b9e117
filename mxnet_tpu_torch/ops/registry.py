"""Operator registry and eager dispatcher (counterpart of
``mxnet_tpu.ops.registry``).

An op is a function over ``torch.Tensor``s (and Python scalars) plus its
metadata.  :func:`apply_op` unwraps NDArray inputs, calls the function and
wraps what it returns.  Gradients come from PyTorch's autograd through the
op's own tensor code (or its ``torch.autograd.Function``), so there is no
per-op vjp; the tape (``_tape.py``) decides per call whether the op
records.  The same functions are what ``hybrid_forward`` reaches through
``F`` (the ``mx.nd`` namespace).  Under ``NaiveEngine`` every op waits
for its outputs (``engine.maybe_sync``).
"""
from __future__ import annotations

from .. import _tape
from .. import engine as _engine

__all__ = ["Operator", "register", "get", "apply_op", "invoke", "list_ops"]

_REGISTRY = {}


class Operator:
    """A registered op: ``fn(*tensors, **attrs) -> tensor | tuple``.  A
    non-``differentiable`` op never records: its outputs carry no
    history.  ``num_outputs`` is informational, as in the reference."""

    __slots__ = ("name", "fn", "differentiable", "num_outputs")

    def __init__(self, name, fn, differentiable=True, num_outputs=1):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.num_outputs = num_outputs


def register(name, differentiable=True, num_outputs=1, aliases=()):
    """Decorator: register ``fn`` under ``name`` and its ``aliases``."""

    def deco(fn):
        op = Operator(name, fn, differentiable, num_outputs)
        _REGISTRY[name] = op
        for a in aliases:
            _REGISTRY[a] = op
        return fn

    return deco


def get(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise AttributeError("operator %r is not registered"
                             % (name,)) from None


def list_ops():
    return sorted(_REGISTRY)


def apply_op(op, *inputs, **attrs):
    """Run ``op`` on NDArray (or tensor/scalar) inputs; returns an NDArray,
    or a list of them for a multi-output op.

    The op records (reference ``registry.py:104``) when recording is on,
    the op is differentiable and an NDArray input is on the tape: the
    inputs then enter as the tape's tensors and the outputs join the
    tape.  Otherwise the tape's arrays enter detached, so the outputs
    carry no history; an NDArray that is not on the tape passes its
    tensor as it is (history of its own included)."""
    from ..ndarray.ndarray import NDArray, _wrap
    if isinstance(op, str):
        op = get(op)
    on_tape = arrays = False
    args = []
    for x in inputs:
        if isinstance(x, NDArray):
            on_tape = on_tape or x._on_tape
            arrays = True
            x = x._data
        args.append(x)
    kwargs = {}
    for k, v in attrs.items():
        if isinstance(v, NDArray):
            on_tape = on_tape or v._on_tape
            arrays = True
            v = v._data
        kwargs[k] = v
    if not on_tape:
        # nothing on the tape: tensors pass as they are; under record() a
        # differentiable op's outputs are marked recorded all the same
        out = op.fn(*args, **kwargs)
        multi = isinstance(out, (tuple, list))
        _engine.maybe_sync(out if multi else (out,))
        outs = [_wrap(v) for v in (out if multi else (out,))]
        if arrays and op.differentiable and _tape.is_recording():
            for o in outs:
                o._recorded = True
        return outs if multi else outs[0]
    record = op.differentiable and _tape.is_recording()

    def unwrap(x):
        if not isinstance(x, NDArray):
            return x
        if record:
            return _tape.record_tensor(x)
        return x._data.detach() if x._on_tape else x._data

    out = op.fn(*[unwrap(x) for x in inputs],
                **{k: unwrap(v) for k, v in attrs.items()})
    multi = isinstance(out, (tuple, list))
    _engine.maybe_sync(out if multi else (out,))
    outs = [_wrap(v) for v in (out if multi else (out,))]
    if record:
        for o in outs:
            o._on_tape = True
    return outs if multi else outs[0]


def invoke(name, *inputs, **attrs):
    """Apply by name (the NDArray methods use it)."""
    return apply_op(get(name), *inputs, **attrs)
