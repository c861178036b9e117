"""Operator registry and eager dispatcher (counterpart of
``mxnet_tpu.ops.registry``).

An op is a function over ``torch.Tensor``s (and Python scalars) plus its
metadata.  :func:`apply_op` unwraps NDArray inputs, calls the function and
wraps what it returns; gradients come from PyTorch's autograd through the
op's own tensor code, so there is no per-op vjp and no tape.  The same
functions are what ``hybrid_forward`` reaches through ``F`` (the
``mx.nd`` namespace).
"""
from __future__ import annotations

__all__ = ["Operator", "register", "get", "apply_op", "invoke", "list_ops"]

_REGISTRY = {}


class Operator:
    """A registered op: ``fn(*tensors, **attrs) -> tensor | tuple``.
    ``differentiable`` and ``num_outputs`` are informational, as in the
    reference (autograd follows the tensors)."""

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
    or a list of them for a multi-output op."""
    from ..ndarray.ndarray import NDArray, _wrap
    if isinstance(op, str):
        op = get(op)
    args = [x._data if isinstance(x, NDArray) else x for x in inputs]
    attrs = {k: (v._data if isinstance(v, NDArray) else v)
             for k, v in attrs.items()}
    out = op.fn(*args, **attrs)
    if isinstance(out, (tuple, list)):
        return [_wrap(v) for v in out]
    return _wrap(out)


def invoke(name, *inputs, **attrs):
    """Apply by name (the NDArray methods use it)."""
    return apply_op(get(name), *inputs, **attrs)
