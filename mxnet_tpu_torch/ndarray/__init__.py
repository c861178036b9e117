"""The ``mx.nd`` namespace: NDArray and every registered op as a function
(counterpart of ``mxnet_tpu.ndarray``).  A module ``__getattr__`` resolves
any registered op name (``nd.Convolution``, ``nd.relu``, ...) to an eager
dispatcher, so this module is also the ``F`` a ``hybrid_forward``
receives."""
from __future__ import annotations

from .ndarray import (NDArray, array, zeros, ones, full, empty, arange, eye,
                      linspace, waitall, concat, stack, split, where, save,
                      load)
from .. import random  # noqa: F401  (nd.random: the samplers)
from . import contrib  # noqa: F401  (nd.contrib: control flow, _contrib_)
from ..ops import registry as _registry

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "eye", "linspace", "waitall", "concat", "stack", "split",
           "where", "save", "load", "random", "contrib"]


def _fill_one(o, r):
    if tuple(o.shape) != tuple(r.shape):
        raise ValueError("out= shape %s does not match result shape %s"
                         % (tuple(o.shape), tuple(r.shape)))
    o._set_data(r._data.to(o._data.dtype))
    return o


def _apply_with_out(op, args, kwargs):
    """Op dispatch with the reference's ``out=`` contract: the result is
    written into the caller's array(s), which are returned."""
    out = kwargs.pop("out", None)
    kwargs.pop("name", None)
    res = _registry.apply_op(op, *args, **kwargs)
    if out is None:
        return res
    if isinstance(out, (tuple, list)):
        rs = res if isinstance(res, (tuple, list)) else (res,)
        if len(out) != len(rs):
            raise ValueError("out= expects %d arrays, op produced %d"
                             % (len(out), len(rs)))
        return type(out)(_fill_one(o, r) for o, r in zip(out, rs))
    return _fill_one(out, res[0] if isinstance(res, (tuple, list)) else res)


def __getattr__(name):
    try:
        op = _registry.get(name)
    except AttributeError:
        raise AttributeError("module 'nd' has no attribute %r"
                             % (name,)) from None

    def fn(*args, **kwargs):
        return _apply_with_out(op, args, kwargs)

    fn.__name__ = name
    return fn
