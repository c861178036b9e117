"""``mx.nd.contrib`` (counterpart of ``mxnet_tpu.ndarray.contrib``): the
control-flow functions, and every registered op by its short name (the
exact name first, then the ``_contrib_`` one).  The DGL graph functions
are not ported yet."""
from __future__ import annotations

from ..ops import registry as _registry
from ..ops.control_flow import foreach, while_loop, cond  # noqa: F401


def _resolve(name):
    for candidate in (name, "_contrib_" + name):
        try:
            return _registry.get(candidate)
        except AttributeError:
            continue
    raise AttributeError(
        "module 'nd.contrib' has no attribute %r" % (name,)) from None


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    op = _resolve(name)

    def fn(*args, **kwargs):
        from . import _apply_with_out
        return _apply_with_out(op, args, kwargs)

    fn.__name__ = name
    return fn
