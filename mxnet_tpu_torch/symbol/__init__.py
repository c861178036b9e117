"""The ``mx.sym`` namespace: Symbol and every registered op as a node
builder (counterpart of ``mxnet_tpu.symbol``).  A module ``__getattr__``
resolves any registered op name, an ``rtc.register_op`` op included, so
``sym.FullyConnected``, ``sym.relu`` and a user kernel's op exist without
code generation and stay in step with ``mx.nd``.  ``subgraph`` and
``contrib`` are not ported yet."""
from __future__ import annotations

from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     Executor, zeros, ones, _make_op_node)
from ..ops import registry as _registry

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "Executor", "zeros", "ones"]


def __getattr__(name):
    try:
        _registry.get(name)
    except AttributeError:
        raise AttributeError(
            "module 'symbol' has no attribute %r" % (name,)) from None

    def build(*args, **kwargs):
        return _make_op_node(name, list(args), kwargs)

    build.__name__ = name
    return build
