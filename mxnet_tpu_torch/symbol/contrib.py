"""``mx.sym.contrib`` — Symbol nodes of the registered ops by short name
(counterpart of ``mxnet_tpu.symbol.contrib``; reference: the generated
``mxnet.symbol.contrib``): ``sym.contrib.MultiBoxPrior`` makes the node
of ``MultiBoxPrior`` (the exact name first, then the ``_contrib_`` one,
as ``mx.nd.contrib`` resolves)."""
from __future__ import annotations

from .symbol import _make_op_node


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    # at call time: ndarray.contrib imports the op registry, which imports
    # this package on its way
    from ..ndarray.contrib import _resolve
    op = _resolve(name)  # raises AttributeError for unknown names

    def build(*args, **kwargs):
        return _make_op_node(op.name, list(args), kwargs)

    build.__name__ = name
    return build
