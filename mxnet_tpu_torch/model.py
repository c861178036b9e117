"""Checkpoint helpers (counterpart of ``mxnet_tpu.model``; reference
``python/mxnet/model.py:394-442``): ``prefix-symbol.json`` and
``prefix-NNNN.params`` in the JAX package's formats (its symbol JSON and
``nd.save``'s npz container), so each package loads the other's
checkpoints.  Both files are written atomically.  ``FeedForward`` is not
ported yet.
"""
from __future__ import annotations

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "pack_params", "unpack_params"]


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
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save("%s-%04d.params" % (prefix, epoch),
         pack_params(arg_params, aux_params))


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
