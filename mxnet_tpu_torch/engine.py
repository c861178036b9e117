"""``mx.engine`` — execution-control facade (counterpart of
``mxnet_tpu.engine``).

Reference: ``src/engine/`` ThreadedEngine and ``python/mxnet/engine.py``
(``bulk``, ``set_bulk_size``, ``MXNET_ENGINE_TYPE``).  PyTorch's stream
order is the engine here, so what remains is what the symbolic path
reads: the bulk size, kept for scripts that set it, and the engine type,
whose ``NaiveEngine`` (the reference's synchronous debug mode) keeps a
symbolic Module on the stage-at-a-time eager step
(:func:`fused_step_allowed`) and makes every ``mx.nd`` op complete before
it returns (:func:`maybe_sync`).
"""
from __future__ import annotations

import contextlib

import torch

from . import config as _config
from . import telemetry as _telemetry

__all__ = ["bulk", "set_bulk_size", "engine_type", "set_engine_type",
           "naive_engine_enabled", "fused_step_allowed", "maybe_sync"]

_ENGINE_TYPES = ("NaiveEngine", "ThreadedEngine", "ThreadedEnginePerDevice")
_BULK_SIZE = [_config.get("engine.bulk_size")]
_ENGINE_TYPE = [_config.get("engine.type")]


def set_bulk_size(size):
    """Set the bulk size (reference ``MXEngineSetBulkSize``); returns the
    previous one."""
    prev = _BULK_SIZE[0]
    _BULK_SIZE[0] = int(size)
    return prev


@contextlib.contextmanager
def bulk(size):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)


def engine_type():
    return _ENGINE_TYPE[0]


def set_engine_type(name):
    """Select the engine (reference ``src/engine/engine.cc:32-41``)."""
    if name not in _ENGINE_TYPES:
        raise ValueError("unknown engine type %r (one of %s)"
                         % (name, ", ".join(_ENGINE_TYPES)))
    _ENGINE_TYPE[0] = name


def naive_engine_enabled():
    return _ENGINE_TYPE[0] == "NaiveEngine"


def fused_step_allowed():
    """Whether a fused train step may run: not under ``NaiveEngine``,
    whose contract is one op completing at a time."""
    return not naive_engine_enabled()


def maybe_sync(tensors):
    """Under ``NaiveEngine``, wait until the card has computed
    ``tensors`` (reference ``maybe_sync``).  The op dispatcher
    (``ops.registry.apply_op``) calls it after every op, so an
    asynchronous CUDA error surfaces at the op that caused it.  Each
    call under ``NaiveEngine`` counts ``engine.naive_syncs``."""
    if _ENGINE_TYPE[0] != "NaiveEngine":
        return
    _telemetry.counter("engine.naive_syncs").inc()
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()
