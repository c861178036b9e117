"""Functionalize a Gluon Block into a pure ``(params, apply)`` pair
(counterpart of ``mxnet_tpu.parallel.functional``).

``functionalize(block)`` splits the Block's Parameters into the trainable
ones (``grad_req != 'null'``) and the aux state (``grad_req == 'null'``:
the BatchNorm running statistics), in ``collect_params`` order, and
gives an ``apply`` that runs the forward on tensors the caller passes:
each Parameter's value is swapped for the caller's tensor for the call
and swapped back after, and the aux state the forward writes is returned
instead of landing in the live Parameters.  Autograd follows the
caller's tensors, so a loss built on ``apply`` differentiates with
respect to them.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ..ndarray.ndarray import _wrap
from .. import autograd
from .. import random as _random

__all__ = ["functionalize", "BlockFunction"]


class BlockFunction:
    """Pure-function view of a Block.

    ``params`` (name -> Parameter, all of them), ``trainable`` and ``aux``
    (names).  ``apply(param_map, inputs, key=None, training=True)`` takes
    and returns tensors: ``(outputs_tuple, new_aux_map)``."""

    def __init__(self, block):
        self.block = block
        self.params = OrderedDict(block.collect_params().items())
        self.trainable = [n for n, p in self.params.items()
                          if p.grad_req != "null"]
        self.aux = [n for n, p in self.params.items() if p.grad_req == "null"]

    def init_values(self):
        """The current values as ``{name: tensor}`` (the live tensors)."""
        return {n: p.data()._data for n, p in self.params.items()}

    def apply(self, param_map, inputs, key=None, training=True):
        params = self.params
        if key is None:
            key = _random.next_key()
        originals, wrappers = {}, {}
        for n, p in params.items():
            originals[n] = p._data
            wrappers[n] = p._data = _wrap(param_map[n])
        try:
            with autograd._RecordingStateScope(False, training):
                with _random.trace_key_scope(key):
                    out = self.block._eager_forward(
                        *[_wrap(v) for v in inputs])
        finally:
            for n, p in params.items():
                p._data = originals[n]
        multi = isinstance(out, (tuple, list))
        out_vals = tuple(o._data for o in out) if multi else (out._data,)
        new_aux = {n: wrappers[n]._data for n in self.aux
                   if wrappers[n]._data is not param_map[n]}
        return out_vals, new_aux

    @torch.no_grad()
    def write_back(self, param_map):
        """Copy values into the live Parameters (each keeps its device
        and dtype)."""
        for n, p in self.params.items():
            if n in param_map:
                p.set_data(param_map[n])


def functionalize(block):
    return BlockFunction(block)
