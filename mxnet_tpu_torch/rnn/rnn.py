"""RNN checkpoint helpers (counterpart of ``mxnet_tpu.rnn.rnn``;
reference: python/mxnet/rnn/rnn.py:26-121).

Checkpoints written through these helpers store the *unpacked* per-gate
weights, so files stay readable regardless of which fused/unfused cell
variant later loads them.
"""
from __future__ import annotations

import warnings

from ..model import save_checkpoint, load_checkpoint
from .rnn_cell import BaseRNNCell

__all__ = ["rnn_unroll", "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC"):
    """Deprecated alias kept for reference API parity."""
    warnings.warn("rnn_unroll is deprecated. Please call cell.unroll "
                  "directly.")
    return cell.unroll(length=length, inputs=inputs,
                       begin_state=begin_state, layout=layout)


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """save_checkpoint with cell weights unpacked first (reference
    rnn.py:32)."""
    if isinstance(cells, BaseRNNCell):
        cells = [cells]
    for cell in cells:
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """load_checkpoint + re-packing into the cells' fused layout
    (reference rnn.py:62)."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    if isinstance(cells, BaseRNNCell):
        cells = [cells]
    for cell in cells:
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback writing unpacked-weight checkpoints (reference
    rnn.py:97); drop-in for ``mx.callback.do_checkpoint`` in Module.fit."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
