"""The fused recurrent op ``RNN`` (counterpart of ``mxnet_tpu.ops.rnn``).

Reference: the fused stateful RNN operator ``src/operator/rnn.cc:652``
(cuDNN path ``rnn-inl.h:427``): modes ``rnn_relu``, ``rnn_tanh``,
``lstm`` and ``gru``, several layers, each one- or two-directional, TNC
data and one flat parameter blob in the layout of
``rnn/_fused_layout.py``.

The reference ran the recurrence as a ``lax.scan``; there is no Pallas
kernel to port.  Here each layer is one call of PyTorch's fused
recurrence (``torch.lstm``, ``torch.gru``, ``torch.rnn_tanh``,
``torch.rnn_relu``: the functional entry ``nn.LSTM`` calls), which runs
cuDNN's recurrence on the card and the same ATen recurrence on the CPU.
The gate weights enter as views of the blob, so the gradient reaches the
blob; cuDNN copies them into its own buffer at every call.  A CUDA input
cuDNN does not accept raises :class:`KernelUnsupportedError`: there is no
Python time loop on the card.

Three behaviours are the reference's and are kept: a batch-1 initial
state broadcasts to the data's batch (the symbolic ``zeros`` of a cell's
``begin_state`` lowers to batch 1); the LSTM clip applies to the
*returned* ``c_n`` only, not at every step as in MXNet/cuDNN; and
``use_sequence_length`` / ``sequence_length`` are accepted and ignored,
so padded steps are computed.  Dropout between layers (inverted, only
when training, never after the last layer) draws its mask on the op's
device.
"""
from __future__ import annotations

import torch

from ..base import KernelUnsupportedError
from ..rnn._fused_layout import GATES, fused_rnn_group_slices
from .registry import register

__all__ = ["rnn_layer"]

_RECURRENCES = {"lstm": torch.lstm, "gru": torch.gru,
                "rnn_tanh": torch.rnn_tanh, "rnn_relu": torch.rnn_relu}


def _check_device(data):
    """Raise unless PyTorch will run a CUDA call through cuDNN (the check
    ``at::native::lstm`` makes before it picks cuDNN)."""
    if data.device.type != "cuda":
        return
    if not torch.backends.cudnn.is_acceptable(data):
        raise KernelUnsupportedError(
            "RNN: cuDNN does not take this input (dtype %s, cudnn enabled "
            "%s, available %s); the op has no other route on the card"
            % (data.dtype, torch.backends.cudnn.enabled,
               torch.backends.cudnn.is_available()))


def rnn_layer(mode, x, h0, c0, weights):
    """One layer over TNC ``x``: ``weights`` is ``[i2h_w, h2h_w, i2h_b,
    h2h_b]`` per direction, ``h0``/``c0`` ``[D, B, H]``.  Returns
    ``(out [T, B, D*H], h_n [D, B, H], c_n [D, B, H] or None)``."""
    bidirectional = len(weights) == 8
    fn = _RECURRENCES[mode]
    # cuDNN keeps what its backward needs only in training mode; with no
    # dropout inside the call, the mode changes nothing else
    train = torch.is_grad_enabled()
    if mode == "lstm":
        out, h_n, c_n = fn(x, (h0, c0), weights, True, 1, 0.0, train,
                           bidirectional, False)
        return out, h_n, c_n
    out, h_n = fn(x, h0, weights, True, 1, 0.0, train, bidirectional, False)
    return out, h_n, None


def _full_batch(state, batch):
    if state.shape[1] == batch:
        return state
    # batch-agnostic initial state (symbol zeros with an unknown batch
    # dim lower to size 1): broadcast, as the reference does
    return state.expand(state.shape[0], batch, state.shape[2]).contiguous()


@register("RNN", num_outputs=3)
def _rnn(data, parameters, state, state_cell=None, state_size=None,
         num_layers=1, bidirectional=False, mode="lstm", p=0.0,
         state_outputs=True, lstm_state_clip_min=None,
         lstm_state_clip_max=None, training=False,
         use_sequence_length=False, sequence_length=None, **_):
    """Fused multi-layer RNN (reference ``src/operator/rnn.cc:652``).

    ``data`` [T, B, I]; ``parameters`` the flat blob; ``state`` [L*D, B,
    H] (or batch 1); ``state_cell`` likewise for lstm.  Returns ``(out,
    h_n, c_n)``, ``c_n`` zeros outside lstm mode."""
    if mode not in _RECURRENCES:
        raise ValueError("unknown RNN mode %r" % (mode,))
    _check_device(data)
    T, B, I = data.shape
    H = int(state_size)
    L = int(num_layers)
    D = 2 if bidirectional else 1
    h0_all = _full_batch(state, B)
    c0_all = _full_batch(state_cell, B) if state_cell is not None \
        else torch.zeros_like(h0_all)
    gb = len(GATES[mode]) * H
    groups = fused_rnn_group_slices(I, H, L, mode, bool(bidirectional))
    w = parameters
    out = data
    h_n, c_n = [], []
    for layer in range(L):
        weights = []
        for d in range(D):
            iw_off, iw_shape, hw_off, hw_shape, ib_off, hb_off = \
                groups[layer * D + d]
            i2h = w[iw_off:iw_off + gb * iw_shape[1]].reshape(iw_shape)
            h2h = w[hw_off:hw_off + gb * H].reshape(hw_shape)
            weights += [i2h, h2h, w[ib_off:ib_off + gb],
                        w[hb_off:hb_off + gb]]
        rows = slice(layer * D, (layer + 1) * D)
        out, h_t, c_t = rnn_layer(mode, out, h0_all[rows], c0_all[rows],
                                  weights)
        h_n.append(h_t)
        if mode == "lstm":
            if lstm_state_clip_min is not None:
                c_t = torch.clamp(c_t, lstm_state_clip_min,
                                  lstm_state_clip_max)
            c_n.append(c_t)
        if p > 0.0 and training and layer != L - 1:
            from ..random import generator
            from .nn import dropout_apply
            keep = 1.0 - p
            mask = torch.empty(out.shape, dtype=torch.bool,
                               device=out.device)
            mask.bernoulli_(keep, generator=generator(out.device))
            out = dropout_apply(out, mask, keep)
    h_n = torch.cat(h_n, 0)
    if mode == "lstm":
        return out, h_n, torch.cat(c_n, 0)
    return out, h_n, torch.zeros_like(h_n)
