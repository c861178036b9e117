"""Convolutional recurrent cells and the experimental cells (counterpart
of ``mxnet_tpu.gluon.contrib.rnn.conv_cells``).

Reference: python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py (Conv1-3D
RNN/LSTM/GRU cells) and rnn_cell.py (VariationalDropoutCell, LSTMPCell).

As in the JAX package, one `_ConvCell` base holds the fused-gate
convolutions: i2h and h2h are SAME-padded ``F.Convolution`` calls that
produce all G gate maps at once, and the RNN/LSTM/GRU subclasses add
only their gate formulas (the dense cells' equations, split on the
channel axis).  The layout is channels-first (NC...), as in the rest of
the framework.
"""
from __future__ import annotations

from ...rnn.rnn_cell import _act_fn, HybridRecurrentCell, ModifierCell
from .... import autograd
from .... import ndarray as F

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell",
           "VariationalDropoutCell", "LSTMPCell"]


def _tuplify(v, n, what):
    t = (v,) * n if isinstance(v, int) else tuple(v)
    if len(t) != n:
        raise ValueError("%s must have %d dims, got %r" % (what, n, v))
    return t


class _ConvCell(HybridRecurrentCell):
    """Shared conv-gate machinery; subclasses set _num_gates/_num_states
    and the gate formula."""

    _num_gates = 1
    _num_states = 1
    _ndim = 2

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        nd = self._ndim
        self._input_shape = tuple(input_shape)   # (C_in, *spatial)
        if len(self._input_shape) != nd + 1:
            raise ValueError("input_shape must be (C_in, %s)"
                             % ", ".join("d%d" % i for i in range(nd)))
        self._hidden_channels = hidden_channels
        self._i2h_kernel = _tuplify(i2h_kernel, nd, "i2h_kernel")
        self._h2h_kernel = _tuplify(h2h_kernel, nd, "h2h_kernel")
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise ValueError("h2h_kernel must be odd (SAME padding "
                                 "keeps the state shape), got %r"
                                 % (self._h2h_kernel,))
        self._i2h_pad = tuple(k // 2 for k in self._i2h_kernel)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        self._activation = activation

        g = self._num_gates
        c_in = self._input_shape[0]
        self.i2h_weight = self.params.get(
            "i2h_weight",
            shape=(g * hidden_channels, c_in) + self._i2h_kernel,
            init=i2h_weight_initializer)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(g * hidden_channels, hidden_channels) + self._h2h_kernel,
            init=h2h_weight_initializer)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(g * hidden_channels,),
            init=i2h_bias_initializer)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(g * hidden_channels,),
            init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels) + self._input_shape[1:]
        layout = "NC" + "DHW"[3 - self._ndim:]
        return [{"shape": shape, "__layout__": layout}
                for _ in range(self._num_states)]

    def _alias(self):
        return "conv_rnn"

    def _projections(self, Fm, x, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        """(x*Wi + bi, h*Wh + bh) — all gate maps in two convolutions."""
        g = self._num_gates * self._hidden_channels
        xi = Fm.Convolution(x, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            num_filter=g)
        hh = Fm.Convolution(h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            num_filter=g)
        return xi, hh

    def _split(self, Fm, z):
        if self._num_gates == 1:
            return (z,)
        return tuple(Fm.split(z, num_outputs=self._num_gates, axis=1))


class _ConvRNN(_ConvCell):
    _num_gates = 1
    _num_states = 1

    def hybrid_forward(self, Fm, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        xi, hh = self._projections(Fm, inputs, states[0], i2h_weight,
                                   h2h_weight, i2h_bias, h2h_bias)
        h = _act_fn(self._activation)(xi + hh)
        return h, [h]


class _ConvLSTM(_ConvCell):
    """Gate maps ordered i, f, c̃, o on the channel axis (cuDNN order,
    same as gluon.rnn.LSTMCell)."""

    _num_gates = 4
    _num_states = 2

    def hybrid_forward(self, Fm, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h_prev, c_prev = states
        xi, hh = self._projections(Fm, inputs, h_prev, i2h_weight,
                                   h2h_weight, i2h_bias, h2h_bias)
        zi, zf, zc, zo = self._split(Fm, xi + hh)
        act = _act_fn(self._activation)
        c = Fm.sigmoid(zf) * c_prev + Fm.sigmoid(zi) * act(zc)
        h = Fm.sigmoid(zo) * act(c)
        return h, [h, c]


class _ConvGRU(_ConvCell):
    """Gate maps ordered r, z, n; the reset gate scales the HIDDEN half of
    the n-gate only, so the two projections stay separate (same contract
    as gluon.rnn.GRUCell)."""

    _num_gates = 3
    _num_states = 1

    def hybrid_forward(self, Fm, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h_prev = states[0]
        xi, hh = self._projections(Fm, inputs, h_prev, i2h_weight,
                                   h2h_weight, i2h_bias, h2h_bias)
        xr, xz, xn = self._split(Fm, xi)
        hr, hz, hn = self._split(Fm, hh)
        r = Fm.sigmoid(xr + hr)
        z = Fm.sigmoid(xz + hz)
        n = _act_fn(self._activation)(xn + r * hn)
        h = (1.0 - z) * n + z * h_prev
        return h, [h]


def _specialize(base, ndim, name, default_kernel):
    cls = type(name, (base,), {
        "_ndim": ndim,
        "__init__": (lambda self, input_shape, hidden_channels,
                     i2h_kernel=default_kernel, h2h_kernel=default_kernel,
                     **kw: base.__init__(self, input_shape, hidden_channels,
                                         i2h_kernel, h2h_kernel, **kw)),
        "__doc__": "%dD %s (reference conv_rnn_cell.py)"
        % (ndim, base.__doc__ or base.__name__),
    })
    return cls


Conv1DRNNCell = _specialize(_ConvRNN, 1, "Conv1DRNNCell", (3,))
Conv2DRNNCell = _specialize(_ConvRNN, 2, "Conv2DRNNCell", (3, 3))
Conv3DRNNCell = _specialize(_ConvRNN, 3, "Conv3DRNNCell", (3, 3, 3))
Conv1DLSTMCell = _specialize(_ConvLSTM, 1, "Conv1DLSTMCell", (3,))
Conv2DLSTMCell = _specialize(_ConvLSTM, 2, "Conv2DLSTMCell", (3, 3))
Conv3DLSTMCell = _specialize(_ConvLSTM, 3, "Conv3DLSTMCell", (3, 3, 3))
Conv1DGRUCell = _specialize(_ConvGRU, 1, "Conv1DGRUCell", (3,))
Conv2DGRUCell = _specialize(_ConvGRU, 2, "Conv2DGRUCell", (3, 3))
Conv3DGRUCell = _specialize(_ConvGRU, 3, "Conv3DGRUCell", (3, 3, 3))


class VariationalDropoutCell(ModifierCell):
    """Variational (locked) dropout: ONE mask per unroll, reused at every
    time step (Gal & Ghahramani 2016; reference
    gluon/contrib/rnn/rnn_cell.py VariationalDropoutCell).  Masks are
    sampled lazily on the first step after reset() via F.Dropout of a
    ones-tensor (so they carry the 1/keep scaling) and cached."""

    def __init__(self, base_cell, drop_inputs=0.2, drop_states=0.2,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self._drop_inputs = drop_inputs
        self._drop_states = drop_states
        self._drop_outputs = drop_outputs
        self._mask_in = None
        self._mask_state = None
        self._mask_out = None

    def reset(self):
        super().reset()
        self._mask_in = self._mask_state = self._mask_out = None

    def _alias(self):
        return "vardrop"

    def _mask(self, rate, like, cached):
        # masks exist only in training mode, like the Dropout layer
        if rate == 0.0 or not autograd.is_training():
            return None, cached
        if cached is None:
            cached = F.Dropout(F.ones_like(like), p=rate, mode="always")
        return cached, cached

    def hybrid_forward(self, Fm, inputs, states):
        m, self._mask_in = self._mask(self._drop_inputs, inputs,
                                      self._mask_in)
        if m is not None:
            inputs = inputs * m
        m, self._mask_state = self._mask(self._drop_states, states[0],
                                         self._mask_state)
        if m is not None:
            states = [states[0] * m] + list(states[1:])
        out, next_states = self.base_cell(inputs, states)
        m, self._mask_out = self._mask(self._drop_outputs, out,
                                       self._mask_out)
        if m is not None:
            out = out * m
        return out, next_states

    def __repr__(self):
        return "VariationalDropoutCell(%s)" % self.base_cell


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a learned projection of the hidden state (LSTMP, Sak et
    al. 2014; reference gluon/contrib/rnn/rnn_cell.py LSTMPCell).  The
    recurrent/output state is r = h·Wrᵀ of size `projection_size`, so h2h
    operates on the small projected state — the shape that makes big
    acoustic LSTMs tractable."""

    _num_states = 2

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        rows = 4 * hidden_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(rows, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(rows, projection_size),
            init=h2h_weight_initializer)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(rows,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(rows,), init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def _alias(self):
        return "lstmp"

    def hybrid_forward(self, Fm, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        r_prev, c_prev = states
        z = (Fm.dot(inputs, i2h_weight, transpose_b=True)
             + Fm.dot(r_prev, h2h_weight, transpose_b=True)
             + i2h_bias + h2h_bias)
        zi, zf, zc, zo = Fm.split(z, num_outputs=4, axis=1)
        c = Fm.sigmoid(zf) * c_prev + Fm.sigmoid(zi) * Fm.tanh(zc)
        h = Fm.sigmoid(zo) * Fm.tanh(c)
        r = Fm.dot(h, h2r_weight, transpose_b=True)
        return r, [r, c]
