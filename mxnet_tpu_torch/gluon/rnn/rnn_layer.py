"""Fused recurrent layers: RNN, LSTM, GRU (counterpart of
``mxnet_tpu.gluon.rnn.rnn_layer``; reference
``python/mxnet/gluon/rnn/rnn_layer.py``).

A layer holds per-layer, per-direction gate-stacked i2h/h2h weights and
biases, as the reference does, so parameter files map one to one; each
call concatenates them into the flat blob of ``rnn/_fused_layout.py``
and runs the registered ``RNN`` op (``ops/rnn.py``: cuDNN's recurrence
on the card), through which the gradient reaches every parameter.
``_collect_params_with_prefix`` names the parameters as the unfused
cells would (``_unfused.0.l_cell.i2h_weight``) and ``_unfuse`` builds
those cells.
"""
from __future__ import annotations

import re

from ... import ndarray as nd_module
from ...ndarray.ndarray import NDArray
from ..block import HybridBlock
from . import rnn_cell

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """Implementation of recurrent layers (reference: rnn_layer.py:38)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None,
                 h2r_weight_initializer=None, lstm_state_clip_min=None,
                 lstm_state_clip_max=None, lstm_state_clip_nan=False,
                 dtype="float32", **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._projection_size = projection_size if projection_size else None
        if self._projection_size:
            raise NotImplementedError(
                "projection_size is a cuDNN-only extension in the reference "
                "(rnn-inl.h MXNET_USE_CUDNN_GE_7200); not supported.")
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._dtype = dtype
        self._lstm_state_clip_min = lstm_state_clip_min
        self._lstm_state_clip_max = lstm_state_clip_max
        self._lstm_state_clip_nan = lstm_state_clip_nan

        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param("{}{}_i2h_weight".format(j, i),
                                     shape=(ng * nh, ni),
                                     init=i2h_weight_initializer, dtype=dtype)
                self._register_param("{}{}_h2h_weight".format(j, i),
                                     shape=(ng * nh, nh),
                                     init=h2h_weight_initializer, dtype=dtype)
                self._register_param("{}{}_i2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=i2h_bias_initializer, dtype=dtype)
                self._register_param("{}{}_h2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=h2h_bias_initializer, dtype=dtype)
            ni = nh * self._dir

    def _register_param(self, name, shape, init, dtype):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True, dtype=dtype)
        setattr(self, name, p)  # Block.__setattr__ registers into _reg_params
        return p

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "{0} -> {1}".format(
            shape[1] if shape[1] else None, shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        pattern = re.compile(r"(l|r)(\d)_(i2h|h2h)_(weight|bias)\Z")
        def convert_key(m, bidirectional):
            d, l, g, t = [m.group(i) for i in range(1, 5)]
            if bidirectional:
                return "_unfused.{}.{}_cell.{}_{}".format(l, d, g, t)
            return "_unfused.{}.{}_{}".format(l, g, t)
        bidirectional = any(pattern.match(p).group(1) == "r"
                            for p in self._reg_params)
        ret = {prefix + convert_key(pattern.match(key), bidirectional): val
               for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _unfuse(self):
        """Unfuses the fused RNN into a stack of rnn cells
        (reference: rnn_layer.py:170)."""
        assert not self._projection_size, \
            "_unfuse does not support projection layer yet!"
        get_cell = {
            "rnn_relu": lambda **kwargs: rnn_cell.RNNCell(
                self._hidden_size, activation="relu", **kwargs),
            "rnn_tanh": lambda **kwargs: rnn_cell.RNNCell(
                self._hidden_size, activation="tanh", **kwargs),
            "lstm": lambda **kwargs: rnn_cell.LSTMCell(
                self._hidden_size, **kwargs),
            "gru": lambda **kwargs: rnn_cell.GRUCell(
                self._hidden_size, **kwargs)}[self._mode]
        stack = rnn_cell.HybridSequentialRNNCell(prefix=self.prefix,
                                                 params=self.params)
        with stack.name_scope():
            ni = self._input_size
            for i in range(self._num_layers):
                kwargs = {
                    "input_size": ni,
                    "i2h_weight_initializer": self._i2h_weight_initializer,
                    "h2h_weight_initializer": self._h2h_weight_initializer,
                    "i2h_bias_initializer": self._i2h_bias_initializer,
                    "h2h_bias_initializer": self._h2h_bias_initializer}
                if self._dir == 2:
                    stack.add(rnn_cell.BidirectionalCell(
                        get_cell(prefix="l%d_" % i, **kwargs),
                        get_cell(prefix="r%d_" % i, **kwargs)))
                else:
                    stack.add(get_cell(prefix="l%d_" % i, **kwargs))
                if self._dropout > 0 and i != self._num_layers - 1:
                    stack.add(rnn_cell.DropoutCell(self._dropout))
                ni = self._hidden_size * self._dir
        return stack

    def cast(self, dtype):
        super().cast(dtype)
        self._dtype = dtype

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial recurrent state (reference: rnn_layer.py:214)."""
        if func is None:
            func = nd_module.zeros
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(name="%sh0_%d" % (self.prefix, i), **info))
        return states

    def infer_shape(self, inputs, *args):
        if self._input_size == 0:
            ni = inputs.shape[2] if self._layout == "TNC" else inputs.shape[2]
            self._input_size = ni
            ng, nh = self._gates, self._hidden_size
            for i in range(self._num_layers):
                for j in ["l", "r"][:self._dir]:
                    name = "{}{}_i2h_weight".format(j, i)
                    self._reg_params[name].shape = (ng * nh, ni)
                ni = nh * self._dir

    def __call__(self, inputs, states=None, sequence_length=None, **kwargs):
        self.skip_states = states is None
        if states is None:
            if isinstance(inputs, NDArray):
                batch_size = inputs.shape[self._layout.find("N")]
                states = self.begin_state(batch_size,
                                          ctx=inputs.context,
                                          dtype=inputs.dtype)
            else:
                raise ValueError("inputs must be NDArray")
        if isinstance(states, NDArray):
            states = [states]
        if sequence_length is not None:
            return super().__call__(inputs, states, sequence_length, **kwargs)
        return super().__call__(inputs, states, **kwargs)

    def forward(self, inputs, states, sequence_length=None):
        # states arrives as a list; run the eager/hybrid machinery directly
        return self._eager_forward(inputs, states, sequence_length)

    def _eager_forward(self, inputs, states, sequence_length=None):
        params = self._get_params_nd(inputs)
        out = self.hybrid_forward(nd_module, inputs, states, sequence_length,
                                  **params)
        return out

    def hybrid_forward(self, F, inputs, states, sequence_length=None,
                       **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, 0, 1)
        # assemble the cuDNN-layout flat parameter blob: all weights
        # (layer-major, direction-minor, i2h then h2h), then all biases
        blob = []
        for t in ("weight", "bias"):
            for i in range(self._num_layers):
                for j in ["l", "r"][:self._dir]:
                    for g in ("i2h", "h2h"):
                        blob.append(F.reshape(
                            params["{}{}_{}_{}".format(j, i, g, t)],
                            shape=(-1,)))
        flat = F.concat(*blob, dim=0)

        from ... import autograd
        if self._mode == "lstm":
            h0, c0 = states
            out = F.RNN(inputs, flat, h0, c0, state_size=self._hidden_size,
                        num_layers=self._num_layers,
                        bidirectional=self._dir == 2, mode=self._mode,
                        p=self._dropout, training=autograd.is_training(),
                        lstm_state_clip_min=self._lstm_state_clip_min,
                        lstm_state_clip_max=self._lstm_state_clip_max,
                        use_sequence_length=sequence_length is not None,
                        sequence_length=sequence_length)
            outputs, h_n, c_n = out
            new_states = [h_n, c_n]
        else:
            h0 = states[0]
            out = F.RNN(inputs, flat, h0, state_size=self._hidden_size,
                        num_layers=self._num_layers,
                        bidirectional=self._dir == 2, mode=self._mode,
                        p=self._dropout, training=autograd.is_training(),
                        use_sequence_length=sequence_length is not None,
                        sequence_length=sequence_length)
            outputs, h_n, _ = out
            new_states = [h_n]

        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, 0, 1)
        if self.skip_states:
            return outputs
        return outputs, new_states


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with tanh or ReLU (reference:
    rnn_layer.py:271)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC",
                 "dtype": self._dtype}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference: rnn_layer.py:372)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, h2r_weight_initializer=None,
                 state_clip_min=None, state_clip_max=None,
                 state_clip_nan=False, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", projection_size,
                         h2r_weight_initializer, state_clip_min,
                         state_clip_max, state_clip_nan, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC",
                 "dtype": self._dtype},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC",
                 "dtype": self._dtype}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference: rnn_layer.py:496)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC",
                 "dtype": self._dtype}]
