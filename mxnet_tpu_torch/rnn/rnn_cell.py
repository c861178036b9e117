"""Legacy symbolic RNN cells, the ``mx.rnn`` namespace (counterpart of
``mxnet_tpu.rnn.rnn_cell``).

Reference: python/mxnet/rnn/rnn_cell.py (RNNParams:78, BaseRNNCell:108,
RNNCell:362, LSTMCell:408, GRUCell:469, FusedRNNCell:536,
SequentialRNNCell:748, DropoutCell:827, ModifierCell:867, ZoneoutCell:909,
ResidualCell:957, BidirectionalCell:998, conv cells:1094+).  These build
*unrolled Symbol graphs* for Module/BucketingModule training: the
pre-Gluon LSTM-LM path (example/rnn/bucketing).

An unrolled cell is one graph a bucket length, which the Executor
interprets op by op; ``FusedRNNCell`` lowers to the registered ``RNN``
op (``ops/rnn.py``: cuDNN's recurrence on the card) over its one flat
parameter blob (``_fused_layout.py``).  Batch-agnostic ``begin_state``
zeros use the shape-0 convention; they lower to size-1 dims that
broadcasting carries (``symbol.py`` ``_fill_shape``).
"""
from __future__ import annotations

import functools

import numpy as _np

from .. import symbol
from .. import initializer as init
from ..base import numeric_types, string_types
from ._fused_layout import (fused_rnn_regions, fused_rnn_param_size,
                            fused_rnn_num_input, GATES)

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell",
           "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "ConvRNNCell", "ConvLSTMCell",
           "ConvGRUCell"]


class RNNParams(object):
    """Container of shared Variables for weight tying between cells
    (reference rnn_cell.py:78)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


def _cells_state_info(cells):
    return sum([c.state_info for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Canonicalize between one time-concatenated Symbol and a per-step
    list (reference rnn_cell.py:51)."""
    assert inputs is not None, \
        "unroll(inputs=None) is not supported: symbolic cells need the " \
        "input symbol to build the graph"
    axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, symbol.Symbol):
        if merge is False:
            assert len(inputs.list_outputs()) == 1, \
                "unroll takes a single-output symbol (got a group)"
            inputs = list(symbol.SliceChannel(inputs, axis=in_axis,
                                              num_outputs=length,
                                              squeeze_axis=1))
            in_axis = axis
    else:
        assert length is None or len(inputs) == length
        if merge is True:
            inputs = [symbol.expand_dims(i, axis=axis) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=axis)
            in_axis = axis
    if isinstance(inputs, symbol.Symbol) and axis != in_axis:
        inputs = symbol.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis


def _as_numpy(arr):
    return arr.asnumpy() if hasattr(arr, "asnumpy") else _np.asarray(arr)


class BaseRNNCell(object):
    """Abstract symbolic RNN cell (reference rnn_cell.py:108)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        """Reset step counters before building another graph."""
        self._init_counter = -1
        self._counter = -1
        if hasattr(self, "_cells"):
            for cell in self._cells:
                cell.reset()

    def __call__(self, inputs, states):
        """One step: (inputs (B, C), states) -> (output, new states)."""
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """Initial-state symbols; 0 dims mean batch-agnostic (resolved by
        broadcasting, see symbol.py _fill_shape)."""
        assert not self._modified, \
            "After applying modifier cells (e.g. DropoutCell) the base " \
            "cell cannot be called directly. Call the modifier cell instead."
        states = []
        for info in self.state_info:
            self._init_counter += 1
            fkw = dict(kwargs)
            if info is not None:
                fkw.update(info)
            states.append(func(name="%sbegin_state_%d"
                               % (self._prefix, self._init_counter), **fkw))
        return states

    def unpack_weights(self, args):
        """Split gate-stacked i2h/h2h arrays into per-gate entries
        (reference rnn_cell.py:225)."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            w = _as_numpy(args.pop("%s%s_weight" % (self._prefix, group)))
            b = _as_numpy(args.pop("%s%s_bias" % (self._prefix, group)))
            for j, gate in enumerate(self._gate_names):
                args["%s%s%s_weight" % (self._prefix, group, gate)] = \
                    _array(w[j * h:(j + 1) * h].copy())
                args["%s%s%s_bias" % (self._prefix, group, gate)] = \
                    _array(b[j * h:(j + 1) * h].copy())
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights (reference rnn_cell.py:266)."""
        args = dict(args)
        if not self._gate_names:
            return args
        for group in ("i2h", "h2h"):
            ws, bs = [], []
            for gate in self._gate_names:
                ws.append(_as_numpy(args.pop(
                    "%s%s%s_weight" % (self._prefix, group, gate))))
                bs.append(_as_numpy(args.pop(
                    "%s%s%s_bias" % (self._prefix, group, gate))))
            args["%s%s_weight" % (self._prefix, group)] = \
                _array(_np.concatenate(ws, axis=0))
            args["%s%s_bias" % (self._prefix, group)] = \
                _array(_np.concatenate(bs, axis=0))
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll across ``length`` steps (reference rnn_cell.py:295)."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, string_types):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


def _array(a):
    from ..ndarray import array
    return array(a)


class RNNCell(BaseRNNCell):
    """Elman (simple) RNN cell (reference rnn_cell.py:362)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell with cuDNN gate order i,f,c,o (reference
    rnn_cell.py:408)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        # forget_bias folds into i2h_bias so the forget gate starts open
        self._iB = self.params.get(
            "i2h_bias", init=init.LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = symbol.SliceChannel(i2h + h2h, num_outputs=4,
                                    name="%sslice" % name)
        in_gate = symbol.Activation(gates[0], act_type="sigmoid",
                                    name="%si" % name)
        forget_gate = symbol.Activation(gates[1], act_type="sigmoid",
                                        name="%sf" % name)
        in_transform = symbol.Activation(gates[2], act_type="tanh",
                                         name="%sc" % name)
        out_gate = symbol.Activation(gates[3], act_type="sigmoid",
                                     name="%so" % name)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, cuDNN variant with gate order r,z,o (reference
    rnn_cell.py:469)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = symbol.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(prev_h, weight=self._hW, bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_r, i2h_z, i2h_n = symbol.SliceChannel(
            i2h, num_outputs=3, name="%si2h_slice" % name)
        h2h_r, h2h_z, h2h_n = symbol.SliceChannel(
            h2h, num_outputs=3, name="%sh2h_slice" % name)
        reset = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                  name="%sr_act" % name)
        update = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                   name="%sz_act" % name)
        next_h_tmp = symbol.Activation(i2h_n + reset * h2h_n,
                                       act_type="tanh",
                                       name="%sh_act" % name)
        next_h = (1.0 - update) * next_h_tmp + update * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence fused RNN over the registry's ``RNN`` op (reference
    rnn_cell.py:536)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        self._parameter = self.params.get(
            "parameters", init=init.FusedRNN(None, num_hidden, num_layers,
                                             mode, bidirectional,
                                             forget_bias))

    @property
    def state_info(self):
        b = (1 + self._bidirectional)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (b * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"} for _ in range(n)]

    @property
    def _gate_names(self):
        return GATES[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _blob_regions(self, num_input):
        return fused_rnn_regions(num_input, self._num_hidden,
                                 self._num_layers, self._mode,
                                 self._bidirectional, self._prefix)[0]

    def unpack_weights(self, args):
        args = dict(args)
        arr = _as_numpy(args.pop(self._parameter.name))
        ni = fused_rnn_num_input(arr.size, self._num_hidden,
                                 self._num_layers, self._mode,
                                 self._bidirectional)
        for name, off, shape, _ in self._blob_regions(ni):
            size = int(_np.prod(shape))
            args[name] = _array(arr[off:off + size].reshape(shape).copy())
        return args

    def pack_weights(self, args):
        args = dict(args)
        first = "%sl0_i2h%s_weight" % (self._prefix, self._gate_names[0])
        ni = _as_numpy(args[first]).shape[1]
        total = fused_rnn_param_size(ni, self._num_hidden, self._num_layers,
                                     self._mode, self._bidirectional)
        flat = _np.zeros((total,), dtype=_as_numpy(args[first]).dtype)
        for name, off, shape, _ in self._blob_regions(ni):
            size = int(_np.prod(shape))
            flat[off:off + size] = _as_numpy(args.pop(name)).reshape(-1)
        args[self._parameter.name] = _array(flat)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell runs whole sequences (one RNN op); use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:  # NTC -> the RNN op wants TNC
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state()
        state_kw = {"state": begin_state[0]}
        if self._mode == "lstm":
            state_kw["state_cell"] = begin_state[1]
        rnn = symbol.RNN(inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional,
                         p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode, name=self._prefix + "rnn",
                         **state_kw)
        outputs = rnn[0]
        if not self._get_next_state:
            states = []
        elif self._mode == "lstm":
            states = [rnn[1], rnn[2]]
        else:
            states = [rnn[1]]
        if axis == 1:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs, in_layout=layout)
        return outputs, states

    def unfuse(self):
        """Equivalent stack of per-step cells, for stepping / export
        (reference rnn_cell.py:718)."""
        stack = SequentialRNNCell()
        make = {"rnn_relu": lambda pre: RNNCell(self._num_hidden,
                                                activation="relu",
                                                prefix=pre),
                "rnn_tanh": lambda pre: RNNCell(self._num_hidden,
                                                activation="tanh",
                                                prefix=pre),
                "lstm": lambda pre: LSTMCell(self._num_hidden, prefix=pre),
                "gru": lambda pre: GRUCell(self._num_hidden,
                                           prefix=pre)}[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make("%sl%d_" % (self._prefix, i)),
                    make("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(make("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_"
                                      % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order per step (reference
    rnn_cell.py:748)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                "Either specify params for SequentialRNNCell " \
                "or child cells, not both."
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified, \
            "After applying modifier cells (e.g. ZoneoutCell) the base " \
            "cell cannot be called directly. Call the modifier cell instead."
        return _cells_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell), \
                "BidirectionalCell can only be used at the bottom of a " \
                "stack (it cannot be stepped)"
            n = len(cell.state_info)
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Stateless dropout-on-input cell (reference rnn_cell.py:827)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        assert isinstance(dropout, numeric_types), \
            "dropout probability must be a number"
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout,
                                        merge_outputs)
        if isinstance(inputs, symbol.Symbol):
            return self(inputs, [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


class ModifierCell(BaseRNNCell):
    """Base for cells that wrap another cell (reference
    rnn_cell.py:867)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified, \
            "After applying modifier cells (e.g. DropoutCell) the base " \
            "cell cannot be called directly. Call the modifier cell instead."
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout regularization on a base cell's outputs/states (reference
    rnn_cell.py:909; Krueger et al. 2016)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, FusedRNNCell), \
            "zoneout needs a steppable cell: unfuse() the FusedRNNCell first"
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout since it doesn't " \
            "support step. Please add ZoneoutCell to the cells underneath " \
            "instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        p_out, p_state = self.zoneout_outputs, self.zoneout_states
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev_output = self.prev_output
        if prev_output is None:
            prev_output = symbol.zeros((0, 0))
        output = symbol.where(mask(p_out, next_output), next_output,
                              prev_output) if p_out != 0. else next_output
        states = [symbol.where(mask(p_state, ns), ns, os)
                  for ns, os in zip(next_states, states)] \
            if p_state != 0. else next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """output = base(output) + input (reference rnn_cell.py:957; Wu et
    al. 2016)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs,
                                     name="%s_plus_residual" % output.name)
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, symbol.Symbol) \
            if merge_outputs is None else merge_outputs
        inputs, _ = _normalize_sequence(length, inputs, layout,
                                        merge_outputs)
        if merge_outputs:
            outputs = symbol.elemwise_add(
                outputs, inputs, name="%s_plus_residual" % outputs.name)
        else:
            outputs = [symbol.elemwise_add(o, i,
                                           name="%s_plus_residual" % o.name)
                       for o, i in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """Unrolls a forward and a time-reversed cell and concatenates their
    per-step outputs (reference rnn_cell.py:998)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params, \
                "Either specify params for BidirectionalCell " \
                "or child cells, not both."
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell needs the whole sequence (the reverse pass "
            "reads the future); use unroll")

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified, \
            "After applying modifier cells (e.g. DropoutCell) the base " \
            "cell cannot be called directly. Call the modifier cell instead."
        return _cells_begin_state(self._cells, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=merge_outputs)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=merge_outputs)
        if merge_outputs is None:
            merge_outputs = (isinstance(l_outputs, symbol.Symbol)
                             and isinstance(r_outputs, symbol.Symbol))
            if not merge_outputs:
                if isinstance(l_outputs, symbol.Symbol):
                    l_outputs = list(symbol.SliceChannel(
                        l_outputs, axis=axis, num_outputs=length,
                        squeeze_axis=1))
                if isinstance(r_outputs, symbol.Symbol):
                    r_outputs = list(symbol.SliceChannel(
                        r_outputs, axis=axis, num_outputs=length,
                        squeeze_axis=1))
        if merge_outputs:
            l_outputs = [l_outputs]
            r_outputs = [symbol.reverse(r_outputs, axis=axis)]
        else:
            r_outputs = list(reversed(r_outputs))
        outputs = [symbol.Concat(l_o, r_o, dim=1 + merge_outputs,
                                 name=("%sout" % self._output_prefix
                                       if merge_outputs
                                       else "%st%d"
                                       % (self._output_prefix, i)))
                   for i, (l_o, r_o) in enumerate(zip(l_outputs,
                                                      r_outputs))]
        if merge_outputs:
            outputs = outputs[0]
        states = [l_states, r_states]
        return outputs, states


class BaseConvRNNCell(BaseRNNCell):
    """Convolutional recurrent cells: both projections are Convolutions
    over spatial feature maps (reference rnn_cell.py:1094)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel, h2h_dilate,
                 i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                 i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, activation,
                 prefix="", params=None, conv_layout="NCHW"):
        super().__init__(prefix=prefix, params=params)
        assert h2h_kernel[0] % 2 == 1 and h2h_kernel[1] % 2 == 1, \
            "h2h_kernel must be odd so same-padding preserves the state's "\
            "spatial dims; got %s" % (h2h_kernel,)
        self._h2h_kernel = h2h_kernel
        # "same" padding keeps the state's spatial dims step-invariant
        self._h2h_pad = (h2h_dilate[0] * (h2h_kernel[0] - 1) // 2,
                         h2h_dilate[1] * (h2h_kernel[1] - 1) // 2)
        self._h2h_dilate = h2h_dilate
        self._i2h_kernel = i2h_kernel
        self._i2h_stride = i2h_stride
        self._i2h_pad = i2h_pad
        self._i2h_dilate = i2h_dilate
        self._num_hidden = num_hidden
        self._input_shape = input_shape
        self._conv_layout = conv_layout
        self._activation = activation

        # state spatial shape = i2h conv output shape at this input shape
        probe = symbol.Convolution(symbol.Variable("data"),
                                   num_filter=num_hidden,
                                   kernel=i2h_kernel, stride=i2h_stride,
                                   pad=i2h_pad, dilate=i2h_dilate,
                                   layout=conv_layout)
        out_shape = probe.infer_shape(data=input_shape)[1][0]
        self._state_shape = (0,) + tuple(out_shape[1:])

        self._iW = self.params.get("i2h_weight",
                                   init=i2h_weight_initializer)
        self._hW = self.params.get("h2h_weight",
                                   init=h2h_weight_initializer)
        self._iB = self.params.get("i2h_bias", init=i2h_bias_initializer)
        self._hB = self.params.get("h2h_bias", init=h2h_bias_initializer)

    @property
    def _num_gates(self):
        return len(self._gate_names)

    @property
    def state_info(self):
        return [{"shape": self._state_shape,
                 "__layout__": self._conv_layout},
                {"shape": self._state_shape,
                 "__layout__": self._conv_layout}]

    def _conv_forward(self, inputs, states, name):
        i2h = symbol.Convolution(inputs, weight=self._iW, bias=self._iB,
                                 num_filter=self._num_hidden
                                 * self._num_gates,
                                 kernel=self._i2h_kernel,
                                 stride=self._i2h_stride,
                                 pad=self._i2h_pad,
                                 dilate=self._i2h_dilate,
                                 layout=self._conv_layout,
                                 name="%si2h" % name)
        h2h = symbol.Convolution(states[0], weight=self._hW, bias=self._hB,
                                 num_filter=self._num_hidden
                                 * self._num_gates,
                                 kernel=self._h2h_kernel,
                                 stride=(1, 1),
                                 pad=self._h2h_pad,
                                 dilate=self._h2h_dilate,
                                 layout=self._conv_layout,
                                 name="%sh2h" % name)
        return i2h, h2h

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BaseConvRNNCell is abstract class for convolutional RNN")


_LEAKY = functools.partial(symbol.LeakyReLU, act_type="leaky", slope=0.2)


class ConvRNNCell(BaseConvRNNCell):
    """Convolutional Elman RNN cell (reference rnn_cell.py:1176)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1),
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer=None, h2h_bias_initializer=None,
                 activation=_LEAKY, prefix="ConvRNN_", params=None,
                 conv_layout="NCHW"):
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer or init.Zero(),
                         h2h_bias_initializer or init.Zero(), activation,
                         prefix=prefix, params=params,
                         conv_layout=conv_layout)

    @property
    def _gate_names(self):
        return ("",)

    @property
    def state_info(self):
        return [{"shape": self._state_shape,
                 "__layout__": self._conv_layout}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class ConvLSTMCell(BaseConvRNNCell):
    """Convolutional LSTM (reference rnn_cell.py:1253; Xingjian et al.
    2015)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1),
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer=None, h2h_bias_initializer=None,
                 activation=_LEAKY, prefix="ConvLSTM_", params=None,
                 forget_bias=1.0, conv_layout="NCHW"):
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer
                         or init.LSTMBias(forget_bias=forget_bias),
                         h2h_bias_initializer or init.Zero(), activation,
                         prefix=prefix, params=params,
                         conv_layout=conv_layout)

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name)
        gates = symbol.SliceChannel(i2h + h2h, num_outputs=4,
                                    name="%sslice" % name)
        in_gate = symbol.Activation(gates[0], act_type="sigmoid",
                                    name="%si" % name)
        forget_gate = symbol.Activation(gates[1], act_type="sigmoid",
                                        name="%sf" % name)
        in_transform = self._get_activation(gates[2], self._activation,
                                            name="%sc" % name)
        out_gate = symbol.Activation(gates[3], act_type="sigmoid",
                                     name="%so" % name)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(next_c, self._activation,
                                                 name="%sout" % name)
        return next_h, [next_h, next_c]


class ConvGRUCell(BaseConvRNNCell):
    """Convolutional GRU (reference rnn_cell.py:1349)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1),
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer=None, h2h_bias_initializer=None,
                 activation=_LEAKY, prefix="ConvGRU_", params=None,
                 conv_layout="NCHW"):
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer or init.Zero(),
                         h2h_bias_initializer or init.Zero(), activation,
                         prefix=prefix, params=params,
                         conv_layout=conv_layout)

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    @property
    def state_info(self):
        return [{"shape": self._state_shape,
                 "__layout__": self._conv_layout}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name)
        i2h_r, i2h_z, i2h_n = symbol.SliceChannel(
            i2h, num_outputs=3, name="%si2h_slice" % name)
        h2h_r, h2h_z, h2h_n = symbol.SliceChannel(
            h2h, num_outputs=3, name="%sh2h_slice" % name)
        reset = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                  name="%sr_act" % name)
        update = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                   name="%sz_act" % name)
        next_h_tmp = self._get_activation(i2h_n + reset * h2h_n,
                                          self._activation,
                                          name="%sh_act" % name)
        next_h = (1.0 - update) * next_h_tmp + update * states[0]
        return next_h, [next_h]
