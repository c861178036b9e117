"""Recurrent cells (counterpart of ``mxnet_tpu.gluon.rnn.rnn_cell``;
reference ``python/mxnet/gluon/rnn/rnn_cell.py``): the ``RecurrentCell``
base with ``begin_state``/``unroll``, the RNN/LSTM/GRU cells, the
Sequential/Bidirectional stacks and the Dropout/Zoneout/Residual
modifiers.

As in the JAX package, every cell computes ONE projection ``x·Wiᵀ + h·Whᵀ
+ b`` covering all gates and carves the gates out of it (GRU keeps its
n-gate's two halves apart); ``unroll`` is a Python loop over a step list,
with variable-length sequences masked inside the loop (state frozen,
output zeroed once a sequence has ended); the backward direction of a
bidirectional unroll reverses each sequence with ``SequenceReverse``, so
it reads real tokens first.  Each step runs the registered ops through
``mx.nd``, so the tape records it like any other forward.
"""
from __future__ import annotations

from ... import ndarray as F
from ..block import Block, HybridBlock
from ..parameter import tensor_types

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


# --------------------------------------------------------------- sequences
#
# A sequence enters `unroll` either as one stacked array (time somewhere in
# `layout`) or as a per-step list.  Internally everything runs on the step
# list; these two helpers are the only place layout strings are interpreted.

def _as_steps(inputs, layout):
    """Normalize to ``(step_list, time_axis, batch_size)``.

    Steps are rank-reduced slices along the time axis; for a step the batch
    dimension is always leading, regardless of the input layout.
    """
    t_ax = layout.find("T")
    if isinstance(inputs, tensor_types):
        n_steps = inputs.shape[t_ax]
        pieces = F.split(inputs, num_outputs=n_steps, axis=t_ax,
                         squeeze_axis=False)
        if n_steps == 1:
            pieces = [pieces]
        steps = [p.squeeze(axis=t_ax) for p in pieces]
        return steps, t_ax, inputs.shape[layout.find("N")]
    steps = list(inputs)
    return steps, t_ax, steps[0].shape[0]


def _restack(steps, time_axis):
    """Inverse of `_as_steps` for merged output."""
    return F.stack(*steps, axis=time_axis)


def _keep_mask(valid_length, t, like):
    """Broadcastable bool: does example b still have a token at step t?"""
    alive = valid_length > t                      # (B,)
    return alive.reshape((-1,) + (1,) * (len(like.shape) - 1))


def _act_fn(name_or_block):
    """Resolve an activation spec to an NDArray-level callable."""
    if callable(name_or_block):
        return name_or_block
    table = {"tanh": F.tanh, "relu": F.relu, "sigmoid": F.sigmoid,
             "softsign": F.softsign}
    if name_or_block in table:
        return table[name_or_block]
    return lambda x: F.Activation(x, act_type=name_or_block)


# ------------------------------------------------------------------- bases

class RecurrentCell(Block):
    """Abstract per-step recurrent unit.

    Capability contract (reference rnn_cell.py:81): `state_info`,
    `begin_state`, `__call__(x_t, states) -> (out, new_states)`, and
    `unroll` over a sequence.
    """

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Clear per-unroll bookkeeping so the cell can run a new sequence."""
        self._counter = -1
        self._init_counter = -1
        for child in self._children.values():
            child.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Build the step-0 state list from `state_info`."""
        if self._modified:
            raise RuntimeError(
                "cell %s was wrapped by a modifier (Zoneout/Residual/...); "
                "request begin_state from the wrapper" % self.name)
        make = func if func is not None else F.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            spec = dict(info or {})
            spec.pop("__layout__", None)
            spec.update(kwargs)
            states.append(make(**spec))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over a whole sequence.

        With `valid_length`, masking happens inside the loop: once step t
        passes a sequence's end its output is zeroed and its state frozen,
        which makes the returned states exactly the last-valid-step states
        (the arithmetic equivalent of the reference's SequenceLast).
        """
        self.reset()
        steps, t_ax, batch = _as_steps(inputs, layout)
        if length is not None and len(steps) != length:
            raise ValueError("unroll length %d != sequence length %d"
                             % (length, len(steps)))
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size=batch)
        outs = []
        for t, x_t in enumerate(steps):
            y, stepped = self(x_t, states)
            if valid_length is not None:
                y = F.where(_keep_mask(valid_length, t, y),
                            y, F.zeros_like(y))
                states = [F.where(_keep_mask(valid_length, t, ns), ns, s)
                          for ns, s in zip(stepped, states)]
            else:
                states = stepped
            outs.append(y)
        if merge_outputs:
            return _restack(outs, t_ax), states
        return outs, states

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """RecurrentCell whose step is expressed via hybrid_forward."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        return self._eager_forward(inputs, states)

    def _eager_forward(self, inputs, states):
        params = self._get_params_nd(inputs)
        return self.hybrid_forward(F, inputs, states, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


# -------------------------------------------------------------- gate cells

class _GatedCell(HybridRecurrentCell):
    """Shared machinery for RNN/LSTM/GRU: fused projections + param setup.

    Weight layout matches the fused RNN op (and cuDNN): i2h (G*H, in),
    h2h (G*H, H), gate blocks stacked along rows.
    """

    _num_gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        rows = self._num_gates * hidden_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(rows, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(rows, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(rows,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(rows,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._num_gates * self._hidden_size,
                                 x.shape[-1])

    def state_info(self, batch_size=0):
        one = {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}
        return [dict(one) for _ in range(self._num_states)]

    _num_states = 1

    def _project(self, F, x, h, i2h_weight, h2h_weight, i2h_bias, h2h_bias):
        """All gates in one shot: (B, G*H)."""
        return (F.dot(x, i2h_weight, transpose_b=True)
                + F.dot(h, h2h_weight, transpose_b=True)
                + i2h_bias + h2h_bias)

    def _gates(self, z):
        """Carve the fused projection into G (B, H) blocks."""
        if self._num_gates == 1:
            return (z,)
        return tuple(F.split(z, num_outputs=self._num_gates, axis=1))

    def __repr__(self):
        shape = self.i2h_weight.shape
        detail = "%s -> %s" % (shape[1] if shape[1] else None, shape[0])
        extra = getattr(self, "_activation", None)
        if isinstance(extra, str) and type(self) is RNNCell:
            detail += ", %s" % extra
        return "%s(%s)" % (self.__class__.__name__, detail)


class RNNCell(_GatedCell):
    """Elman step: h' = act(x·Wiᵀ + h·Whᵀ + bi + bh)."""

    _num_gates = 1
    _num_states = 1

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        # positional order matches the reference API (rnn_cell.py:300)
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        z = self._project(F, inputs, states[0], i2h_weight, h2h_weight,
                          i2h_bias, h2h_bias)
        h = _act_fn(self._activation)(z)
        return h, [h]


class LSTMCell(_GatedCell):
    """LSTM step, gate rows ordered i, f, c̃, o (cuDNN order).

    c' = σ(f)·c + σ(i)·act(c̃);  h' = σ(o)·act(c')
    """

    _num_gates = 4
    _num_states = 2

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, activation="tanh",
                 recurrent_activation="sigmoid"):
        # positional order matches the reference API (rnn_cell.py:398)
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation
        self._recurrent_activation = recurrent_activation

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h_prev, c_prev = states
        act = _act_fn(self._activation)
        gate = _act_fn(self._recurrent_activation)
        z = self._project(F, inputs, h_prev, i2h_weight, h2h_weight,
                          i2h_bias, h2h_bias)
        zi, zf, zc, zo = self._gates(z)
        c = gate(zf) * c_prev + gate(zi) * act(zc)
        h = gate(zo) * act(c)
        return h, [h, c]


class GRUCell(_GatedCell):
    """GRU step, gate rows ordered r, z, n (cuDNN order).

    n = tanh(xn + r·hn)  with the reset gate applied to the *hidden*
    projection only, so the input and hidden halves of the n-gate must stay
    separate — the one place the fused projection is computed as two parts.
    """

    _num_gates = 3
    _num_states = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        # positional order matches the reference API (rnn_cell.py:525)
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h_prev = states[0]
        xz = F.dot(inputs, i2h_weight, transpose_b=True) + i2h_bias
        hz = F.dot(h_prev, h2h_weight, transpose_b=True) + h2h_bias
        xr, xu, xn = F.split(xz, num_outputs=3, axis=1)
        hr, hu, hn = F.split(hz, num_outputs=3, axis=1)
        reset = F.sigmoid(xr + hr)
        update = F.sigmoid(xu + hu)
        cand = F.tanh(xn + reset * hn)
        h = update * h_prev + (1 - update) * cand
        return h, [h]


# ------------------------------------------------------------------ stacks

class _CellStack:
    """State routing shared by the two sequential containers: a flat state
    list is carved per child by each child's own state arity."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        infos = []
        for cell in self._children.values():
            infos.extend(cell.state_info(batch_size))
        return infos

    def begin_state(self, **kwargs):
        assert not self._modified
        states = []
        for cell in self._children.values():
            states.extend(cell.begin_state(**kwargs))
        return states

    def _carve_states(self, states):
        """Yield (cell, its slice of the flat state list)."""
        at = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            yield cell, states[at:at + n]
            at += n

    def _stacked_call(self, inputs, states):
        self._counter += 1
        out_states = []
        for cell, sub in self._carve_states(states):
            if isinstance(cell, BidirectionalCell):
                raise TypeError("BidirectionalCell cannot be stepped; "
                                "use unroll")
            inputs, sub = cell(inputs, sub)
            out_states.extend(sub)
        return inputs, out_states

    def _stacked_unroll(self, length, inputs, begin_state, layout,
                        merge_outputs, valid_length):
        """Layer-by-layer unroll so per-cell unroll specializations
        (DropoutCell's whole-sequence fast path) apply."""
        self.reset()
        steps, _, batch = _as_steps(inputs, layout)
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size=batch)
        seq = steps
        out_states = []
        cells = list(self._children.values())
        for k, (cell, sub) in enumerate(self._carve_states(states)):
            last = k == len(cells) - 1
            seq, sub = cell.unroll(
                length, seq, begin_state=sub, layout=layout,
                merge_outputs=merge_outputs if last else None,
                valid_length=valid_length)
            out_states.extend(sub)
        return seq, out_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def __repr__(self):
        body = "\n".join("(%s): %s" % (i, str(m).replace("\n", "\n  "))
                         for i, m in self._children.items())
        return "%s(\n%s\n)" % (self.__class__.__name__, body)


class SequentialRNNCell(_CellStack, RecurrentCell):
    """Stack of cells applied in order each step."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def __call__(self, inputs, states):
        return self._stacked_call(inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        return self._stacked_unroll(length, inputs, begin_state, layout,
                                    merge_outputs, valid_length)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class HybridSequentialRNNCell(_CellStack, HybridRecurrentCell):
    """Stack of hybrid cells applied in order each step."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def __call__(self, inputs, states):
        return self._stacked_call(inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        return self._stacked_unroll(length, inputs, begin_state, layout,
                                    merge_outputs, valid_length)


# --------------------------------------------------------------- modifiers

class DropoutCell(HybridRecurrentCell):
    """Stateless cell applying dropout to its input."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = float(rate)
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        from ... import autograd
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes,
                               training=autograd.is_training())
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        # dropout needs no recurrence: a merged input can be masked in one
        # whole-sequence op instead of per step — but only when the caller
        # didn't ask for a per-step list back
        self.reset()
        if isinstance(inputs, tensor_types) and merge_outputs is not False:
            return self.hybrid_forward(F, inputs,
                                       begin_state if begin_state else [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)

    def __repr__(self):
        return "%s(rate=%s, axes=%s)" % (self.__class__.__name__,
                                         self._rate, self._axes)


class ModifierCell(HybridRecurrentCell):
    """Wraps another cell, borrowing its parameters and state layout."""

    def __init__(self, base_cell):
        if base_cell._modified:
            raise ValueError("cell %s already has a modifier attached"
                             % base_cell.name)
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(), params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        # temporarily lift the guard so the wrapped cell can answer
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(func=func, **kwargs)
        finally:
            self.base_cell._modified = True

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self.base_cell)


class ZoneoutCell(ModifierCell):
    """Zoneout: randomly keep previous outputs/states instead of new ones
    (Krueger et al. 2016)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, BidirectionalCell):
            raise TypeError("zoneout cannot wrap a BidirectionalCell "
                            "(it has no single step); wrap the inner cells")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        p_out, p_state = self.zoneout_outputs, self.zoneout_states
        new_out, new_states = self.base_cell(inputs, states)

        def keep_new(p, new, old):
            # draw a keep-mask via dropout-of-ones: nonzero -> take new
            flip = F.Dropout(F.ones_like(new), p=p, training=True)
            return F.where(flip, new, old)

        prev = self._prev_output
        if prev is None:
            prev = F.zeros_like(new_out)
        out = keep_new(p_out, new_out, prev) if p_out else new_out
        states_out = ([keep_new(p_state, n, o)
                       for n, o in zip(new_states, states)]
                      if p_state else new_states)
        self._prev_output = out
        return out, states_out

    def __repr__(self):
        return "%s(p_out=%s, p_state=%s, %s)" % (
            self.__class__.__name__, self.zoneout_outputs,
            self.zoneout_states, self.base_cell)


class ResidualCell(ModifierCell):
    """Adds the input back onto the wrapped cell's output."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def hybrid_forward(self, F, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        try:
            outs, states = self.base_cell.unroll(
                length, inputs, begin_state=begin_state, layout=layout,
                merge_outputs=merge_outputs, valid_length=valid_length)
        finally:
            self.base_cell._modified = True
        merged = isinstance(outs, tensor_types) if merge_outputs is None \
            else merge_outputs
        steps, t_ax, _ = _as_steps(inputs, layout)
        if valid_length is not None:
            steps = [F.where(_keep_mask(valid_length, t, s), s,
                             F.zeros_like(s))
                     for t, s in enumerate(steps)]
        if merged:
            return outs + _restack(steps, t_ax), states
        return [o + s for o, s in zip(outs, steps)], states


class BidirectionalCell(HybridRecurrentCell):
    """Runs one cell forward and one backward over the sequence; outputs
    are per-step concatenations.  Unroll-only (a single step has no
    meaning for the backward direction)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll")

    def state_info(self, batch_size=0):
        return (self._children["l_cell"].state_info(batch_size)
                + self._children["r_cell"].state_info(batch_size))

    def begin_state(self, **kwargs):
        assert not self._modified
        return (self._children["l_cell"].begin_state(**kwargs)
                + self._children["r_cell"].begin_state(**kwargs))

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        steps, t_ax, batch = _as_steps(inputs, layout)
        n_steps = len(steps)
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size=batch)
        fwd = self._children["l_cell"]
        bwd = self._children["r_cell"]
        split_at = len(fwd.state_info())

        f_out, f_states = fwd.unroll(
            n_steps, steps, begin_state=states[:split_at], layout=layout,
            merge_outputs=False, valid_length=valid_length)

        # reverse per example so the backward cell starts at each
        # sequence's real end, not at the padding
        stacked = _restack(steps, 0)
        rev = F.SequenceReverse(stacked, sequence_length=valid_length,
                                use_sequence_length=valid_length is not None,
                                axis=0)
        rev_steps, _, _ = _as_steps(rev, "TNC")
        b_out, b_states = bwd.unroll(
            n_steps, rev_steps, begin_state=states[split_at:], layout="TNC",
            merge_outputs=False, valid_length=valid_length)
        b_stacked = F.SequenceReverse(
            _restack(b_out, 0), sequence_length=valid_length,
            use_sequence_length=valid_length is not None, axis=0)
        b_out, _, _ = _as_steps(b_stacked, "TNC")

        outs = [F.concat(f, b, dim=1) for f, b in zip(f_out, b_out)]
        if merge_outputs:
            return _restack(outs, t_ax), f_states + b_states
        return outs, f_states + b_states

    def __repr__(self):
        return "%s(forward=%s, backward=%s)" % (
            self.__class__.__name__, self._children["l_cell"],
            self._children["r_cell"])
