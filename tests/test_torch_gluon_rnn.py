"""The port's ``gluon.rnn`` and ``gluon.contrib.rnn`` held against the
reference's, on the CPU.

Each layer or cell is built in both packages under fresh name managers
(so the parameter names agree), the reference's drawn values are carried
onto the port's (``convert.gluon_params_from_reference``), and one
forward and backward runs from the same numpy inputs, states and seeded
head gradients.  Parameter files cross the packages both ways
(``save_parameters`` / ``load_parameters``, structural names), and a
layer's ``_unfuse()`` stack reproduces the layer.

Tolerance: max |port - ref| within 1e-5 of the tensor's largest
magnitude (f32, products summed in other orders; measured <= 1e-6).
"""
import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu_torch as mt
from _torch_gluon import build, close
from mxnet_tpu_torch.convert import gluon_params_from_reference

RTOL = 1e-5
T, B, I, H = 5, 3, 4, 6


def _ctx(pkg):
    return mt.cpu() if pkg is mt else ref.cpu()


def _forward(pkg, block, x, states, heads, call):
    """``call(block, x, states) -> (outputs, new states)`` under the
    package's autograd; the outputs, new states and the gradients of
    ``x``, the states and every parameter, as numpy."""
    with _ctx(pkg):
        xs = pkg.nd.array(x)
        sts = [pkg.nd.array(s) for s in states]
        for a in [xs] + sts:
            a.attach_grad()
        with pkg.autograd.record():
            out, new = call(block, xs, sts)
        outs = [out] + list(new)
        pkg.autograd.backward(outs, [pkg.nd.array(h) for h in
                                     heads[:len(outs)]])
        grads = {n: p.grad().asnumpy()
                 for n, p in block.collect_params().items()
                 if p.grad_req != "null"}
        return ([o.asnumpy() for o in outs],
                [a.grad.asnumpy() for a in [xs] + sts], grads)


def carry(rb, pb):
    """The reference's values onto the port's Parameters, names matched
    after each block's own prefix (a modifier cell's names carry its
    base cell's)."""
    values = {n: p.data().asnumpy() for n, p in rb.collect_params().items()}
    prefix = rb.prefix if all(n.startswith(rb.prefix) for n in values) \
        else None
    gluon_params_from_reference(pb, values, prefix=prefix)


def _pair(make, x, states, call, seed=0):
    """Build, carry the reference's values over, run both, compare.  The
    blocks are given every input width, so nothing is deferred."""
    rb, pb = build(make, seed)
    carry(rb, pb)
    with mt.cpu():
        out, new = call(pb, mt.nd.array(x),
                        [mt.nd.array(s) for s in states])
    rng = np.random.RandomState(11)
    heads = [rng.randn(*o.shape).astype(np.float32)
             for o in [out] + list(new)]
    got = _forward(mt, pb, x, states, heads, call)
    want = _forward(ref, rb, x, states, heads, call)
    for k, (g, w) in enumerate(zip(got[0], want[0])):
        close(g, w, RTOL, "output %d" % k)
    for k, (g, w) in enumerate(zip(got[1], want[1])):
        close(g, w, RTOL, "input %d grad" % k)
    assert set(got[2]) == set(want[2]), (sorted(got[2]), sorted(want[2]))
    for n in want[2]:
        close(got[2][n], want[2][n], RTOL, n + " grad")
    return rb, pb


def _layer_call(block, x, states):
    return block(x, states)


_LAYERS = [("RNN", dict(activation="relu")), ("RNN", dict(activation="tanh")),
           ("LSTM", {}), ("GRU", {})]


def _layer_states(kind, layers, bi, rng):
    n = 2 if kind == "LSTM" else 1
    d = 2 if bi else 1
    return [rng.randn(layers * d, B, H).astype(np.float32)
            for _ in range(n)]


# every mode two-directional in TNC (the op's own test takes each mode
# both ways), and one-directional NTC once
_LAYER_CASES = [(kind, kw, True, "TNC") for kind, kw in _LAYERS] \
    + [("LSTM", {}, False, "NTC")]


@pytest.mark.parametrize(
    "kind,kw,bi,layout", _LAYER_CASES,
    ids=["%s-%s-%s" % (k.lower() + kw.get("activation", ""),
                       "bi" if b else "uni", lay)
         for k, kw, b, lay in _LAYER_CASES])
def test_layer_matches_reference(kind, kw, bi, layout):
    rng = np.random.RandomState(0)
    x = rng.randn(*((T, B, I) if layout == "TNC" else (B, T, I))) \
        .astype(np.float32)
    states = _layer_states(kind, 2, bi, rng)

    def make(pkg):
        return getattr(pkg.gluon.rnn, kind)(H, num_layers=2, layout=layout,
                                            bidirectional=bi, input_size=I,
                                            **kw)
    _pair(make, x, states, _layer_call)


def test_layer_without_states_returns_outputs_only():
    rng = np.random.RandomState(1)
    x = rng.randn(T, B, I).astype(np.float32)
    rb, pb = build(lambda pkg: pkg.gluon.rnn.GRU(H, input_size=I))
    carry(rb, pb)
    with mt.cpu():
        got = pb(mt.nd.array(x))
    with ref.cpu():
        want = rb(ref.nd.array(x))
    close(got.asnumpy(), want.asnumpy(), RTOL, "output")


@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
def test_parameter_files_cross_packages(tmp_path, bi):
    """``save_parameters`` in one package, ``load_parameters`` in the
    other, both ways: the structural names are the unfused cells'
    (``_unfused.0.l_cell.i2h_weight``) and the values arrive whole."""
    def make(pkg):
        return pkg.gluon.rnn.LSTM(H, num_layers=2, bidirectional=bi,
                                  input_size=I)
    rb, pb = build(make)
    names = sorted(pb._collect_params_with_prefix())
    assert names == sorted(rb._collect_params_with_prefix())
    assert names[0].startswith("_unfused.0.")
    f_ref = str(tmp_path / "ref.params")
    f_port = str(tmp_path / "port.params")
    rb.save_parameters(f_ref)
    with mt.cpu():
        pb.load_parameters(f_ref, ctx=mt.cpu())
        pb.save_parameters(f_port)
    rb2 = build(make, seed=5)[0]
    rb2.load_parameters(f_port)
    want = {n: p.data().asnumpy()
            for n, p in rb._collect_params_with_prefix().items()}
    for got in (pb, rb2):
        for n, p in got._collect_params_with_prefix().items():
            np.testing.assert_array_equal(p.data().asnumpy(), want[n],
                                          err_msg=n)


@pytest.mark.parametrize("kind", ["RNN", "LSTM", "GRU"])
def test_unfuse_matches_layer(kind):
    """``_unfuse()`` builds the cell stack of the same parameters: its
    unrolled outputs equal the fused layer's (port) and the reference's
    unfused stack's."""
    rng = np.random.RandomState(2)
    x = rng.randn(T, B, I).astype(np.float32)

    def make(pkg):
        return getattr(pkg.gluon.rnn, kind)(H, num_layers=2,
                                            bidirectional=True,
                                            input_size=I)
    rb, pb = build(make)
    carry(rb, pb)
    with mt.cpu():
        fused = pb(mt.nd.array(x)).asnumpy()
        stack = pb._unfuse()
        unfused, _ = stack.unroll(T, mt.nd.array(x), layout="TNC",
                                  merge_outputs=True)
    with ref.cpu():
        want, _ = rb._unfuse().unroll(T, ref.nd.array(x), layout="TNC",
                                      merge_outputs=True)
    close(unfused.asnumpy(), fused, RTOL, "unfused vs fused")
    close(unfused.asnumpy(), want.asnumpy(), RTOL, "unfused vs reference")


def _unroll_call(valid=None, merge=True, layout="NTC"):
    def call(block, x, states):
        kw = {}
        if valid is not None:
            nd = mt.nd if isinstance(x, mt.nd.NDArray) else ref.nd
            kw["valid_length"] = nd.array(valid)
        out, new = block.unroll(T, x, begin_state=states or None,
                                layout=layout, merge_outputs=merge, **kw)
        return out, new
    return call


def _cell_states(block, rng):
    with mt.cpu():
        infos = block.state_info(B)
    return [rng.randn(*info["shape"]).astype(np.float32) for info in infos]


def _stack(pkg, hybrid=True):
    cls = pkg.gluon.rnn.HybridSequentialRNNCell if hybrid \
        else pkg.gluon.rnn.SequentialRNNCell
    s = cls()
    with s.name_scope():
        s.add(pkg.gluon.rnn.LSTMCell(H, input_size=I))
        s.add(pkg.gluon.rnn.DropoutCell(0.0))
        s.add(pkg.gluon.rnn.GRUCell(H, input_size=H))
    return s


_CELLS = {
    "rnn_cell": lambda pkg: pkg.gluon.rnn.RNNCell(H, input_size=I),
    "rnn_relu_cell": lambda pkg: pkg.gluon.rnn.RNNCell(
        H, activation="relu", input_size=I),
    "lstm_cell": lambda pkg: pkg.gluon.rnn.LSTMCell(H, input_size=I),
    "gru_cell": lambda pkg: pkg.gluon.rnn.GRUCell(H, input_size=I),
    "sequential": lambda pkg: _stack(pkg, hybrid=False),
    "hybrid_sequential": _stack,
    "residual": lambda pkg: pkg.gluon.rnn.ResidualCell(
        pkg.gluon.rnn.GRUCell(I, input_size=I)),
    "zoneout_off": lambda pkg: pkg.gluon.rnn.ZoneoutCell(
        pkg.gluon.rnn.LSTMCell(H, input_size=I)),
    "bidirectional": lambda pkg: pkg.gluon.rnn.BidirectionalCell(
        pkg.gluon.rnn.LSTMCell(H, input_size=I, prefix="l_"),
        pkg.gluon.rnn.GRUCell(H, input_size=I, prefix="r_")),
    "lstmp": lambda pkg: pkg.gluon.contrib.rnn.LSTMPCell(
        H, 3, input_size=I),
    "variational_dropout_off": lambda pkg:
        pkg.gluon.contrib.rnn.VariationalDropoutCell(
            pkg.gluon.rnn.RNNCell(H, input_size=I), 0.0, 0.0, 0.0),
}


# every cell at full length; the masked unroll (valid_length) where the
# cell's own code handles the mask
_MASKED = ("bidirectional", "gru_cell", "hybrid_sequential", "lstm_cell",
           "lstmp", "residual", "rnn_cell", "rnn_relu_cell")
_CELL_CASES = [(n, None) for n in sorted(_CELLS)] + \
    [(n, [5, 2, 4]) for n in _MASKED]


@pytest.mark.parametrize(
    "name,valid", _CELL_CASES,
    ids=["%s-%s" % (n, "full" if v is None else "valid")
         for n, v in _CELL_CASES])
def test_cell_unroll_matches_reference(name, valid):
    rng = np.random.RandomState(3)
    x = rng.randn(B, T, I).astype(np.float32)
    with mt.name.NameManager(), mt.cpu():
        states = _cell_states(_CELLS[name](mt), rng)
    _pair(_CELLS[name], x, states, _unroll_call(valid))


def test_cell_step_and_begin_state():
    """One step of a cell from ``begin_state`` (zeros) and the per-step
    list output of ``unroll(merge_outputs=False)`` agree across the
    packages."""
    rng = np.random.RandomState(4)
    x = rng.randn(B, T, I).astype(np.float32)
    rb, pb = build(lambda pkg: pkg.gluon.rnn.LSTMCell(H, input_size=I))
    carry(rb, pb)
    with mt.cpu():
        p_out, p_st = pb(mt.nd.array(x[:, 0]), pb.begin_state(B))
        p_steps, _ = pb.unroll(T, mt.nd.array(x), merge_outputs=False)
    with ref.cpu():
        r_out, r_st = rb(ref.nd.array(x[:, 0]), rb.begin_state(B))
        r_steps, _ = rb.unroll(T, ref.nd.array(x), merge_outputs=False)
    close(p_out.asnumpy(), r_out.asnumpy(), RTOL, "step")
    for g, w in zip(p_st + p_steps, r_st + r_steps):
        close(g.asnumpy(), w.asnumpy(), RTOL, "state or step")


# each gate formula once and each rank once (the nine classes are the
# three formulas specialized to three ranks); every class's state shape
# is checked without a forward
_CONV = [("Conv1DGRUCell", (2, 6)), ("Conv2DLSTMCell", (2, 5, 4)),
         ("Conv3DRNNCell", (1, 3, 3, 3))]
_CONV_ALL = ["Conv%dD%sCell" % (d, k) for d in (1, 2, 3)
             for k in ("RNN", "LSTM", "GRU")]


@pytest.mark.parametrize("name,shape", _CONV, ids=[c[0] for c in _CONV])
def test_conv_cell_unroll_matches_reference(name, shape):
    steps = 3
    rng = np.random.RandomState(5)
    x = rng.randn(B, steps, *shape).astype(np.float32)

    def make(pkg):
        return getattr(pkg.gluon.contrib.rnn, name)(shape, 3)

    def call(block, xs, states):
        return block.unroll(steps, xs, begin_state=states, layout="NTC",
                            merge_outputs=True)
    with mt.name.NameManager(), mt.cpu():
        states = _cell_states(make(mt), rng)
    _pair(make, x, states, call)


@pytest.mark.parametrize("name", _CONV_ALL)
def test_conv_cell_shapes_match_reference(name):
    d = int(name[4])
    shape = (2,) + (5,) * d
    with ref.name.NameManager():
        rc = getattr(ref.gluon.contrib.rnn, name)(shape, 3)
    with mt.name.NameManager():
        pc = getattr(mt.gluon.contrib.rnn, name)(shape, 3)
    assert pc.state_info(B) == rc.state_info(B)
    assert {n: p.shape for n, p in pc.collect_params().items()} == \
        {n: p.shape for n, p in rc.collect_params().items()}
