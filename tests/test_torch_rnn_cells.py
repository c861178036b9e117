"""The port's ``mx.rnn`` (the legacy symbolic cells, ``FusedRNNCell``, the
RNN checkpoint helpers and ``BucketSentenceIter``), ``initializer.FusedRNN``
and ``examples/rnn_lm.py``'s Gluon step, held against the reference's on
the CPU.

A cell's unrolled graph is built in both packages and bound with the same
numpy parameters (shapes from the port's ``infer_shape``); one forward
and backward with seeded head gradients is compared.  Tolerance: max
|port - ref| within 1e-5 of the tensor's largest magnitude (f32 products
summed in other orders; measured <= 1e-6).  ``FusedRNN``'s blob, the
packed and unpacked weights and the iterator's batches are compared
exactly.
"""
import os
import random
import sys

import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu_torch as mt
from _torch_gluon import build, close
from mxnet_tpu_torch.convert import gluon_params_from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

RTOL = 1e-5
T, B, I, H = 4, 3, 5, 6


def _ctx(pkg):
    return mt.cpu() if pkg is mt else ref.cpu()


def _unrolled(pkg, make, layout="NTC"):
    """``make(pkg)``'s cell unrolled over a ``data`` Variable: the outputs
    (merged) and the flat list of end states, grouped."""
    cell = make(pkg)
    outputs, states = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                                  layout=layout, merge_outputs=True)
    flat = []
    for s in states:
        flat.extend(s if isinstance(s, list) else [s])
    return cell, pkg.sym.Group([outputs] + flat)


def _bind_run(pkg, sym, values, heads):
    """Bind ``sym`` with ``values``, forward in training mode, backward with
    ``heads``: outputs and every argument's gradient, as numpy."""
    with _ctx(pkg):
        args = {n: pkg.nd.array(v) for n, v in values.items()}
        grads = {n: pkg.nd.zeros(v.shape) for n, v in values.items()}
        ex = sym.bind(_ctx(pkg), args=args, args_grad=grads)
        outs = ex.forward(is_train=True)
        ex.backward([pkg.nd.array(h) for h in heads])
        return ([o.asnumpy() for o in outs],
                {n: g.asnumpy() for n, g in ex.grad_dict.items()})


def _values(sym, data_shape, seed=0):
    arg_shapes, _, _ = sym.infer_shape(data=data_shape)
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}


def _compare(make, data_shape, layout="NTC"):
    _, psym = _unrolled(mt, make, layout)
    _, rsym = _unrolled(ref, make, layout)
    assert psym.list_arguments() == rsym.list_arguments()
    values = _values(psym, data_shape)
    assert [s for s in rsym.infer_shape(data=data_shape)[0]] == \
        [tuple(v.shape) for v in values.values()]
    with mt.cpu():
        fwd = mt.sym.Group(list(psym)).bind(
            mt.cpu(), args={n: mt.nd.array(v) for n, v in values.items()}
        ).forward()
    rng = np.random.RandomState(9)
    heads = [rng.randn(*o.shape).astype(np.float32) for o in fwd]
    got_o, got_g = _bind_run(mt, psym, values, heads)
    want_o, want_g = _bind_run(ref, rsym, values, heads)
    for k, (g, w) in enumerate(zip(got_o, want_o)):
        close(g, w, RTOL, "output %d" % k)
    for n in values:
        close(got_g[n], want_g[n], RTOL, n + " grad")


def _seq(pkg, *cells):
    s = pkg.rnn.SequentialRNNCell()
    for c in cells:
        s.add(c)
    return s


_CELLS = {
    "rnn_tanh": lambda pkg: pkg.rnn.RNNCell(H, prefix="r_"),
    "rnn_relu": lambda pkg: pkg.rnn.RNNCell(H, activation="relu",
                                            prefix="r_"),
    "lstm": lambda pkg: pkg.rnn.LSTMCell(H, prefix="l_"),
    "gru": lambda pkg: pkg.rnn.GRUCell(H, prefix="g_"),
    "sequential": lambda pkg: _seq(pkg, pkg.rnn.LSTMCell(H, prefix="a_"),
                                   pkg.rnn.DropoutCell(0.0, prefix="d_"),
                                   pkg.rnn.GRUCell(H, prefix="b_")),
    "residual": lambda pkg: pkg.rnn.ResidualCell(
        pkg.rnn.GRUCell(I, prefix="g_")),
    "zoneout_off": lambda pkg: pkg.rnn.ZoneoutCell(
        pkg.rnn.LSTMCell(H, prefix="l_")),
    "bidirectional": lambda pkg: pkg.rnn.BidirectionalCell(
        pkg.rnn.LSTMCell(H, prefix="fl_"), pkg.rnn.GRUCell(H, prefix="bg_")),
}


@pytest.mark.parametrize("name", sorted(_CELLS))
def test_symbolic_cell_matches_reference(name):
    _compare(_CELLS[name], (B, T, I))


_FUSED = [(m, L, bi) for m, L, bi in (
    ("lstm", 2, False), ("lstm", 1, True), ("gru", 2, True),
    ("rnn_tanh", 1, False), ("rnn_relu", 2, True))]


def _fused(mode, layers, bi):
    def make(pkg):
        return pkg.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                    bidirectional=bi, get_next_state=True,
                                    prefix="f_")
    return make


@pytest.mark.parametrize("mode,layers,bi", _FUSED)
def test_fused_cell_matches_reference_and_its_unfused_stack(mode, layers,
                                                            bi):
    """The fused cell's graph (one ``RNN`` op) against the reference's,
    and against its own ``unfuse()`` stack over its weights unpacked by
    the fused cell and packed by the stack (TNC)."""
    make = _fused(mode, layers, bi)
    _compare(make, (T, B, I), layout="TNC")
    cell, psym = _unrolled(mt, make, "TNC")
    values = _values(psym, (T, B, I))
    with mt.cpu():
        args = {n: mt.nd.array(v) for n, v in values.items()}
        fused = psym.bind(mt.cpu(), args=args).forward()[0].asnumpy()
        stack = cell.unfuse()
        unpacked = stack.pack_weights(cell.unpack_weights(args))
        out, _ = stack.unroll(T, inputs=mt.sym.Variable("data"),
                              layout="TNC", merge_outputs=True)
        unfused = out.bind(mt.cpu(), args=dict(
            unpacked, data=args["data"])).forward()[0].asnumpy()
    close(unfused, fused, RTOL, "unfused stack vs fused cell")


@pytest.mark.parametrize("mode,layers,bi", _FUSED)
def test_pack_unpack_weights_match_reference(mode, layers, bi):
    make = _fused(mode, layers, bi)
    pc, _ = _unrolled(mt, make, "TNC")
    rc, _ = _unrolled(ref, make, "TNC")
    from mxnet_tpu.rnn._fused_layout import fused_rnn_param_size
    n = fused_rnn_param_size(I, H, layers, mode, bi)
    blob = np.random.RandomState(1).randn(n).astype(np.float32)
    with mt.cpu():
        unpacked = pc.unpack_weights({"f_parameters": mt.nd.array(blob)})
        got = {k: v.asnumpy() for k, v in unpacked.items()}
        back = pc.pack_weights({k: mt.nd.array(v) for k, v in got.items()})
    want = {k: v.asnumpy() for k, v in
            rc.unpack_weights({"f_parameters": ref.nd.array(blob)}).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(back["f_parameters"].asnumpy(), blob)


def test_gate_cells_unpack_and_pack_like_reference():
    with mt.cpu():
        pc = mt.rnn.LSTMCell(H, prefix="l_")
    rc = ref.rnn.LSTMCell(H, prefix="l_")
    rng = np.random.RandomState(2)
    args = {"l_i2h_weight": rng.randn(4 * H, I), "l_i2h_bias":
            rng.randn(4 * H), "l_h2h_weight": rng.randn(4 * H, H),
            "l_h2h_bias": rng.randn(4 * H)}
    args = {k: v.astype(np.float32) for k, v in args.items()}
    with mt.cpu():
        got = pc.unpack_weights({k: mt.nd.array(v)
                                 for k, v in args.items()})
        back = pc.pack_weights(got)
    want = rc.unpack_weights({k: ref.nd.array(v) for k, v in args.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
    for k in args:
        np.testing.assert_array_equal(back[k].asnumpy(), args[k])


@pytest.mark.parametrize("mode,bi", [("lstm", True), ("gru", False)])
def test_fused_rnn_initializer_matches_reference(mode, bi):
    """``FusedRNN`` through ``Module.init_params``: with a deterministic
    inner initializer (``Constant``) the blobs are equal; with none, the
    Module's initializer fills the weights (the global fallback) and the
    biases are zeros with ``forget_bias`` in the LSTM's forget rows."""
    def blob(pkg, inner, glob):
        with _ctx(pkg):
            cell = pkg.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                        bidirectional=bi, prefix="f_",
                                        forget_bias=2.0)
            if inner is not None:
                cell._parameter = pkg.sym.Variable(
                    "f_parameters", init=pkg.init.FusedRNN(
                        inner(pkg), H, 2, mode, bi, forget_bias=2.0))
            out, _ = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                                 layout="TNC", merge_outputs=True)
            kw = {"context": mt.cpu()} if pkg is mt else {}
            mod = pkg.mod.Module(out, label_names=None, **kw)
            mod.bind([("data", (T, B, I))], for_training=False)
            mod.init_params(initializer=glob(pkg))
            return mod.get_params()[0]["f_parameters"].asnumpy()

    const = (lambda pkg: pkg.init.Constant(0.5))
    got = blob(mt, const, const)
    want = blob(ref, const, const)
    np.testing.assert_array_equal(got, want)
    # the port's stream seeded as tests/conftest.py seeds the reference's:
    # unseeded, its state is whatever the worker's earlier files left
    mt.random.seed(42)
    got = blob(mt, None, lambda pkg: pkg.init.Uniform(0.1))
    want = blob(ref, None, lambda pkg: pkg.init.Uniform(0.1))
    from mxnet_tpu.rnn._fused_layout import fused_rnn_regions
    regions, total = fused_rnn_regions(I, H, 2, mode, bi, "f_")
    assert got.shape == want.shape == (total,)
    for name, off, shape, kind in regions:
        g = got[off:off + int(np.prod(shape))]
        w = want[off:off + int(np.prod(shape))]
        if kind.endswith("weight"):
            assert np.abs(g).max() <= 0.1 and np.abs(g).std() > 0.02, name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_symbolic_conv_cells_match_reference():
    shape = (B, T, 2, 5, 5)

    def make(pkg):
        return _seq(pkg, pkg.rnn.ConvRNNCell((B, 2, 5, 5), 3, prefix="c_"),
                    pkg.rnn.ConvLSTMCell((B, 3, 5, 5), 2, prefix="l_"),
                    pkg.rnn.ConvGRUCell((B, 2, 5, 5), 3, prefix="g_"))
    _compare(make, shape)


def test_rnn_checkpoints_cross_packages(tmp_path):
    """``do_rnn_checkpoint`` in the port writes the unpacked weights; the
    reference's ``load_rnn_checkpoint`` packs them back into the same
    blob, and the port reads the reference's file alike."""
    make = _fused("lstm", 2, False)
    pc, psym = _unrolled(mt, make, "TNC")
    rc, _ = _unrolled(ref, make, "TNC")
    values = _values(psym, (T, B, I))
    blob = values["f_parameters"]
    prefix = str(tmp_path / "lm")
    with mt.cpu():
        cb = mt.rnn.do_rnn_checkpoint(pc, prefix)
        cb(0, psym, {"f_parameters": mt.nd.array(blob)}, {})
    _, arg, _ = ref.rnn.load_rnn_checkpoint(rc, prefix, 1)
    np.testing.assert_array_equal(arg["f_parameters"].asnumpy(), blob)
    ref.rnn.save_rnn_checkpoint(rc, prefix + "r", 3, ref.sym.Variable("x"),
                                {"f_parameters": ref.nd.array(blob)}, {})
    with mt.cpu():
        _, arg, _ = mt.rnn.load_rnn_checkpoint(pc, prefix + "r", 3)
    np.testing.assert_array_equal(arg["f_parameters"].asnumpy(), blob)


def _batches(pkg, sentences, seed, epochs=2):
    random.seed(seed)
    np.random.seed(seed)
    with _ctx(pkg):
        it = pkg.rnn.BucketSentenceIter(sentences, 4, invalid_label=0)
        out = []
        for _ in range(epochs):
            for b in it:
                out.append((b.bucket_key, b.data[0].asnumpy(),
                            b.label[0].asnumpy(),
                            [tuple(d.shape) for d in b.provide_data]))
            it.reset()
        return it, out


def test_bucket_sentence_iter_same_batches_under_same_seeds():
    sentences = chip_smoke.bucket_corpus(np, 60, 30)
    pit, got = _batches(mt, sentences, 5)
    rit, want = _batches(ref, sentences, 5)
    assert pit.buckets == rit.buckets == [8, 16, 24]
    assert pit.default_bucket_key == rit.default_bucket_key
    assert pit.provide_data == rit.provide_data
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
    words = [["a", "b"], ["c", "a", "d"]]
    assert mt.rnn.encode_sentences(words, start_label=1, invalid_label=0) \
        == ref.rnn.encode_sentences(words, start_label=1, invalid_label=0)


def test_rnn_lm_train_step_matches_reference():
    """One step of ``examples/rnn_lm.py``'s loop (2-layer LSTM LM, Adam) at
    dropout 0, from the reference's weights: the loss, every parameter's
    gradient and every updated parameter."""
    vocab, embed, hidden, seq, batch = 40, 8, 12, 6, 4
    toks = chip_smoke.lm_corpus(np, vocab, 400)
    x, y = chip_smoke.lm_batches(toks, batch, seq)[1]

    def make(pkg):
        return chip_smoke.rnn_lm_model(pkg.gluon, vocab, embed, hidden, 2,
                                       dropout=0.0)
    rb, pb = build(make)
    gluon_params_from_reference(pb, {n: p.data().asnumpy() for n, p in
                                     rb.collect_params().items()},
                                prefix=rb.prefix)
    res = {}
    for pkg, net in ((mt, pb), (ref, rb)):
        with _ctx(pkg):
            tr = pkg.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.01})
            loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
            states = [s.detach() for s in net.begin_state(batch)]
            xb = pkg.nd.array(x.astype(np.float32))
            yb = pkg.nd.array(y.astype(np.float32))
            with pkg.autograd.record():
                out, states = net(xb, states)
                loss = loss_fn(out.reshape((-1, vocab)),
                               yb.reshape((-1,))).mean()
            loss.backward()
            grads = {n[len(net.prefix):]: p.grad().asnumpy()
                     for n, p in net.collect_params().items()}
            tr.step(1)
            res[pkg] = (float(loss.asnumpy()), grads,
                        {n[len(net.prefix):]: p.data().asnumpy()
                         for n, p in net.collect_params().items()})
    (gl, gg, gp), (wl, wg, wp) = res[mt], res[ref]
    assert abs(gl - wl) <= RTOL * abs(wl), (gl, wl)
    assert sorted(gg) == sorted(wg)
    for n in wg:
        close(gg[n], wg[n], RTOL, n + " grad")
        close(gp[n], wp[n], RTOL, n)
