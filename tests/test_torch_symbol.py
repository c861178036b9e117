"""The port's ``mx.sym`` and ``Executor`` held against the reference's, on
the CPU (counterparts of ``tests/test_symbol.py``).

The same graphs are built in both packages (every node named, so the two
packages' auto-name counters never matter): composition, listings,
``infer_shape`` and ``infer_type`` must agree exactly; graph JSON written
by either package loads in the other; ``Executor.forward`` / ``backward``
from the same numpy arguments agree within ``rtol=1e-5, atol=1e-6`` (f32
on both sides; XLA and PyTorch sum products in other orders);
``SoftmaxOutput``'s gradient within 1e-6.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _mlp(lib):
    data = lib.sym.Variable("data")
    h = lib.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = lib.sym.Activation(h, act_type="relu", name="act1")
    return lib.sym.FullyConnected(h, num_hidden=3, name="fc2")


def _mlp_softmax(lib):
    return lib.sym.SoftmaxOutput(_mlp(lib), lib.sym.Variable("softmax_label"),
                                 name="softmax")


def _conv_bn(lib):
    # no conv bias before the BatchNorm, as nets build it: in training
    # mode its exact gradient is 0 (the batch mean takes it out), and both
    # packages would compare rounding noise
    data = lib.sym.Variable("data")
    c = lib.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                            no_bias=True, name="conv0")
    b = lib.sym.BatchNorm(c, fix_gamma=False, momentum=0.5, name="bn0")
    a = lib.sym.Activation(b, act_type="relu", name="act0")
    f = lib.sym.Flatten(a, name="flat0")
    return lib.sym.FullyConnected(f, num_hidden=5, name="fc0")


def _arith(lib):
    a = lib.sym.Variable("a")
    b = lib.sym.Variable("b")
    return (a + b * 2 - 1) / 2 * -a


def _regression(lib):
    return lib.sym.LinearRegressionOutput(
        lib.sym.FullyConnected(lib.sym.Variable("data"), num_hidden=4,
                               name="fc"), name="lro")


GRAPHS = {"mlp": (_mlp, {"data": (4, 10)}),
          "mlp_softmax": (_mlp_softmax, {"data": (4, 10)}),
          "conv_bn": (_conv_bn, {"data": (2, 3, 6, 6)}),
          "arith": (_arith, {"a": (3, 5), "b": (3, 5)}),
          "regression": (_regression, {"data": (6, 7)})}


def _build(name):
    fn, shapes = GRAPHS[name]
    return fn(jmx), fn(mt), shapes


def _args(sym, shapes, seed=0):
    """Seeded numpy values for every argument and aux state."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {n: rng.uniform(-1, 1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    if "softmax_label" in args:
        args["softmax_label"] = rng.randint(
            0, 3, args["softmax_label"].shape).astype(np.float32)
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("var")
               else rng.uniform(-0.5, 0.5, s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _bind(lib, sym, args, aux, grad_req="write"):
    return sym.bind(lib.cpu(), args={n: lib.nd.array(v)
                                     for n, v in args.items()},
                    args_grad={n: lib.nd.zeros(v.shape)
                               for n, v in args.items()},
                    grad_req=grad_req,
                    aux_states={n: lib.nd.array(v) for n, v in aux.items()})


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_compose_and_listings_match_reference(graph):
    ref, port, _ = _build(graph)
    assert port.list_arguments() == ref.list_arguments()
    assert port.list_outputs() == ref.list_outputs()
    assert port.list_auxiliary_states() == ref.list_auxiliary_states()
    assert port.list_inputs() == ref.list_inputs()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_infer_shape_and_type_match_reference(graph):
    """Parameter shapes from the data shapes alone, the reference's rules;
    types f32 throughout, as the reference types."""
    ref, port, shapes = _build(graph)
    assert port.infer_shape(**shapes) == ref.infer_shape(**shapes)
    assert port.infer_type() == ref.infer_type()


def test_infer_shape_partial_and_variable_shape_attr():
    """A missing data shape leaves what depends on it unknown (None); a
    Variable's own ``shape`` attr is used."""
    arg_shapes, out_shapes, _ = _mlp(mt).infer_shape()
    assert arg_shapes == [None] * 5 and out_shapes == [None]
    data = mt.sym.Variable("data", shape=(4, 6))
    out = mt.sym.FullyConnected(data, num_hidden=2, name="fc")
    assert out.infer_shape()[1] == [(4, 2)]


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_json_loads_across_packages(graph, writer):
    """JSON written by either package loads in the other, lists the same
    arguments and evaluates to the same outputs."""
    ref, port, shapes = _build(graph)
    src, dst = (port, jmx) if writer == "port" else (ref, mt)
    loaded = dst.sym.load_json(src.tojson())
    assert loaded.list_arguments() == src.list_arguments()
    assert loaded.list_outputs() == src.list_outputs()
    args, aux = _args(ref, shapes)
    want = _bind(jmx, ref, args, aux).forward()
    got = _bind(dst, loaded, args, aux).forward()
    for g, w in zip(got, want):
        _close(g.asnumpy(), w.asnumpy(), graph)


def test_save_load_file_roundtrip(tmp_path):
    fname = str(tmp_path / "mlp-symbol.json")
    _mlp(mt).save(fname)
    assert mt.sym.load(fname).tojson() == _mlp(mt).tojson()
    assert jmx.sym.load(fname).list_arguments() == \
        _mlp(mt).list_arguments()


@pytest.mark.parametrize("is_train", [False, True], ids=["infer", "train"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_executor_forward_backward_match_reference(graph, is_train):
    """Outputs, gradients of every argument (ones cotangents) and the aux
    write-backs against the reference's Executor."""
    ref, port, shapes = _build(graph)
    args, aux = _args(ref, shapes)
    jex, tex = _bind(jmx, ref, args, aux), _bind(mt, port, args, aux)
    for g, w in zip(tex.forward(is_train=is_train),
                    jex.forward(is_train=is_train)):
        _close(g.asnumpy(), w.asnumpy(), "output")
    for n, w in jex.aux_dict.items():
        _close(tex.aux_dict[n].asnumpy(), w.asnumpy(), n)
    if not is_train:
        return
    jex.backward()
    tex.backward()
    for n, w in jex.grad_dict.items():
        _close(tex.grad_dict[n].asnumpy(), w.asnumpy(), n)


def test_softmax_output_gradient():
    """``(p - onehot(label)) / batch`` within 1e-6 of the reference's,
    whatever the cotangent, and zero for the label."""
    ref, port, shapes = _build("mlp_softmax")
    args, aux = _args(ref, shapes, seed=5)
    jex, tex = _bind(jmx, ref, args, aux), _bind(mt, port, args, aux)
    jex.forward(is_train=True)
    jex.backward()
    tex.forward(is_train=True)
    tex.backward(out_grads=[mt.nd.ones((4, 3)) * 3.0])
    for n, w in jex.grad_dict.items():
        np.testing.assert_allclose(tex.grad_dict[n].asnumpy(), w.asnumpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
    assert not tex.grad_dict["softmax_label"].asnumpy().any()
    # the op alone: p - onehot over the batch
    x = np.random.RandomState(1).randn(5, 4).astype(np.float32)
    lab = np.array([0, 3, 1, 1, 2], np.float32)
    xt = torch.tensor(x, requires_grad=True)
    p = mt.ops.registry.get("SoftmaxOutput").fn(xt, torch.tensor(lab))
    p.backward(torch.full_like(p, 7.0))
    want = (torch.softmax(torch.tensor(x), -1).numpy()
            - np.eye(4, dtype=np.float32)[lab.astype(int)]) / 5
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("op", ["LinearRegressionOutput",
                                "LogisticRegressionOutput",
                                "MAERegressionOutput"])
def test_regression_output_gradients_match_reference(op):
    rng = np.random.RandomState(2)
    args = {"data": rng.randn(6, 4).astype(np.float32),
            "label": rng.randn(6, 4).astype(np.float32)}
    exes = []
    for lib in (jmx, mt):
        sym = getattr(lib.sym, op)(lib.sym.Variable("data"),
                                   lib.sym.Variable("label"), name="out")
        ex = _bind(lib, sym, args, {})
        ex.forward(is_train=True)
        ex.backward()
        exes.append(ex)
    _close(exes[1].outputs[0].asnumpy(), exes[0].outputs[0].asnumpy(), op)
    _close(exes[1].grad_dict["data"].asnumpy(),
           exes[0].grad_dict["data"].asnumpy(), op)


def test_simple_bind_and_grad_add_req():
    out = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=2,
                                name="fc")
    ex = out.simple_bind(mt.cpu(), grad_req="add", data=(2, 3))
    assert ex.arg_dict["fc_weight"].shape == (2, 3)
    ex.arg_dict["fc_weight"]._data += 0.5
    x = np.ones((2, 3), np.float32)
    ex.forward(is_train=True, data=x)
    ex.backward()
    g1 = ex.grad_dict["fc_weight"].asnumpy().copy()
    ex.forward(is_train=True, data=x)
    ex.backward()
    np.testing.assert_allclose(ex.grad_dict["fc_weight"].asnumpy(), 2 * g1)


def test_symbol_arithmetic_and_comparisons_eval():
    a, b = mt.sym.Variable("a"), mt.sym.Variable("b")
    (res,) = ((a + b * 2 - 1) / 2).eval(a=np.full((2, 2), 3, np.float32),
                                        b=np.full((2, 2), 2, np.float32))
    np.testing.assert_allclose(res.asnumpy(), 3.0)
    x = np.arange(4, dtype=np.float32)
    for expr, want in (((a > 1), x > 1), ((a == 2), x == 2),
                       ((a <= b), x <= 1.5), ((2 - a), 2 - x)):
        (res,) = expr.eval(a=x, b=np.full(4, 1.5, np.float32))
        np.testing.assert_array_equal(res.asnumpy(), want.astype(np.float32))


def test_multi_output_split_getitem_and_group():
    data = mt.sym.Variable("data")
    sp = mt.sym.split(data, num_outputs=2, axis=1, name="sp")
    assert sp.list_outputs() == ["sp_output0", "sp_output1"]
    (res,) = (sp[0] + sp[1]).eval(
        data=np.arange(8, dtype=np.float32).reshape(2, 4))
    np.testing.assert_allclose(res.asnumpy(), [[2, 4], [10, 12]])
    g = mt.sym.Group([sp[1], data * 2])
    outs = g.eval(data=np.ones((2, 4), np.float32))
    assert [o.shape for o in outs] == [(2, 2), (2, 4)]


def test_get_internals_and_children():
    out = _mlp(mt)
    names = out.get_internals().list_outputs()
    assert "fc1_output" in names and "act1_output" in names
    assert out.get_children().list_outputs()[0] == "act1_output"


def test_copy_params_from_and_reshape():
    ex = _mlp(mt).simple_bind(mt.cpu(), data=(4, 10))
    w = np.random.RandomState(0).randn(8, 10).astype(np.float32)
    ex.copy_params_from({"fc1_weight": w})
    np.testing.assert_array_equal(ex.arg_dict["fc1_weight"].asnumpy(), w)
    with pytest.raises(ValueError, match="unknown argument"):
        ex.copy_params_from({"nope": w})
    ex2 = ex.reshape(data=(7, 10))
    assert ex2.forward(data=np.ones((7, 10), np.float32))[0].shape == (7, 3)
    assert ex2.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]


def test_zeros_ones_and_what_is_not_ported():
    z = mt.sym.zeros((2, 3)) + mt.sym.ones((2, 3)) * 2
    np.testing.assert_array_equal(z.eval()[0].asnumpy(), np.full((2, 3), 2))
    # an Apache-MXNet (NNVM) graph JSON is read by compat
    # (tests/test_torch_compat.py); one naming an op the port lacks raises
    with pytest.raises(NotImplementedError, match="not registered"):
        mt.sym.load_json('{"nodes": [{"op": "NoSuchOp", "name": "x", '
                         '"inputs": []}], "arg_nodes": [], "heads": []}')
    # Variable(init=...) is ported: the initializer's dumps in __init__
    assert mt.sym.Variable("w", init=mt.init.Zero()).attr_dict()["w"][
        "__init__"] == mt.init.Zero().dumps()
    # group2ctx placement is ported (tests/test_torch_multi_context.py),
    # and so are monitor callbacks: one fires on each output of a forward
    ex = _mlp(mt).simple_bind(mt.cpu(), group2ctx={"a": mt.cpu()},
                              data=(4, 10))
    seen = []
    ex.set_monitor_callback(lambda name, arr: seen.append(name))
    ex.forward(is_train=False)
    assert seen == ex._symbol.list_outputs()
    with pytest.raises(AttributeError):
        mt.sym.no_such_op_anywhere
