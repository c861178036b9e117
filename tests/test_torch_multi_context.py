"""Several contexts in the port against the reference on the CPU (one
process): ``gluon.contrib.nn``'s layers, ``AttrScope`` and ``group2ctx``
placement (``tests/test_parity_modules.py``'s scenario), ``Module`` over a
list of contexts, and Gluon Parameters on several contexts through
``gluon.Trainer``.

The port's ``cpu(1)`` and ``cpu(2)`` are the CPU's one torch device, so
here the placement is held by the Contexts each array records and by the
numbers; on the card ``chip_smoke.py --phase shard`` (d) holds real
placement across ``gpu(0)`` and ``cpu()``.

A two-context Gluon step differs between the packages by design.  The
reference keeps ONE copy of a Parameter whatever its contexts, so each
slice's ``backward()`` overwrites the last and its step trains on the
last slice alone (counted once a context); the port keeps one copy a context, as MXNet does, and
its ``Trainer.step`` sums them.  The test asserts both packages' numbers.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as ref
import mxnet_tpu.name  # noqa: F401
import mxnet_tpu.gluon.contrib.nn  # noqa: F401
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.name  # noqa: F401
from mxnet_tpu_torch.convert import gluon_params_from_reference

import _torch_gluon as G

# f32 layers: one summation order against another
LAYER_RTOL = 1e-5
# a 3-step two-context Gluon run against one context on the whole batch:
# the per-context gradient sums add the slices' partial sums in another
# order than one matmul over the batch
STEP_ATOL = 1e-6


# ------------------------------------------------------- contrib layers
def _concurrent(hybrid):
    def make(pkg):
        cnn = pkg.gluon.contrib.nn
        net = (cnn.HybridConcurrent if hybrid else cnn.Concurrent)(axis=1)
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(3, in_units=4))
            net.add(pkg.gluon.nn.Dense(2, in_units=4))
            net.add(cnn.Identity())
        return net
    return make


_RNG = np.random.RandomState(0)
LAYERS = {
    "Concurrent": (_concurrent(False), [_RNG.randn(2, 4)]),
    "HybridConcurrent": (_concurrent(True), [_RNG.randn(2, 4)]),
    "Identity": (lambda p: p.gluon.contrib.nn.Identity(),
                 [_RNG.randn(2, 3)]),
    "SparseEmbedding": (lambda p: p.gluon.contrib.nn.SparseEmbedding(10, 4),
                        [_RNG.randint(0, 10, (2, 3))]),
    "SyncBatchNorm": (lambda p: p.gluon.contrib.nn.SyncBatchNorm(
        in_channels=3, num_devices=2), [_RNG.randn(4, 3, 2, 2) + 2.0]),
    "PixelShuffle1D": (lambda p: p.gluon.contrib.nn.PixelShuffle1D(2),
                       [_RNG.randn(1, 4, 3)]),
    "PixelShuffle2D": (lambda p: p.gluon.contrib.nn.PixelShuffle2D((2, 3)),
                       [_RNG.randn(1, 12, 2, 2)]),
    "PixelShuffle3D": (lambda p: p.gluon.contrib.nn.PixelShuffle3D(2),
                       [_RNG.randn(1, 8, 2, 2, 2)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_contrib_nn_layer_matches_reference(name):
    make, inputs = LAYERS[name]
    inputs = [np.asarray(a, np.float32) for a in inputs]
    rb, pb = G.check(make, inputs, LAYER_RTOL)
    assert type(pb).__name__ == type(rb).__name__ == name
    if name.startswith("PixelShuffle"):
        assert repr(pb) == repr(rb)


# ---------------------------------------------- AttrScope and group2ctx
def _staged(lib):
    """tests/test_parity_modules.py:190's two-stage graph."""
    with lib.AttrScope(ctx_group="stage1"):
        data = lib.sym.Variable("data")
        fc1 = lib.sym.FullyConnected(data, name="fc1", num_hidden=16)
        act1 = lib.sym.Activation(fc1, name="relu1", act_type="relu")
    with lib.AttrScope(ctx_group="stage2"):
        fc2 = lib.sym.FullyConnected(act1, name="fc2", num_hidden=4)
        out = lib.sym.SoftmaxOutput(fc2, name="softmax")
    return act1, out


def test_attr_scope_annotates_like_the_reference():
    for lib in (ref, mt):
        with lib.AttrScope(ctx_group="a", lr_mult="2"):
            with lib.AttrScope(ctx_group="b"):
                v = lib.sym.Variable("v", lr_mult="3")
                fc = lib.sym.FullyConnected(v, num_hidden=2, name="fc")
        assert v.attr("ctx_group") == "b" and v.attr("lr_mult") == "3"
        assert fc.attr("ctx_group") == "b" and fc.attr("lr_mult") == "2"
        assert lib.AttrScope(x="1").get({"y": "2"}) == {"x": "1", "y": "2"}
        assert lib.attribute.current() == {}
        with pytest.raises(ValueError):
            lib.AttrScope(ctx_group=1)
    _, rout = _staged(ref)
    _, pout = _staged(mt)
    assert pout.attr_dict() == rout.attr_dict()
    assert pout.list_attr() == {"ctx_group": "stage2"}
    assert pout.list_attr(recursive=True) == rout.attr_dict()


def _ctxs(lib):
    return {"stage1": lib.cpu(1), "stage2": lib.cpu(2)}


def test_group2ctx_places_and_computes_like_the_reference():
    """Each array on its group's context, for both grad_reqs; forward and
    backward from the same values equal to the reference's; the wrong
    context refused with "ctx_group"."""
    results = {}
    for lib in (ref, mt):
        act1, out = _staged(lib)
        stage1 = set(act1.list_arguments())
        g2c = _ctxs(lib)
        with lib.cpu():
            for grad_req in ("write", "null"):
                ex = out.simple_bind(lib.cpu(0), group2ctx=g2c,
                                     grad_req=grad_req, data=(2, 8))
                if lib is mt:
                    for name, arr in zip(out.list_arguments(),
                                         ex.arg_arrays):
                        want = g2c["stage1" if name in stage1 else "stage2"]
                        assert arr.context == want, (name, arr.context)
                    for name, g in zip(out.list_arguments(),
                                       ex.grad_arrays):
                        if g is not None:
                            want = g2c["stage1" if name in stage1
                                       else "stage2"]
                            assert g.context == want, name
            ex = out.simple_bind(lib.cpu(0), group2ctx=g2c,
                                 grad_req="write", data=(2, 8))
            rng = np.random.RandomState(3)
            ex.copy_params_from(
                {n: lib.nd.array(rng.normal(0, 0.3, a.shape)
                                 .astype(np.float32))
                 for n, a in ex.arg_dict.items() if n != "data"},
                allow_extra_params=True)
            x = np.random.RandomState(4).normal(size=(2, 8))
            res = ex.forward(is_train=True,
                             data=lib.nd.array(x.astype(np.float32)),
                             softmax_label=lib.nd.array([1.0, 3.0]))[0]
            ex.backward()
            results[lib] = (res.asnumpy(), {
                n: g.asnumpy() for n, g in zip(out.list_arguments(),
                                               ex.grad_arrays)
                if g is not None and n not in ("data", "softmax_label")})
            if lib is mt:
                for name, arr in zip(out.list_arguments(), ex.arg_arrays):
                    want = g2c["stage1" if name in stage1 else "stage2"]
                    assert arr.context == want, name
            with pytest.raises(ValueError, match="ctx_group"):
                out.bind(lib.cpu(0), args={"data": lib.nd.ones((2, 8)),
                                           "fc1_weight": lib.nd.ones((16, 8))},
                         group2ctx=g2c, grad_req="null")
    (got, ggrads), (want, rgrads) = results[mt], results[ref]
    G.close(got, want, LAYER_RTOL, "output")
    assert set(ggrads) == set(rgrads)
    for n in rgrads:
        G.close(ggrads[n], rgrads[n], LAYER_RTOL, n)


def test_module_group2ctxs_trains_like_one_context():
    """Module(group2ctxs=...) takes the eager route over the placed
    arrays: 3 SGD steps equal to a Module without placement."""
    rng = np.random.RandomState(5)
    X = rng.normal(size=(8, 8)).astype(np.float32)
    Y = rng.randint(0, 4, (8,)).astype(np.float32)
    params = []
    for g2c in (_ctxs(mt), None):
        mod = mt.mod.Module(_staged(mt)[1], context=mt.cpu(),
                            group2ctxs=g2c)
        mod.bind([("data", (8, 8))], [("softmax_label", (8,))])
        mt.random.seed(1)
        mod.init_params(mt.init.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        assert mod._fused_active() == (g2c is None)
        batch = mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                                [mt.nd.array(Y, ctx=mt.cpu())])
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
        params.append({n: v.asnumpy() for n, v in mod.get_params()[0]
                       .items()})
        if g2c is not None:
            assert mod._exec.arg_dict["fc2_weight"].context == mt.cpu(2)
    for n in params[1]:
        np.testing.assert_allclose(params[0][n], params[1][n], rtol=0,
                                   atol=1e-6, err_msg=n)


def test_module_context_list_is_bitwise_one_context():
    rng = np.random.RandomState(6)
    X = rng.normal(size=(16, 10)).astype(np.float32)
    Y = rng.randint(0, 3, (16,)).astype(np.float32)

    def sym():
        data = mt.sym.Variable("data")
        h = mt.sym.FullyConnected(data, num_hidden=8, name="fc1")
        h = mt.sym.Activation(h, act_type="relu", name="act1")
        h = mt.sym.FullyConnected(h, num_hidden=3, name="fc2")
        return mt.sym.SoftmaxOutput(h, name="softmax")
    out = []
    for context in ([mt.cpu(0), mt.cpu(1)], mt.cpu(0)):
        mod = mt.mod.Module(sym(), context=context, work_load_list=[1, 1])
        with mt.cpu():
            mt.random.seed(2)
            mod.fit(mt.io.NDArrayIter(X, Y, batch_size=8), num_epoch=2,
                    initializer=mt.init.Xavier(),
                    optimizer_params={"learning_rate": 0.1})
        out.append(mod.get_params()[0])
    for n, v in out[1].items():
        assert torch.equal(out[0][n]._data, v._data), n


# ---------------------------------- Gluon Parameters on several contexts
def _dense(lib, ctxs, weight):
    with lib.name.NameManager():
        net = lib.gluon.nn.Dense(2, in_units=3, use_bias=False)
    net.initialize(ctx=ctxs)
    net.weight.set_data(lib.nd.array(weight, ctx=ctxs[0]))
    return net


def _slice_backward(lib, net, x, ctxs):
    """One ``backward()`` of ``sum(net(slice))`` a slice.  The reference's
    one value lives on one device, which its slices on another device
    cannot meet, so its slices stay on the first (``split_data``)."""
    whole = lib.nd.array(x, ctx=ctxs[0])
    slices = lib.gluon.utils.split_data(whole, len(ctxs)) if lib is ref \
        else lib.gluon.utils.split_and_load(whole, ctxs)
    for xs in slices:
        with lib.autograd.record():
            y = net(xs)
        y.backward()


def test_two_context_gradients_differ_from_the_reference_by_design():
    """``Dense(2, in_units=3)`` on ``[cpu(0), cpu(1)]``, a batch of 4 rows
    split over them, one ``backward()`` a slice of ``sum(out)``: the
    reference's one copy holds the last slice's gradient and its step
    applies twice that (its kvstore adds the copy once a context); the
    port's two copies hold one slice each and its step applies their sum,
    which is the whole batch's."""
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    w = np.full((2, 3), 0.5, np.float32)
    whole = np.tile(x.sum(axis=0), (2, 1))               # [[18, 22, 26]]
    last = np.tile(x[2:].sum(axis=0), (2, 1))            # [[15, 17, 19]]
    with ref.cpu():
        rnet = _dense(ref, [ref.cpu(0), ref.cpu(1)], w)
        _slice_backward(ref, rnet, x, [ref.cpu(0), ref.cpu(1)])
        np.testing.assert_array_equal(rnet.weight.grad().asnumpy(), last)
        rtr = ref.gluon.Trainer(rnet.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        rtr.step(4)
        # its kvstore sums list_grad(), the one gradient once a context
        np.testing.assert_array_equal(
            rnet.weight.data().asnumpy(),
            w - np.float32(0.1) * (2 * last / np.float32(4)))
    ctxs = [mt.cpu(0), mt.cpu(1)]
    with mt.cpu():
        net = _dense(mt, ctxs, w)
        assert net.weight.list_ctx() == ctxs
        _slice_backward(mt, net, x, ctxs)
        g0, g1 = (g.asnumpy() for g in net.weight.list_grad())
        np.testing.assert_array_equal(g0, np.tile(x[:2].sum(axis=0), (2, 1)))
        np.testing.assert_array_equal(g1, last)
        assert net.weight.grad(mt.cpu(1)) is net.weight.list_grad()[1]
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
        tr.step(4)
        for g in net.weight.list_grad():
            np.testing.assert_array_equal(g.asnumpy(), whole)
        one = _dense(mt, [mt.cpu(0)], w)
        with mt.autograd.record():
            y = one(mt.nd.array(x))
        y.backward()
        np.testing.assert_array_equal(one.weight.grad().asnumpy(), whole)
        mt.gluon.Trainer(one.collect_params(), "sgd",
                         {"learning_rate": 0.1}).step(4)
        for d in net.weight.list_data():
            assert torch.equal(d._data, one.weight.data()._data)


def _stack(lib):
    nn = lib.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=8))
        net.add(nn.Dense(4, in_units=16))
    return net


def test_two_context_training_matches_one_context_on_the_whole_batch():
    """A Dense stack on ``[cpu(0), cpu(1)]`` trained 3 momentum SGD steps
    with ``split_and_load`` against one context on the whole batch from
    the same weights: within STEP_ATOL; every copy alike, and each
    forward took its slice's copy."""
    rng = np.random.RandomState(7)
    batches = [(rng.normal(size=(8, 8)).astype(np.float32),
                rng.normal(size=(8, 4)).astype(np.float32))
               for _ in range(3)]
    with ref.name.NameManager():
        rnet = _stack(ref)
    ref.random.seed(3)
    rnet.initialize(ref.init.Xavier())
    init = {n: p.data().asnumpy() for n, p in rnet.collect_params().items()}
    runs = []
    with mt.cpu():
        for ctxs in ([mt.cpu(0), mt.cpu(1)], [mt.cpu(0)]):
            with mt.name.NameManager():
                net = _stack(mt)
            net.initialize(ctx=ctxs)
            gluon_params_from_reference(net, init)
            loss_fn = mt.gluon.loss.L2Loss()
            tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9})
            seen = []
            net[0].register_forward_pre_hook(
                lambda blk, args: seen.append(
                    blk.weight.data() is blk.weight.data(args[0].context)))
            for x, y in batches:
                xs = mt.gluon.utils.split_and_load(mt.nd.array(x), ctxs)
                ys = mt.gluon.utils.split_and_load(mt.nd.array(y), ctxs)
                for xi, yi in zip(xs, ys):
                    with mt.autograd.record():
                        loss = loss_fn(net(xi), yi)
                    loss.backward()
                tr.step(x.shape[0])
            assert seen and all(seen)
            runs.append(net)
    two, one = runs
    for (n, p2), p1 in zip(two.collect_params().items(),
                           one.collect_params().values()):
        copies = p2.list_data()
        assert len(copies) == 2 and [c.context for c in copies] == \
            [mt.cpu(0), mt.cpu(1)]
        assert torch.equal(copies[0]._data, copies[1]._data), n
        np.testing.assert_allclose(copies[0].asnumpy(),
                                   p1.data().asnumpy(), rtol=0,
                                   atol=STEP_ATOL, err_msg=n)


def test_reset_ctx_and_data_by_context():
    with mt.cpu():
        net = _dense(mt, [mt.cpu(0)], np.ones((2, 3), np.float32))
        net.collect_params().reset_ctx([mt.cpu(0), mt.cpu(1), mt.cpu(2)])
        p = net.weight
        assert p.list_ctx() == [mt.cpu(0), mt.cpu(1), mt.cpu(2)]
        assert [d.context for d in p.list_data()] == p.list_ctx()
        assert p.data(mt.cpu(2)) is p.list_data()[2]
        with pytest.raises(RuntimeError, match="not initialized on"):
            p.data(mt.cpu(3))
        p.set_data(mt.nd.full((2, 3), 2.0))
        assert all(float(d.asnumpy().sum()) == 12.0 for d in p.list_data())
        net.collect_params().reset_ctx(mt.cpu())
        assert p.list_ctx() == [mt.cpu(0)] and len(p.list_data()) == 1
        assert float(p.data().asnumpy().sum()) == 12.0
