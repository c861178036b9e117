"""The port's symbolic Module held against the reference's, on the CPU
(counterparts of ``tests/test_module.py``'s Module tests).

Both packages build the same MLP (``FullyConnected`` 32, relu,
``FullyConnected`` 3, ``SoftmaxOutput``) from the same numpy weights and
train it on the same ``NDArrayIter`` batches.  The port's fused step
(``Executor.fused_step_fn``: on the CPU the fused kernels' plain
versions) and its eager step (the ``Updater`` per parameter) are held
against each other and against the reference's Module.

Tolerance: every parameter within ``rtol=1e-5`` (and ``atol=1e-7`` for
the entries that cross zero) after 3 steps.  The forward and backward
sum in other orders in XLA and in PyTorch (f32 products differ in their
last bits); measured, the weights agree to 1e-7 absolute.  The
reference's jitted fused step is held at the reference's own bound
between its two routes (see ``test_module_fused_matches_reference_
fused``).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import config as jconfig

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import (symbol_params_from_reference,
                                     symbol_params_to_reference)
from mxnet_tpu_torch.ops import cuda_kernels as ck

RTOL, ATOL = 1e-5, 1e-7
BATCH = 16


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _toy_data(n=96, d=10, k=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(d, k)).astype(np.float32)
    Y = np.argmax(X @ W, axis=1).astype(np.float32)
    return X, Y


def _mlp(lib):
    data = lib.sym.Variable("data")
    label = lib.sym.Variable("softmax_label")
    h = lib.sym.FullyConnected(data, num_hidden=32, name="fc1")
    h = lib.sym.Activation(h, act_type="relu", name="relu1")
    h = lib.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return lib.sym.SoftmaxOutput(h, label, name="softmax")


def _fixed_init(seed=7):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": (rng.randn(32, 10) * 0.1).astype(np.float32),
            "fc1_bias": np.zeros(32, np.float32),
            "fc2_weight": (rng.randn(3, 32) * 0.1).astype(np.float32),
            "fc2_bias": np.zeros(3, np.float32)}


def _train(lib, config, mode, optimizer, steps=3, lr=0.05, **opt):
    """Train the MLP under ``module.fused_step=mode``; the parameters as
    numpy."""
    X, Y = _toy_data()
    prev = config.get("module.fused_step")
    config.set("module.fused_step", mode)
    try:
        kw = {"context": mt.cpu()} if lib is mt else {}
        mod = lib.mod.Module(_mlp(lib), **kw)
        mod.bind([("data", (BATCH, 10))], [("softmax_label", (BATCH,))])
        mod.init_params(initializer=None, arg_params={
            n: lib.nd.array(v) for n, v in _fixed_init().items()})
        mod.init_optimizer(optimizer=optimizer, optimizer_params=dict(
            learning_rate=lr, **opt))
        it = lib.io.NDArrayIter(X, Y, batch_size=BATCH)
        for _ in range(steps):
            try:
                batch = next(it)
            except StopIteration:
                it.reset()
                batch = next(it)
            mod.train_step(batch)
        return {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    finally:
        config.set("module.fused_step", prev)


_OPTIMIZERS = [("sgd", {"momentum": 0.9, "wd": 1e-3}), ("adam", {})]


def _assert_params(got, want):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("route", ["auto", "off"], ids=["fused", "eager"])
@pytest.mark.parametrize("optimizer,opt", _OPTIMIZERS, ids=["sgd", "adam"])
def test_module_route_matches_reference(optimizer, opt, route):
    """Each route of the port lands on the weights of the reference's
    Module (its eager route, whose Adam bias correction is taken in
    doubles from a Python step count, as both of the port's routes take
    it) after 3 steps."""
    want = _train(jmx, jconfig, "off", optimizer, **opt)
    got = _train(mt, tconfig, route, optimizer, **opt)
    _assert_params(got, want)


@pytest.mark.parametrize("optimizer,opt", _OPTIMIZERS, ids=["sgd", "adam"])
def test_module_fused_matches_reference_fused(optimizer, opt):
    """The port's fused route against the reference's fused (jitted)
    Module, at the reference's own bound between its two routes
    (``rtol=1e-4, atol=1e-5``, ``tests/test_module.py``): the jitted step
    takes Adam's bias correction in f32 from a traced int32 step count,
    where ``1 - 0.999`` is 1.3e-5 off and moves lr_t by 6e-6."""
    want = _train(jmx, jconfig, "auto", optimizer, **opt)
    got = _train(mt, tconfig, "auto", optimizer, **opt)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("optimizer,opt", _OPTIMIZERS, ids=["sgd", "adam"])
def test_module_fused_vs_eager_equivalence(optimizer, opt):
    """The port's fused step (K3 / K1's plain version here) and its eager
    step (the Updater) agree after 6 steps."""
    _assert_params(_train(mt, tconfig, "auto", optimizer, steps=6, **opt),
                   _train(mt, tconfig, "off", optimizer, steps=6, **opt))


def test_fused_step_counts_and_kernel_route():
    """6 fixed-shape steps build one fused step and run it 6 times; with
    the kernel tier on every parameter updates through the fused kernel
    (``kernels.fused_step``, 4 a step), whose plain version runs on the
    CPU: no kernel launches."""
    tt.reset()
    before = dict(ck.LAUNCHES)
    _train(mt, tconfig, "auto", "adam", steps=6)
    c = tt.snapshot()["counters"]
    assert c["fused_compiles"] == 1 and c["fused_steps"] == 6, c
    assert c.get("eager_steps", 0) == 0, c
    assert c["kernels.fused_step"] == 6 * 4, c
    assert ck.LAUNCHES == before


def test_fused_kernel_tier_off_uses_step():
    """Tier off: the fused route updates through ``optimizer.step`` and
    lands on the same weights (Adam's plain kernel rounds as its step)."""
    tconfig.set("kernels.enabled", False)
    try:
        tt.reset()
        off = _train(mt, tconfig, "auto", "adam")
        assert tt.snapshot()["counters"].get("kernels.fused_step", 0) == 0
    finally:
        tconfig.unset("kernels.enabled")
    _assert_params(off, _train(mt, tconfig, "auto", "adam"))


def test_fused_tier_off_is_bitwise_the_eager_route():
    """With the kernel tier off the fused step updates through
    ``optimizer.step``, as the eager route's Updater does, from the same
    forward and backward: 20 Adam steps give the same bits.  (With the
    tier on, K3 contracts three multiply-adds and the two routes differ
    by an ulp of an update.)"""
    tconfig.set("kernels.enabled", False)
    try:
        fused = _train(mt, tconfig, "auto", "adam", steps=20)
        eager = _train(mt, tconfig, "off", "adam", steps=20)
    finally:
        tconfig.unset("kernels.enabled")
    for n in fused:
        np.testing.assert_array_equal(fused[n], eager[n], err_msg=n)


def test_fused_knob_off_stays_eager():
    tt.reset()
    _train(mt, tconfig, "off", "sgd")
    c = tt.snapshot()["counters"]
    assert c.get("fused_steps", 0) == 0 and c.get("fused_compiles", 0) == 0
    assert c["eager_steps"] == 3, c


def test_fused_naive_engine_runs_eager():
    mt.engine.set_engine_type("NaiveEngine")
    try:
        tt.reset()
        _train(mt, tconfig, "auto", "sgd", steps=2)
        c = tt.snapshot()["counters"]
        assert c.get("fused_steps", 0) == 0 and c["eager_steps"] == 2, c
    finally:
        mt.engine.set_engine_type("ThreadedEnginePerDevice")


def test_naive_engine_syncs_every_op(monkeypatch):
    """Under NaiveEngine each ``mx.nd`` op waits for its outputs (the
    reference's ``maybe_sync``), counted on ``engine.naive_syncs``; CPU
    outputs need no device sync, and the default engine does neither."""
    def no_sync():
        raise AssertionError("synchronize() on CPU tensors")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    x = mt.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3),
                    ctx=mt.cpu())
    tt.reset()
    (x + 1).sum()
    assert tt.snapshot()["counters"].get("engine.naive_syncs", 0) == 0
    mt.engine.set_engine_type("NaiveEngine")
    try:
        y = mt.nd.relu(x - 2)
        s = y.sum()
    finally:
        mt.engine.set_engine_type("ThreadedEnginePerDevice")
    assert tt.snapshot()["counters"]["engine.naive_syncs"] == 3
    assert float(s.asnumpy()) == 6.0


def test_knob_flip_rebuilds_the_fused_step():
    """The fused step is cached per config epoch: a knob flip builds it
    anew (the reference's retrace rule)."""
    X, Y = _toy_data()
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind([("data", (BATCH, 10))], [("softmax_label", (BATCH,))])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="sgd")
    batch = next(mt.io.NDArrayIter(X, Y, batch_size=BATCH))
    tt.reset()
    mod.train_step(batch)
    mod.train_step(batch)
    tconfig.set("kernels.enabled", False)
    try:
        mod.train_step(batch)
    finally:
        tconfig.unset("kernels.enabled")
    assert tt.snapshot()["counters"]["fused_compiles"] == 2


def test_fused_outputs_observable_before_update():
    """``get_outputs`` between forward_backward and update replays the
    deferred batch eagerly, and the update still runs."""
    X, Y = _toy_data(n=16)
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
    mod.init_params(initializer=None, arg_params={
        n: mt.nd.array(v) for n, v in _fixed_init().items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    batch = next(mt.io.NDArrayIter(X, Y, batch_size=16))
    tt.reset()
    mod.forward_backward(batch)
    outs = mod.get_outputs()
    assert outs and outs[0].shape == (16, 3)
    assert tt.snapshot()["counters"]["module.eager_replays"] == 1
    w_before = mod.get_params()[0]["fc1_weight"].asnumpy()
    mod.update()
    assert not np.allclose(w_before,
                           mod.get_params()[0]["fc1_weight"].asnumpy())


def test_get_params_returns_copies_and_init_copies_its_input():
    """Parameters update in place: neither the arrays handed to
    ``init_params`` nor a dict ``get_params`` returned may change."""
    X, Y = _toy_data(n=16)
    given = {n: mt.nd.array(v) for n, v in _fixed_init().items()}
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
    mod.init_params(initializer=None, arg_params=given)
    mod.init_optimizer(optimizer="adam")
    early = mod.get_params()[0]
    mod.train_step(next(mt.io.NDArrayIter(X, Y, batch_size=16)))
    for n, v in _fixed_init().items():
        np.testing.assert_array_equal(given[n].asnumpy(), v)
        np.testing.assert_array_equal(early[n].asnumpy(), v)
    assert not np.array_equal(mod.get_params()[0]["fc1_weight"].asnumpy(),
                              _fixed_init()["fc1_weight"])


def test_module_fit_converges():
    X, Y = _toy_data(n=160)
    train = mt.io.NDArrayIter(X, Y, batch_size=16, shuffle=True)
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mt.random.seed(0)
    mod.fit(train, num_epoch=10, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5},
            initializer=mt.init.Xavier())
    score = mod.score(mt.io.NDArrayIter(X, Y, batch_size=16), "acc")
    assert score[0][1] > 0.9, score


def test_fit_callbacks_and_eval_data(tmp_path):
    """``batch_end_callback`` sees every batch, ``eval_data`` is scored
    each epoch, and ``do_checkpoint`` writes each epoch's pair."""
    X, Y = _toy_data(n=64)
    seen = []
    prefix = str(tmp_path / "mlp")
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.fit(mt.io.NDArrayIter(X, Y, batch_size=16), num_epoch=2,
            eval_data=mt.io.NDArrayIter(X, Y, batch_size=16),
            batch_end_callback=lambda p: seen.append((p.epoch, p.nbatch)),
            epoch_end_callback=mt.callback.do_checkpoint(prefix),
            optimizer="sgd", initializer=mt.init.Xavier())
    assert seen == [(e, b) for e in range(2) for b in range(4)]
    for epoch in (1, 2):
        assert os.path.exists("%s-%04d.params" % (prefix, epoch))
    assert os.path.exists(prefix + "-symbol.json")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_across_packages(tmp_path, writer):
    """``save_checkpoint`` of either package loads with the other's
    ``load_checkpoint``, and both predict the same."""
    X, Y = _toy_data(n=48)
    prefix = str(tmp_path / "ckpt")
    src, dst = (mt, jmx) if writer == "port" else (jmx, mt)
    kw = {"context": mt.cpu()} if src is mt else {}
    mod = src.mod.Module(_mlp(src), **kw)
    mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
    mod.init_params(initializer=None, arg_params={
        n: src.nd.array(v) for n, v in _fixed_init().items()})
    mod.save_checkpoint(prefix, 3)
    sym2, arg2, aux2 = dst.model.load_checkpoint(prefix, 3)
    assert sym2.list_arguments() == _mlp(dst).list_arguments()
    kw = {"context": mt.cpu()} if dst is mt else {}
    mod2 = dst.mod.Module(sym2, **kw)
    mod2.bind([("data", (16, 10))], [("softmax_label", (16,))],
              for_training=False)
    mod2.set_params(arg2, aux2)
    p1 = mod.predict(src.io.NDArrayIter(X, Y, batch_size=16)).asnumpy()
    p2 = mod2.predict(dst.io.NDArrayIter(X, Y, batch_size=16)).asnumpy()
    np.testing.assert_allclose(p1, p2, rtol=RTOL, atol=1e-6)


def test_save_params_load_params_roundtrip(tmp_path):
    fname = str(tmp_path / "mlp.params")
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
    mod.init_params(initializer=None, arg_params={
        n: mt.nd.array(v) for n, v in _fixed_init().items()})
    mod.save_params(fname)
    mod2 = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod2.bind([("data", (16, 10))], [("softmax_label", (16,))])
    mod2.init_params(mt.init.Zero())
    mod2.load_params(fname)
    for n, v in _fixed_init().items():
        np.testing.assert_array_equal(mod2.get_params()[0][n].asnumpy(), v)


def test_module_predict_strips_pad():
    X, Y = _toy_data(n=50)
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
    mod.init_params(mt.init.Xavier())
    assert mod.predict(mt.io.NDArrayIter(X, Y, batch_size=16)).shape == \
        (50, 3)
    outs = list(mod.iter_predict(mt.io.NDArrayIter(X, Y, batch_size=16)))
    assert [o[0][0].shape[0] for o in outs] == [16, 16, 16, 2]


def test_module_input_grads_match_reference():
    """``inputs_need_grad``: the data gradient equals the reference's."""
    X, Y = _toy_data(n=16)
    grads = {}
    for lib in (jmx, mt):
        kw = {"context": mt.cpu()} if lib is mt else {}
        mod = lib.mod.Module(_mlp(lib), **kw)
        mod.bind([("data", (16, 10))], [("softmax_label", (16,))],
                 inputs_need_grad=True)
        mod.init_params(initializer=None, arg_params={
            n: lib.nd.array(v) for n, v in _fixed_init().items()})
        mod.forward_backward(next(lib.io.NDArrayIter(X, Y, batch_size=16)))
        (gin,) = mod.get_input_grads()
        grads[lib] = gin.asnumpy()
    assert grads[mt].shape == (16, 10) and np.abs(grads[mt]).sum() > 0
    np.testing.assert_allclose(grads[mt], grads[jmx], rtol=RTOL, atol=1e-7)


def test_init_optimizer_validates_kvstore():
    """A distributed kvstore raises (no parameter-server path), an unknown
    one raises; the local kinds and None are accepted."""
    def fresh():
        mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
        mod.bind([("data", (8, 10))], [("softmax_label", (8,))])
        mod.init_params(mt.init.Xavier())
        return mod

    for bad in ("dist_sync", "dist_async", "dist_device_sync"):
        with pytest.raises(ValueError, match="parameter-server"):
            fresh().init_optimizer(kvstore=bad)
    with pytest.raises(ValueError, match="not a recognized"):
        fresh().init_optimizer(kvstore="bogus")
    for ok in (None, "local", "device", mt.kvstore.create("local")):
        fresh().init_optimizer(kvstore=ok)


def test_module_bind_without_label_shapes():
    """``bind(for_training=False)`` with no label shapes infers the
    auto-created label's shape from the data."""
    fc = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=3)
    out = mt.sym.SoftmaxOutput(fc, name="softmax")
    mod = mt.mod.Module(out, context=mt.cpu())
    mod.bind(data_shapes=[("data", (5, 7))], for_training=False)
    mod.init_params(initializer=mt.init.Xavier())
    mod.forward(mt.io.DataBatch([mt.nd.ones((5, 7))], None), is_train=False)
    assert mod.get_outputs()[0].shape == (5, 3)


def test_what_is_not_ported_raises():
    """Asked-for features the port lacks raise instead of being
    dropped."""
    X, Y = _toy_data(n=16)
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="sgd")
    batch = next(mt.io.NDArrayIter(X, Y, batch_size=16))
    # the nanguard is ported (tests/test_torch_resilience.py), and so are
    # numerics capture and fit(monitor=) (tests/test_torch_numerics.py,
    # tests/test_torch_monitor.py): a captured step and a monitored fit
    # run
    tconfig.set("resilience.nanguard", "skip")
    try:
        mod.train_step(batch)
    finally:
        tconfig.unset("resilience.nanguard")
    tconfig.set("numerics.capture", "step:1")
    try:
        mod.train_step(batch)
        mt.numerics.poll("module", block=True)
        assert "grad.fc1_weight" in mt.numerics.latest("module")[1]
    finally:
        tconfig.unset("numerics.capture")
        mt.numerics.reset()
    mon = mt.monitor.Monitor(1, pattern=".*weight")
    mod.fit(mt.io.NDArrayIter(X, Y, batch_size=16), num_epoch=1,
            monitor=mon)
    assert mon.step == 1 and mon.exes == [mod._exec]
    with pytest.raises(NotImplementedError, match="optimizer states"):
        mod.save_checkpoint("unused", 1, save_optimizer_states=True)
    # group2ctxs placement is ported (tests/test_torch_multi_context.py):
    # it takes the eager route, as the reference's does
    placed = mt.mod.Module(_mlp(mt), context=mt.cpu(),
                           group2ctxs={"dev1": mt.cpu()})
    placed.bind([("data", (16, 10))], [("softmax_label", (16,))])
    placed.init_params(mt.init.Xavier())
    placed.init_optimizer(optimizer="sgd")
    assert placed._exec._placement == {} and placed._fused_active()


def test_bench_mlp_routes_agree():
    """``bench.py`` ``module_train_config``'s MLP (8 hidden FC + relu,
    head 10, ``SoftmaxOutput``, Adam lr 1e-3, ``Uniform(0.05)``) at a
    quarter of its width: the fused and eager routes agree after 5 steps
    from the same parameters and batch, to 1e-5 relative per tensor, and
    the fused route updates all 18 tensors through the fused kernel."""
    rng = np.random.RandomState(0)
    X = rng.randn(16, 16).astype(np.float32)
    Y = (rng.rand(16) * 10).astype(np.float32)
    batch = mt.io.DataBatch([mt.nd.array(X)], [mt.nd.array(Y)])

    def build():
        h = mt.sym.Variable("data")
        for i in range(8):
            h = mt.sym.FullyConnected(h, num_hidden=32, name="fc%d" % i)
            h = mt.sym.Activation(h, act_type="relu")
        h = mt.sym.FullyConnected(h, num_hidden=10, name="head")
        return mt.sym.SoftmaxOutput(h, name="softmax")

    mt.random.seed(0)
    init = None
    res = {}
    for mode in ("auto", "off"):
        tconfig.set("module.fused_step", mode)
        try:
            mod = mt.mod.Module(build(), context=mt.cpu())
            mod.bind([("data", (16, 16))], [("softmax_label", (16,))])
            if init is None:
                mod.init_params(mt.init.Uniform(0.05))
                init = mod.get_params()[0]
            else:
                mod.init_params(initializer=None, arg_params=init)
            mod.init_optimizer(optimizer="adam",
                               optimizer_params={"learning_rate": 1e-3})
            tt.reset()
            for _ in range(5):
                mod.train_step(batch)
            if mode == "auto":
                assert tt.snapshot()["counters"]["kernels.fused_step"] \
                    == 5 * 18
            res[mode] = {n: v.asnumpy()
                         for n, v in mod.get_params()[0].items()}
        finally:
            tconfig.unset("module.fused_step")
    assert len(res["auto"]) == 18
    _assert_params(res["auto"], res["off"])


def test_symbol_params_convert_copies():
    """``symbol_params_to_reference`` gives copies: a later in-place step
    leaves them as they were."""
    arg, aux = symbol_params_from_reference(_fixed_init(), {})
    assert all(v.context == mt.cpu() for v in arg.values())
    np_arg, np_aux = symbol_params_to_reference(arg, aux)
    arg["fc1_weight"]._data.add_(1.0)
    np.testing.assert_array_equal(np_arg["fc1_weight"],
                                  _fixed_init()["fc1_weight"])
    assert np_aux == {}


@pytest.mark.parametrize("kind", ["single", "list", "dict"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_nd_save_load_across_packages(tmp_path, kind, writer):
    """``nd.save`` of either package loads with the other's ``nd.load``:
    a single array, a list and a dict."""
    rng = np.random.RandomState(3)
    vals = [rng.randn(3, 4).astype(np.float32),
            rng.randn(5).astype(np.float32)]
    src, dst = (mt, jmx) if writer == "port" else (jmx, mt)
    fname = str(tmp_path / "arrays.params")
    if kind == "single":
        src.nd.save(fname, src.nd.array(vals[0]))
        got = dst.nd.load(fname)
        np.testing.assert_array_equal(got.asnumpy(), vals[0])
    elif kind == "list":
        src.nd.save(fname, [src.nd.array(v) for v in vals])
        got = dst.nd.load(fname)
        assert isinstance(got, list)
        for g, v in zip(got, vals):
            np.testing.assert_array_equal(g.asnumpy(), v)
    else:
        src.nd.save(fname, {"a": src.nd.array(vals[0]),
                            "b": src.nd.array(vals[1])})
        got = dst.nd.load(fname)
        assert sorted(got) == ["a", "b"]
        np.testing.assert_array_equal(got["b"].asnumpy(), vals[1])


def test_nd_load_mxnet_params_file_raises(tmp_path):
    """A real Apache-MXNet .params file (list magic 0x112) is read by
    ``compat`` (an empty list save loads as an empty list); a truncated
    one raises."""
    fname = str(tmp_path / "real.params")
    with open(fname, "wb") as f:   # reserved, 0 arrays, 0 names
        f.write((0x112).to_bytes(8, "little") + b"\0" * 24)
    assert mt.nd.load(fname) == []
    with open(fname, "wb") as f:
        f.write((0x112).to_bytes(8, "little") + b"\0" * 4)
    with pytest.raises(ValueError, match="truncated"):
        mt.nd.load(fname)
