"""The port's imperative Gluon loop held against the reference's, on the
CPU: LeNet (``examples/gluon_mnist.py``'s ``build_lenet``) trained by
``gluon.Trainer`` (SGD lr 0.02, momentum 0.9, kvstore "device") on the
same ``NDArrayIter`` batches of the same synthetic digits, from the same
weights (drawn by the port, carried across with
``convert.gluon_params_to_reference``).  Then the kvstore choices, the
learning-rate controls, ``NDArrayIter``'s last-batch modes, the metric
suite, and ``SPMDTrainer`` beside the tape.

Tolerance for the LeNet steps: losses and every parameter after each
step within ``rtol=1e-5, atol=1e-6`` (f32 on both sides; the two
packages' convolutions and reductions sum in other orders, measured
2e-6 of each tensor's largest value after 3 steps).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.name
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mt
import mxnet_tpu_torch.name
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import (gluon_params_from_reference,
                                     gluon_params_to_reference)
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh

RTOL, ATOL = 1e-5, 1e-6
OPT = {"learning_rate": 0.02, "momentum": 0.9}
BATCH = 32
STEPS = 3


def build_lenet(nn):
    """``examples/gluon_mnist.py:27``, for either package."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(20, 5), nn.MaxPool2D(2, 2), nn.Activation("tanh"),
            nn.Conv2D(50, 5), nn.MaxPool2D(2, 2), nn.Activation("tanh"),
            nn.Flatten(), nn.Dense(500, activation="tanh"), nn.Dense(10))
    return net


def synthetic_mnist(n, seed=0):
    """``examples/gluon_mnist.py:35``: class k lights a kth stripe."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = rng.uniform(0, 0.2, (n, 1, 28, 28)).astype(np.float32)
    for i, k in enumerate(y):
        x[i, 0, 2 * k:2 * k + 3, :] += 0.8
    return x, y.astype(np.float32)


def _port_lenet(x0):
    with mt.name.NameManager():
        net = build_lenet(tnn)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu())
    net(mt.nd.array(x0, ctx=mt.cpu()))
    return net


def _nets(x0):
    """The port's LeNet and the reference's with the port's weights."""
    tnet = _port_lenet(x0)
    with jmx.name.NameManager():
        jnet = build_lenet(jnn)
    jnet.initialize(jmx.init.Zero())
    jnet(jmx.nd.array(x0))
    jp = jnet.collect_params()
    for name, val in gluon_params_to_reference(tnet, "").items():
        jp[name].set_data(jmx.nd.array(val))
    return tnet, jnet


def _port_step(net, trainer, loss_fn, batch):
    with tag.record():
        loss = loss_fn(net(batch.data[0]), batch.label[0]).mean()
    loss.backward()
    trainer.step(1)
    return float(loss.asnumpy())


def test_lenet_trainer_steps_match_reference():
    X, Y = synthetic_mnist(4 * BATCH)
    with mt.cpu():
        tnet, jnet = _nets(X[:1])
        tnet.hybridize()
        jnet.hybridize()
        ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
        jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
        tl = tgluon.loss.SoftmaxCrossEntropyLoss()
        jl = jgluon.loss.SoftmaxCrossEntropyLoss()
        np.random.seed(11)
        titer = mt.io.NDArrayIter(X, Y, batch_size=BATCH, shuffle=True)
        np.random.seed(11)
        jiter = jmx.io.NDArrayIter(X, Y, batch_size=BATCH, shuffle=True)
        for _, tb, jb in zip(range(STEPS), titer, jiter):
            np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                          jb.data[0].asnumpy())
            tloss = _port_step(tnet, ttr, tl, tb)
            with jag.record():
                jloss = jl(jnet(jb.data[0]), jb.label[0]).mean()
            jloss.backward()
            jtr.step(1)
            np.testing.assert_allclose(tloss, float(jloss.asnumpy()),
                                       rtol=RTOL, atol=ATOL)
            ours = gluon_params_to_reference(tnet, "")
            for name, p in jnet.collect_params().items():
                np.testing.assert_allclose(ours[name], p.data().asnumpy(),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=name)
                np.testing.assert_allclose(
                    tnet.collect_params()[name].grad().asnumpy(),
                    p.grad().asnumpy(), rtol=RTOL, atol=ATOL,
                    err_msg=name)


#: the f16 multi_precision Trainer cases: (optimizer, its options)
F16_OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
                    "multi_precision": True},
            "adam": {"learning_rate": 0.01, "multi_precision": True}}
#: f16 losses of the two packages: the same f16 weights and inputs, the
#: products summed in other orders; f16 keeps 11 significant bits, and a
#: few roundings of the 10-way log-softmax stay well inside 2^-8
F16_LOSS_RTOL = 2.0 ** -8


def _f16_mlp(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(64, activation="tanh"), nn.Dense(10))
    return net


@pytest.mark.parametrize("tier", [True, False], ids=["tier_on", "tier_off"])
@pytest.mark.parametrize("opt", sorted(F16_OPTS))
def test_f16_multi_precision_trainer_matches_reference(opt, tier):
    """MXNet's usual mixed precision: f16 weights, ``multi_precision=True``
    (f32 masters in the optimizer state), through ``gluon.Trainer``.  With
    the tier on the port updates through the fused step (K1 / K3 on the
    card, their plain versions here), with it off through ``step`` and a
    cast.  Each step both packages take the reference's f16 gradients (the
    two backward passes round f16 products in other orders, one f16 ulp
    here and there, which Adam's first steps would magnify into whole
    learning rates); the weights must then equal the reference's bit for
    bit after every one of 3 steps, and the losses agree within
    F16_LOSS_RTOL."""
    rng = np.random.RandomState(5)
    X = rng.randn(32, 20).astype(np.float32)
    Y = rng.randint(0, 10, 32).astype(np.float32)
    mt.config.set("kernels.enabled", tier)
    jmx.config.set("kernels.enabled", tier)
    try:
        with mt.cpu():
            with mt.name.NameManager():
                tnet = _f16_mlp(tnn)
            tnet.initialize(mt.init.Xavier(), ctx=mt.cpu())
            tnet(mt.nd.array(X[:1], ctx=mt.cpu()))
            tnet.cast("float16")
            with jmx.name.NameManager():
                jnet = _f16_mlp(jnn)
            jnet.initialize(jmx.init.Zero())
            jnet(jmx.nd.array(X[:1]))
            jnet.cast("float16")
            jp = jnet.collect_params()
            for name, val in gluon_params_to_reference(tnet, "").items():
                jp[name].set_data(jmx.nd.array(val, dtype="float16"))
            ttr = tgluon.Trainer(tnet.collect_params(), opt,
                                 dict(F16_OPTS[opt]))
            jtr = jgluon.Trainer(jp, opt, dict(F16_OPTS[opt]))
            tl = tgluon.loss.SoftmaxCrossEntropyLoss()
            jl = jgluon.loss.SoftmaxCrossEntropyLoss()
            tt.reset()
            for _ in range(STEPS):
                with tag.record():
                    tloss = tl(tnet(mt.nd.array(X, ctx=mt.cpu(),
                                                dtype="float16")),
                               mt.nd.array(Y, ctx=mt.cpu())).mean()
                tloss.backward()
                with jag.record():
                    jloss = jl(jnet(jmx.nd.array(X, dtype="float16")),
                               jmx.nd.array(Y)).mean()
                jloss.backward()
                np.testing.assert_allclose(float(tloss.asnumpy()),
                                           float(jloss.asnumpy()),
                                           rtol=F16_LOSS_RTOL)
                tparams = tnet.collect_params()
                for tp, p in zip(tparams.values(), jp.values()):
                    tp.grad()._data.copy_(torch.from_numpy(
                        p.grad().asnumpy().copy()))
                ttr.step(1)
                jtr.step(1)
                for (name, tp), p in zip(tparams.items(), jp.values()):
                    got, want = tp.data().asnumpy(), p.data().asnumpy()
                    assert got.dtype == want.dtype == np.float16, name
                    np.testing.assert_array_equal(got.view(np.uint16),
                                                  want.view(np.uint16),
                                                  err_msg=name)
            fused = tt.snapshot()["counters"].get("kernels.fused_step", 0)
            assert fused == (STEPS * len(jp) if tier else 0)
    finally:
        mt.config.unset("kernels.enabled")
        jmx.config.unset("kernels.enabled")


def test_params_carry_back_from_reference():
    """``gluon_params_from_reference`` is the inverse direction: the
    reference's values land on the port's LeNet, names paired."""
    X, _ = synthetic_mnist(2)
    with mt.cpu():
        tnet, jnet = _nets(X[:1])
        vals = {n: p.data().asnumpy() * 2
                for n, p in jnet.collect_params().items()}
        gluon_params_from_reference(tnet, vals)
        for name, p in tnet.collect_params().items():
            np.testing.assert_array_equal(p.data().asnumpy(), vals[name])


@pytest.mark.parametrize("kvstore,on_kv", [("local", None), (None, None),
                                           ("device", True)])
def test_kvstore_choice_gives_equal_updates(kvstore, on_kv):
    X, Y = synthetic_mnist(2 * BATCH, seed=1)
    with mt.cpu():
        nets = [_port_lenet(X[:1]) for _ in range(2)]
        vals = gluon_params_to_reference(nets[0], "")
        gluon_params_from_reference(nets[1], vals)
        trainers = [tgluon.Trainer(n.collect_params(), "sgd", dict(OPT),
                                   kvstore=kv, update_on_kvstore=up)
                    for n, kv, up in zip(nets, ("device", kvstore),
                                         (None, on_kv))]
        loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
        for net, tr in zip(nets, trainers):
            it = mt.io.NDArrayIter(X, Y, batch_size=BATCH)
            for batch in it:
                _port_step(net, tr, loss_fn, batch)
        a = gluon_params_to_reference(nets[0], "")
        b = gluon_params_to_reference(nets[1], "")
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
    assert trainers[0]._kvstore.type == "device"
    assert not trainers[0]._update_on_kvstore
    assert (trainers[1]._kvstore is None) == (kvstore is None)
    assert bool(trainers[1]._update_on_kvstore) == bool(on_kv)


def test_kvstore_sums_pushed_values_and_runs_the_updater():
    with mt.cpu():
        kv = mt.kvstore.create("device")
        assert (kv.type, kv.rank, kv.num_workers) == ("device", 0, 1)
        kv.init(3, mt.nd.zeros((2,)))
        kv.push(3, [mt.nd.array([1.0, 2.0]), mt.nd.array([3.0, 4.0])])
        out = mt.nd.zeros((2,))
        kv.pull(3, out=out)
        np.testing.assert_array_equal(out.asnumpy(), [4.0, 6.0])
        kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.5))
        kv.pushpull(3, mt.nd.array([2.0, 2.0]), out=out)
        np.testing.assert_array_equal(out.asnumpy(), [3.0, 5.0])
    with pytest.raises(NotImplementedError):
        mt.kvstore.create("dist_sync")
    with pytest.raises(ValueError):
        mt.kvstore.create("bogus")


def _lr_run(pkg, trainer_of, steps=5):
    """The learning rates a Trainer reports and the weights after each of
    ``steps`` updates of a one-parameter problem."""
    mx = mt if pkg == "port" else jmx
    w = mx.gluon.Parameter("w", shape=(2,))
    w.initialize(mx.init.One(), ctx=mx.cpu())
    tr = trainer_of(mx, w)
    lrs, ws = [], []
    for i in range(steps):
        x = w.data()
        with (tag if pkg == "port" else jag).record():
            y = (x * x).sum()
        y.backward()
        tr.step(1)
        lrs.append(tr.learning_rate)
        ws.append(w.data().asnumpy().copy())
    return lrs, ws


def _factor_trainer(mx, w):
    sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    return mx.gluon.Trainer([w], "sgd", {"learning_rate": 0.1,
                                         "lr_scheduler": sched})


def test_factor_scheduler_tracks_reference():
    with mt.cpu():
        ours = _lr_run("port", _factor_trainer)
    theirs = _lr_run("reference", _factor_trainer)
    np.testing.assert_allclose(ours[0], theirs[0], rtol=0, atol=0)
    np.testing.assert_allclose(ours[1], theirs[1], rtol=RTOL, atol=ATOL)


def test_set_learning_rate_tracks_reference():
    def run(pkg):
        mx = mt if pkg == "port" else jmx
        ag = tag if pkg == "port" else jag
        w = mx.gluon.Parameter("w", shape=(3,))
        w.initialize(mx.init.One(), ctx=mx.cpu())
        tr = mx.gluon.Trainer([w], "sgd", {"learning_rate": 0.1,
                                           "momentum": 0.9})
        out = []
        for i, lr in enumerate((0.1, 0.05, 0.05, 0.2)):
            tr.set_learning_rate(lr)
            with ag.record():
                y = (w.data() * w.data() * float(i + 1)).sum()
            y.backward()
            tr.step(2)
            out.append((tr.learning_rate, w.data().asnumpy().copy()))
        return out

    with mt.cpu():
        ours = run("port")
    for (tlr, tw), (jlr, jw) in zip(ours, run("reference")):
        assert tlr == jlr
        np.testing.assert_allclose(tw, jw, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_batches_equal_reference(mode, shuffle):
    X = np.arange(23 * 3, dtype=np.float64).reshape(23, 3)
    Y = np.arange(23, dtype=np.int64)

    def epochs(io):
        np.random.seed(5)
        it = io.NDArrayIter(X, Y, batch_size=5, shuffle=shuffle,
                            last_batch_handle=mode)
        out = []
        for _ in range(3):
            for b in it:
                out.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad))
            it.reset()
        return out, it.provide_data, it.provide_label

    with mt.cpu():
        ours, tdesc, tldesc = epochs(mt.io)
    theirs, jdesc, jldesc = epochs(jmx.io)
    assert len(ours) == len(theirs) > 0
    for (td, tl, tp), (jd, jl, jp) in zip(ours, theirs):
        assert td.dtype == jd.dtype and tl.dtype == jl.dtype
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        assert tp == jp
    assert [tuple(d) for d in tdesc] == [tuple(d) for d in jdesc]
    assert [tuple(d) for d in tldesc] == [tuple(d) for d in jldesc]


_METRICS = [("acc", {}), ("top_k_accuracy", {"top_k": 3}), ("ce", {}),
            ("nll_loss", {}), ("perplexity", {"ignore_label": None}),
            ("mae", {}), ("mse", {}), ("rmse", {}), ("f1", {}),
            ("mcc", {}), ("pearsonr", {}), ("loss", {})]


@pytest.mark.parametrize("name,kwargs", _METRICS, ids=[m[0] for m in
                                                       _METRICS])
def test_metric_equals_reference(name, kwargs):
    rng = np.random.RandomState(9)
    n, k = 40, 2 if name in ("f1", "mcc") else 6
    logits = rng.randn(n, k).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.randint(0, k, n).astype(np.float32)
    if name in ("mae", "mse", "rmse", "pearsonr"):
        preds, labels = logits[:, :1], rng.randn(n, 1).astype(np.float32)
    elif name == "loss":
        preds = np.abs(logits[:, 0])
    else:
        preds = probs
    results = []
    for mx in (mt, jmx):
        m = mx.metric.create(name, **kwargs)
        for lo in range(0, n, 16):
            m.update([mx.nd.array(labels[lo:lo + 16], ctx=mx.cpu())],
                     [mx.nd.array(preds[lo:lo + 16], ctx=mx.cpu())])
        results.append(m.get())
    (tname, tval), (jname, jval) = results
    assert tname == jname
    np.testing.assert_allclose(tval, jval, rtol=1e-6, atol=1e-7)


def test_composite_and_custom_metrics_equal_reference():
    rng = np.random.RandomState(10)
    probs = rng.rand(12, 4).astype(np.float32)
    labels = rng.randint(0, 4, 12).astype(np.float32)
    feval = lambda lab, pred: float((pred.argmax(-1) == lab).mean())
    results = []
    for mx in (mt, jmx):
        comp = mx.metric.create(["acc", mx.metric.np(feval, name="mine")])
        comp.update([mx.nd.array(labels, ctx=mx.cpu())],
                    [mx.nd.array(probs, ctx=mx.cpu())])
        results.append(comp.get())
    assert results[0][0] == results[1][0]
    np.testing.assert_allclose(results[0][1], results[1][1], rtol=1e-7)


def test_callbacks_run_on_a_metric(capsys):
    with mt.cpu():
        m = mt.metric.Accuracy()
        m.update([mt.nd.array([1.0, 0.0])],
                 [mt.nd.array([[0.2, 0.8], [0.9, 0.1]])])
    sp = mt.callback.Speedometer(batch_size=2, frequent=1)
    for nbatch in range(3):
        sp(mt.callback.BatchEndParam(epoch=0, nbatch=nbatch,
                                     eval_metric=m, locals=None))
    mt.callback.ProgressBar(total=4)(mt.callback.BatchEndParam(
        0, 2, None, None))
    mt.callback.LogValidationMetricsCallback()(mt.callback.BatchEndParam(
        0, 0, m, None))
    assert "50.0%" in capsys.readouterr().out


def test_trainer_options_not_ported_raise():
    with mt.cpu():
        w = mt.gluon.Parameter("w", shape=(2,))
        w.initialize(ctx=mt.cpu())
        with pytest.raises(NotImplementedError):
            tgluon.Trainer([w], "sgd", {}, compression_params={"type": "2bit"})
        tr = tgluon.Trainer([w], "sgd", {})
        for call in (lambda: tr.save_states("x"), lambda: tr.load_states("x"),
                     lambda: tr.set_preemption_save(lambda: None)):
            with pytest.raises(NotImplementedError):
                call()
        mt.config.set("resilience.nanguard", "abort")
        try:
            with pytest.raises(NotImplementedError):
                tr.step(1)
        finally:
            mt.config.unset("resilience.nanguard")


def test_updater_states_round_trip_as_bytes():
    with mt.cpu():
        opt = mt.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
        up = mt.optimizer.get_updater(opt)
        w = mt.nd.array([1.0, 2.0])
        up(0, mt.nd.array([0.5, 0.5]), w)
        blob = up.get_states()
        other = mt.optimizer.get_updater(opt)
        other.set_states(blob)
        np.testing.assert_array_equal(other.states[0].numpy(),
                                      up.states[0].numpy())
        w2 = w.copy()
        up(0, mt.nd.array([0.5, 0.5]), w)
        other(0, mt.nd.array([0.5, 0.5]), w2)
        np.testing.assert_array_equal(w.asnumpy(), w2.asnumpy())
        # with the optimizer: it comes back without its Parameters
        third = mt.optimizer.get_updater(mt.optimizer.create("sgd"))
        third.set_states(up.get_states(dump_optimizer=True))
        assert (third.optimizer.lr, third.optimizer.momentum) == (0.1, 0.9)
        assert third.optimizer.param_dict == {}
        np.testing.assert_array_equal(third.states[0].numpy(),
                                      up.states[0].numpy())


def _spmd_losses(net, X, Y, steps=2):
    tr = SPMDTrainer(net, tgluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     dict(OPT), mesh=make_mesh({"dp": -1}, [mt.cpu()]))
    losses = [float(tr.step(torch.from_numpy(X), torch.from_numpy(Y)))
              for _ in range(steps)]
    tr.sync()
    return losses


def test_spmd_trainer_unchanged_by_the_tape():
    """The trap: SPMDTrainer differentiates its own tensors with recording
    off.  Its losses and weights are the same bit for bit whether or not
    the caller is inside ``autograd.record()``, and it leaves the
    Parameters' grad buffers and tape marks alone."""
    X, Y = synthetic_mnist(8, seed=2)
    with mt.cpu():
        nets = [_port_lenet(X[:1]) for _ in range(2)]
        gluon_params_from_reference(nets[1],
                                    gluon_params_to_reference(nets[0], ""))
        plain = _spmd_losses(nets[0], X, Y)
        with tag.record():
            taped = _spmd_losses(nets[1], X, Y)
        assert plain == taped
        a = gluon_params_to_reference(nets[0], "")
        b = gluon_params_to_reference(nets[1], "")
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
        for p in nets[0].collect_params().values():
            assert not p.grad().asnumpy().any()
            assert p.data()._grad_req == "write"


def _two_epochs(mx, ag, gluon, nn):
    """examples/gluon_mnist.py's loop at its defaults (2048 synthetic
    digits, batch 64, 2 epochs, SGD lr 0.02 momentum 0.9), numpy and the
    framework seeded with 0; returns each epoch's accuracy."""
    mx.random.seed(0)
    np.random.seed(0)
    X, Y = synthetic_mnist(2048)
    it = mx.io.NDArrayIter(X, Y, batch_size=64, shuffle=True)
    net = build_lenet(nn)
    net.initialize(mx.init.Xavier())
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    accs = []
    for _ in range(2):
        metric.reset()
        it.reset()
        for b in it:
            with ag.record():
                out = net(b.data[0])
                loss = loss_fn(out, b.label[0]).mean()
            loss.backward()
            tr.step(1)
            metric.update([b.label[0]], [out])
        accs.append(metric.get()[1])
    return accs


def test_lenet_two_epochs_reach_reference_accuracy():
    """The reference's epoch-2 accuracy on the CPU is the bar
    ``chip_smoke.py`` holds the port to on the card (LENET_REF_ACC, less
    LENET_ACC_SLACK); the port on the CPU clears it too.  The two draw
    their weights from their own generators, so only the accuracies
    compare."""
    import importlib.util
    import os
    ref = _two_epochs(jmx, jag, jgluon, jnn)
    with mt.cpu():
        ours = _two_epochs(mt, tag, tgluon, tnn)
    print("LeNet epoch accuracies: reference %s, port %s" % (ref, ours))
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert ref[-1] == smoke.LENET_REF_ACC
    assert ours[-1] >= ref[-1] - smoke.LENET_ACC_SLACK
