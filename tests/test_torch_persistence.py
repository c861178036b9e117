"""Persistence of the training state, and the Module family, held
against the reference on the CPU.

* ``convert.gluon_params_from_reference`` pairs a one-layer recurrent
  layer's and a one-child ``HybridSequential``'s names with no
  ``prefix=`` (the names share more than the Block's own prefix).
* ``gluon.Trainer.save_states`` / ``load_states``: a round trip within
  the port continues bitwise; a states file the reference wrote loads
  (without importing the reference) and continues with the reference's
  next weights; foreign names in such a pickle are refused.
* ``SPMDTrainer.save_checkpoint`` / ``load_checkpoint``: a round trip
  within the port continues bitwise; a checkpoint the reference wrote
  (SGD with momentum, Adam) continues with the reference's next loss;
  truncated, foreign and newer-schema files raise
  ``CheckpointCorruptError``.
* ``SequentialModule``, ``PythonLossModule`` and ``FeedForward`` fit the
  test MLP to the reference's weights, and the three ``FeedForward``
  choices (ADVICE.md) hold.

Bounds: the two packages' matrix products sum in other orders, so
across packages a loss is held at ``rtol=1e-5`` and weights at
``rtol=1e-5, atol=1e-6`` (measured: 1e-7); within the port, bitwise.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu import name as jname
from mxnet_tpu.parallel import SPMDTrainer as JTrainer
from mxnet_tpu.parallel import make_mesh as jmake_mesh

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.convert import (gluon_params_from_reference,
                                     gluon_params_to_reference)
from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
from mxnet_tpu_torch.resilience import CheckpointCorruptError
from test_torch_module import _fixed_init, _mlp, _toy_data, BATCH

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------ convert, the queue-3 fault
@pytest.mark.parametrize("kind", ["gru", "lstm", "sequential"])
def test_carry_pairs_names_without_prefix(kind):
    """A one-layer GRU/LSTM (names ``gru0_l0_...``) and a
    HybridSequential with one Dense (``hybridsequential0_dense0_...``)
    pair up with no ``prefix=``, and the carried values arrive."""
    def make(lib):
        if kind == "sequential":
            net = lib.gluon.nn.HybridSequential()
            with net.name_scope():
                net.add(lib.gluon.nn.Dense(3, in_units=4))
        elif kind == "gru":
            net = lib.gluon.rnn.GRU(5, input_size=4)
        else:
            net = lib.gluon.rnn.LSTM(5, input_size=4)
        net.initialize()
        return net
    with tname.NameManager():
        pnet = make(mt)
    with jname.NameManager():
        make(jmx)
        rnet = make(jmx)     # its names carry another count: ..1_
    assert rnet.prefix != pnet.prefix
    vals = {n: p.data().asnumpy() for n, p in rnet.collect_params().items()}
    gluon_params_from_reference(pnet, vals)
    back = gluon_params_to_reference(pnet, rnet.prefix)
    assert set(back) == set(vals)
    for n in vals:
        np.testing.assert_array_equal(back[n], vals[n])


# ------------------------------------------------- gluon.Trainer states
def _dense_pair():
    with jname.NameManager():
        jnet = jmx.gluon.nn.Dense(3, in_units=4)
        jnet.initialize()
    with tname.NameManager():
        tnet = mt.gluon.nn.Dense(3, in_units=4)
        tnet.initialize(ctx=mt.cpu())
    gluon_params_from_reference(
        tnet, {n: p.data().asnumpy()
               for n, p in jnet.collect_params().items()})
    return jnet, tnet


def _gluon_step(lib, net, trainer, x, y):
    with lib.autograd.record():
        loss = ((net(lib.nd.array(x)) - lib.nd.array(y)) ** 2).sum()
    loss.backward()
    trainer.step(x.shape[0])
    return float(loss.asnumpy())


def _xy(i):
    rng = np.random.RandomState(10 + i)
    return (rng.randn(5, 4).astype(np.float32),
            rng.randn(5, 3).astype(np.float32))


def _weights(net):
    return {n[len(net.prefix):]: p.data().asnumpy().copy()
            for n, p in net.collect_params().items()}


OPTS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
        ("adam", {"learning_rate": 0.01}),
        ("rmsprop", {"learning_rate": 0.01, "centered": True})]


@pytest.mark.parametrize("name,opt", OPTS, ids=[o[0] for o in OPTS])
def test_trainer_states_round_trip_is_bitwise(name, opt, tmp_path):
    _, tnet = _dense_pair()
    tr = mt.gluon.Trainer(tnet.collect_params(), name, dict(opt))
    for i in range(2):
        _gluon_step(mt, tnet, tr, *_xy(i))
    fname = str(tmp_path / "t.states")
    tr.save_states(fname)
    saved = _weights(tnet)
    _gluon_step(mt, tnet, tr, *_xy(2))
    want = _weights(tnet)
    # a second trainer over the saved weights, states loaded
    _, tnet2 = _dense_pair()
    for n, p in tnet2.collect_params().items():
        p.set_data(mt.nd.array(saved[n[len(tnet2.prefix):]]))
    tr2 = mt.gluon.Trainer(tnet2.collect_params(), "sgd")
    tr2.load_states(fname)
    assert type(tr2.optimizer).__name__.lower() == name
    assert tr2.optimizer.param_dict[0] is tr2._params[0]
    _gluon_step(mt, tnet2, tr2, *_xy(2))
    for n, v in _weights(tnet2).items():
        np.testing.assert_array_equal(v, want[n])


@pytest.mark.parametrize("name,opt", OPTS, ids=[o[0] for o in OPTS])
def test_reference_states_file_continues_in_the_port(name, opt, tmp_path):
    jnet, tnet = _dense_pair()
    jtr = jmx.gluon.Trainer(jnet.collect_params(), name, dict(opt))
    for i in range(2):
        _gluon_step(jmx, jnet, jtr, *_xy(i))
    fname = str(tmp_path / "ref.states")
    jtr.save_states(fname)
    gluon_params_from_reference(
        tnet, {n: p.data().asnumpy()
               for n, p in jnet.collect_params().items()})
    jloss = _gluon_step(jmx, jnet, jtr, *_xy(2))
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd")
    ttr.load_states(fname)
    assert ttr.optimizer.num_update == 2
    tloss = _gluon_step(mt, tnet, ttr, *_xy(2))
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL)
    want = _weights(jnet)
    for n, v in _weights(tnet).items():
        _assert_close(v, want[n])


def test_reference_pickle_refuses_foreign_names():
    from mxnet_tpu_torch.optimizer.optimizer import Updater, create

    class Evil:
        def __reduce__(self):
            return (os.getcwd, ())
    upd = Updater(create("sgd"))
    for payload in (pickle.dumps(({0: None}, Evil())),
                    pickle.dumps(({0: None}, jmx.io.NDArrayIter))):
        with pytest.raises(pickle.UnpicklingError):
            upd.set_states(payload)


def test_kvstore_optimizer_states_round_trip(tmp_path):
    _, tnet = _dense_pair()
    tr = mt.gluon.Trainer(tnet.collect_params(), "adam",
                          {"learning_rate": 0.01}, update_on_kvstore=True)
    _gluon_step(mt, tnet, tr, *_xy(0))
    fname = str(tmp_path / "kv.states")
    tr.save_states(fname)
    tr.load_states(fname)
    assert type(tr.optimizer).__name__ == "Adam"


# ------------------------------------------------- SPMDTrainer checkpoints
def _mlp_block(lib):
    nn = lib.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, in_units=8, activation="relu"))
        net.add(nn.BatchNorm(in_channels=16))
        net.add(nn.Dense(4, in_units=16))
    return net


def _spmd_pair(opt_name, opt):
    rng = np.random.RandomState(5)
    with jname.NameManager():
        jnet = _mlp_block(jmx)
        jnet.initialize()
    with tname.NameManager():
        tnet = _mlp_block(mt)
        tnet.initialize(ctx=mt.cpu())
    vals = {n: (rng.randn(*p.shape) * 0.3).astype(np.float32)
            if "weight" in n else p.data().asnumpy()
            for n, p in jnet.collect_params().items()}
    for n, v in vals.items():
        jnet.collect_params()[n].set_data(jmx.nd.array(v))
    gluon_params_from_reference(tnet, vals)
    jtr = JTrainer(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), opt_name,
                   dict(opt), mesh=jmake_mesh({"dp": -1},
                                              jax.devices()[:1]))
    ttr = SPMDTrainer(tnet, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                      opt_name, dict(opt),
                      mesh=make_mesh({"dp": -1}, [mt.cpu()]))
    return jtr, ttr


def _spmd_batch(i):
    rng = np.random.RandomState(20 + i)
    return (rng.randn(6, 8).astype(np.float32),
            rng.randint(0, 4, (6,)).astype(np.float32))


SPMD_OPTS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
             ("adam", {"learning_rate": 0.01})]


@pytest.mark.parametrize("name,opt", SPMD_OPTS, ids=["sgd", "adam"])
def test_spmd_checkpoint_round_trip_is_bitwise(name, opt, tmp_path):
    _, tr = _spmd_pair(name, opt)
    for i in range(2):
        tr.step(*(torch.from_numpy(a) for a in _spmd_batch(i)))
    path = str(tmp_path / "t.ckpt")
    tr.save_checkpoint(path)
    want_loss = tr.step(*(torch.from_numpy(a) for a in _spmd_batch(2)))
    want = {n: v.detach().clone() for n, v in tr.params.items()}
    _, tr2 = _spmd_pair(name, opt)
    tr2.load_checkpoint(path)
    assert tr2._step_num == 2
    loss = tr2.step(*(torch.from_numpy(a) for a in _spmd_batch(2)))
    assert torch.equal(loss, want_loss)
    for n, v in tr2.params.items():
        assert torch.equal(v.detach(), want[n]), n
    for n in tr.fn.trainable:
        for a, b in zip(torch.utils._pytree.tree_leaves(tr.opt_state[n]),
                        torch.utils._pytree.tree_leaves(tr2.opt_state[n])):
            assert torch.equal(a, b), n


@pytest.mark.parametrize("name,opt", SPMD_OPTS, ids=["sgd", "adam"])
def test_reference_checkpoint_continues_in_the_port(name, opt, tmp_path):
    jtr, ttr = _spmd_pair(name, opt)
    for i in range(2):
        jtr.step(*_spmd_batch(i))
    path = str(tmp_path / "ref.ckpt")
    jtr.save_checkpoint(path)
    jloss = float(jtr.step(*_spmd_batch(2)))
    ttr.load_checkpoint(path)
    tloss = float(ttr.step(*(torch.from_numpy(a)
                             for a in _spmd_batch(2))))
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL)
    # and the port's checkpoint loads in the reference
    port_path = str(tmp_path / "port.ckpt")
    ttr.save_checkpoint(port_path)
    jtr.load_checkpoint(port_path)
    assert int(jtr._step_num) == 3


def test_checkpoint_corruption_raises(tmp_path):
    _, tr = _spmd_pair(*SPMD_OPTS[0])
    tr.step(*(torch.from_numpy(a) for a in _spmd_batch(0)))
    good = str(tmp_path / "good.ckpt")
    tr.save_checkpoint(good)
    raw = open(good, "rb").read()
    cases = {"truncated": raw[:len(raw) // 2],
             "foreign": pickle.dumps([1, 2, 3]),
             "garbage": b"not a pickle at all"}
    host = pickle.loads(raw)
    host["schema"] = 99
    cases["newer"] = pickle.dumps(host)
    for what, blob in cases.items():
        path = str(tmp_path / (what + ".ckpt"))
        with open(path, "wb") as f:
            f.write(blob)
        with pytest.raises(CheckpointCorruptError):
            tr.load_checkpoint(path)
    with pytest.raises(CheckpointCorruptError):
        tr.load_checkpoint(str(tmp_path / "missing.ckpt"))


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A failed write leaves the previous checkpoint whole."""
    _, tr = _spmd_pair(*SPMD_OPTS[0])
    tr.step(*(torch.from_numpy(a) for a in _spmd_batch(0)))
    path = str(tmp_path / "c.ckpt")
    tr.save_checkpoint(path)
    before = open(path, "rb").read()

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(pickle, "dump", boom)
    with pytest.raises(OSError):
        tr.save_checkpoint(path)
    assert open(path, "rb").read() == before
    assert os.listdir(tmp_path) == ["c.ckpt"]


# ------------------------------------------------- the Module family
def _seq_module(lib, loss_head):
    data = lib.sym.Variable("data")
    h = lib.sym.FullyConnected(data, num_hidden=32, name="fc1")
    h = lib.sym.Activation(h, act_type="relu", name="relu1")
    h = lib.sym.FullyConnected(h, num_hidden=3, name="fc2")
    kw = {"context": mt.cpu()} if lib is mt else {}
    seq = lib.mod.SequentialModule()
    seq.add(lib.mod.Module(h, label_names=(), **kw))
    if loss_head == "softmax":
        label = lib.sym.Variable("softmax_label")
        out = lib.sym.SoftmaxOutput(lib.sym.Variable("data"), label,
                                    name="softmax")
        seq.add(lib.mod.Module(out, **kw), take_labels=True,
                auto_wiring=True)
    else:
        def grad(scores, labels):
            s = scores.asnumpy()
            p = np.exp(s - s.max(axis=1, keepdims=True))
            p /= p.sum(axis=1, keepdims=True)
            p[np.arange(len(p)), labels.asnumpy().astype(int)] -= 1
            return p / len(p)
        seq.add(lib.mod.PythonLossModule(grad_func=grad), take_labels=True)
    return seq


@pytest.mark.parametrize("head", ["softmax", "pyloss"])
def test_sequential_module_fits_as_the_reference(head):
    X, Y = _toy_data()
    got = {}
    for lib in (jmx, mt):
        seq = _seq_module(lib, head)
        it = lib.io.NDArrayIter(X, Y, batch_size=BATCH)
        # (name, shape) pairs: the reference's SequentialModule cannot
        # take DataDescs (the port's can: test_sequential_module_binds_
        # data_descs)
        seq.bind([("data", (BATCH, 10))], [("softmax_label", (BATCH,))])
        seq.init_params(arg_params={n: lib.nd.array(v)
                                    for n, v in _fixed_init().items()})
        seq.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        for batch in it:
            seq.forward(batch, is_train=True)
            seq.backward()
            seq.update()
        got[lib] = {n: v.asnumpy() for n, v in seq.get_params()[0].items()}
    assert set(got[mt]) == set(got[jmx])
    for n in got[jmx]:
        _assert_close(got[mt][n], got[jmx][n])


def test_sequential_module_binds_data_descs():
    """The port's SequentialModule binds from ``provide_data`` (DataDescs),
    where the reference's fails."""
    X, Y = _toy_data()
    seq = _seq_module(mt, "softmax")
    it = mt.io.NDArrayIter(X, Y, batch_size=BATCH)
    seq.bind(it.provide_data, it.provide_label)
    seq.init_params(arg_params={n: mt.nd.array(v)
                                for n, v in _fixed_init().items()})
    seq.forward(next(it), is_train=False)
    assert seq.output_shapes == [("softmax_output", (BATCH, 3))]
    with pytest.raises(ValueError):
        ref = _seq_module(jmx, "softmax")
        ref.bind(jmx.io.NDArrayIter(X, Y, batch_size=BATCH).provide_data,
                 jmx.io.NDArrayIter(X, Y, batch_size=BATCH).provide_label)


def test_python_module_shapes_and_metric():
    pm = mt.mod.PythonLossModule()
    pm.bind([("data", (4, 3))], [("softmax_label", (4,))])
    assert pm.output_shapes == [("pyloss_output", (4, 3))]
    assert pm.get_params() == ({}, {})
    with pytest.raises(NotImplementedError):
        pm.forward(mt.io.DataBatch([mt.nd.zeros((4, 3))],
                                   [mt.nd.zeros((4,))]))
        pm.backward()


def _ff_data():
    X, Y = _toy_data()
    return X, Y


def test_feedforward_fits_predicts_and_scores_as_the_reference(tmp_path):
    X, Y = _ff_data()
    out = {}
    for lib in (jmx, mt):
        arg = {n: lib.nd.array(v) for n, v in _fixed_init().items()}
        ff = lib.model.FeedForward(_mlp(lib), num_epoch=2,
                                   numpy_batch_size=BATCH, arg_params=arg,
                                   learning_rate=0.1, **(
                                       {"ctx": mt.cpu()} if lib is mt
                                       else {}))
        np.random.seed(3)
        ff.fit(X, Y)
        pred = ff.predict(X)
        score = ff.score(lib.io.NDArrayIter(X, Y, batch_size=BATCH))
        prefix = str(tmp_path / ("ff_" + lib.__name__))
        ff.save(prefix, 2)
        out[lib] = ({n: v.asnumpy() for n, v in ff.arg_params.items()},
                    pred, score, prefix)
    for n, v in out[jmx][0].items():
        _assert_close(out[mt][0][n], v)
    _assert_close(out[mt][1], out[jmx][1])
    assert out[mt][2] == out[jmx][2]
    # each package loads the other's save
    loaded = mt.model.FeedForward.load(out[jmx][3], 2, ctx=mt.cpu())
    _assert_close(loaded.predict(X), out[jmx][1])


def test_feedforward_choices_that_differ_from_the_reference():
    """The three ``ADVICE.md`` faults of the reference's copy, fixed in
    the port's: an unfitted model refuses to predict; ``allow_extra_
    params`` allows extra parameters (and refuses missing ones); ``score``
    calls its ``batch_end_callback``."""
    X, Y = _ff_data()
    ff = mt.model.FeedForward(_mlp(mt), ctx=mt.cpu(),
                              numpy_batch_size=BATCH)
    with pytest.raises(RuntimeError, match="fit"):
        ff.predict(X)
    arg = {n: mt.nd.array(v) for n, v in _fixed_init().items()}
    extra = dict(arg, unused_weight=mt.nd.zeros((2,)))
    with pytest.raises(ValueError, match="unused_weight"):
        mt.model.FeedForward(_mlp(mt), ctx=mt.cpu(), arg_params=extra,
                             numpy_batch_size=BATCH).predict(X)
    assert mt.model.FeedForward(
        _mlp(mt), ctx=mt.cpu(), arg_params=extra, allow_extra_params=True,
        numpy_batch_size=BATCH).predict(X).shape == (len(X), 3)
    missing = {n: v for n, v in arg.items() if n != "fc2_bias"}
    with pytest.raises(RuntimeError, match="fc2_bias"):
        mt.model.FeedForward(_mlp(mt), ctx=mt.cpu(), arg_params=missing,
                             allow_extra_params=True,
                             numpy_batch_size=BATCH).predict(X)
    seen = []
    mt.model.FeedForward(_mlp(mt), ctx=mt.cpu(), arg_params=arg,
                         numpy_batch_size=BATCH).score(
        mt.io.NDArrayIter(X, Y, batch_size=BATCH),
        batch_end_callback=lambda p: seen.append(p.nbatch))
    assert seen == list(range(len(X) // BATCH))
