"""mx.monitor.Monitor in the port against the reference's: the same
(step, name, stat) rows on the same MLP from the same weights, on the
fused and on the eager Module step; the fused route stays fused (one
warning), a raw callback runs eager, install/uninstall follow
tests/test_monitor.py:145-175, fit(monitor=) installs, and toc() feeds
the telemetry sink."""
import contextlib
import json
import logging

import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu_torch as mt
from mxnet_tpu import config as rconfig
from mxnet_tpu_torch import config, profiler, telemetry


def _mlp(lib):
    data = lib.sym.Variable("data")
    label = lib.sym.Variable("softmax_label")
    h = lib.sym.FullyConnected(data, num_hidden=16, name="fc1")
    h = lib.sym.Activation(h, act_type="relu", name="relu1")
    h = lib.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return lib.sym.SoftmaxOutput(h, label, name="softmax")


def _data():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(32, 10)).astype(np.float32)
    Y = np.argmax(X[:, :3], axis=1).astype(np.float32)
    return X, Y


def _weights():
    rng = np.random.RandomState(7)
    return {"fc1_weight": rng.randn(16, 10).astype(np.float32) * 0.1,
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rng.randn(3, 16).astype(np.float32) * 0.1,
            "fc2_bias": np.zeros(3, np.float32)}


def _module(lib, mode):
    (rconfig if lib is ref else config).set("module.fused_step", mode)
    kw = {} if lib is ref else {"context": mt.cpu()}
    mod = lib.mod.Module(_mlp(lib), **kw)
    mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
    arrays = {n: lib.nd.array(v, **({} if lib is ref else {"ctx": mt.cpu()}))
              for n, v in _weights().items()}
    mod.init_params(initializer=None, arg_params=arrays)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    return mod


@pytest.fixture(autouse=True)
def _restore():
    yield
    config.unset("module.fused_step")
    config.unset("telemetry.sink")
    rconfig.set("module.fused_step", "auto")


def _rows(lib, mode, steps=2):
    X, Y = _data()
    mod = _module(lib, mode)
    mon = lib.monitor.Monitor(interval=1, pattern=".*")
    mon.install(mod._exec)
    rows = []
    with mt.cpu() if lib is mt else contextlib.nullcontext():
        for batch in lib.io.NDArrayIter(X, Y, batch_size=16):
            mon.tic()
            mod.train_step(batch)
            rows += mon.toc()
    assert len(rows) > 0 and mon.step == steps
    return {(n, k): float(v) for n, k, v in rows}


@pytest.mark.parametrize("mode", ["on", "off"])
def test_monitor_rows_match_the_reference(mode):
    fused0 = profiler.counters()["fused_steps"]
    got = _rows(mt, mode)
    fused = profiler.counters()["fused_steps"] - fused0
    want = _rows(ref, mode)
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        assert got[key] == pytest.approx(v, rel=1e-5, abs=1e-7), key
    # the Monitor keeps the fused route fused; its outputs fire
    assert fused == (2 if mode == "on" else 0)
    assert ((1, "softmax_output") in got) and ((2, "fc2_bias") in got)


def test_fused_monitor_warns_once_and_raw_callback_runs_eager(caplog):
    X, Y = _data()
    mod = _module(mt, "on")
    mon = mt.monitor.Monitor(interval=1)
    mon.install(mod._exec)
    with mt.cpu(), caplog.at_level(logging.WARNING):
        it = mt.io.NDArrayIter(X, Y, batch_size=16)
        for batch in it:
            mod.train_step(batch)
        it.reset()
        batch = next(it)
    hits = [r for r in caplog.records
            if "Monitor installed on a FUSED" in r.getMessage()]
    assert len(hits) == 1
    seen = []
    mod._exec.set_monitor_callback(lambda name, arr: seen.append(name))
    fused0 = profiler.counters()["fused_steps"]
    mod.train_step(batch)
    assert profiler.counters()["fused_steps"] == fused0
    assert seen == ["softmax_output"]


def test_install_and_uninstall_follow_the_reference():
    mod = _module(mt, "on")
    mon = mt.monitor.Monitor(interval=1)
    mon.install(mod._exec)
    mon.install(mod._exec)   # reinstall: no leak
    assert len(mon.exes) == 1
    mon.uninstall(mod._exec)
    assert mon.exes == [] and mod._exec._monitor is None
    mon.uninstall(mod._exec)  # unknown exe: ignored
    mon.install(mod._exec)
    other = lambda name, arr: None  # noqa: E731
    mod._exec.set_monitor_callback(other)
    mon.uninstall(mod._exec)   # not ours anymore: callback kept
    assert mod._exec._monitor is other
    mon.install(mod._exec)
    mon.uninstall_all()
    assert mon.exes == [] and mod._exec._monitor is None


def test_fit_installs_monitor_and_toc_feeds_the_sink(tmp_path):
    log = tmp_path / "mon.jsonl"
    config.set("telemetry.sink", "jsonl:%s" % log)
    X, Y = _data()
    config.set("module.fused_step", "on")
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mon = mt.monitor.Monitor(interval=1, pattern=".*weight")
    with mt.cpu():
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=16), num_epoch=1,
                optimizer="sgd", optimizer_params={"learning_rate": 0.1},
                initializer=mt.init.Uniform(0.1), monitor=mon)
    config.unset("telemetry.sink")
    assert any(e is mod._exec for e in mon.exes) and mon.step == 2
    events = [json.loads(line) for line in log.read_text().splitlines()]
    mons = [e for e in events if e["event"] == "monitor"]
    assert sorted((e["step"], e["name"]) for e in mons) == [
        (1, "fc1_weight"), (1, "fc2_weight"), (2, "fc1_weight"),
        (2, "fc2_weight")]
    assert all(isinstance(e["stat"], float) for e in mons)
    assert [e["path"] for e in events if e["event"] == "step"] == \
        ["fused", "fused"]
