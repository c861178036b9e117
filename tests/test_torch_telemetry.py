"""The port's telemetry registry and JSONL step log (mxnet_tpu_torch
.telemetry) against the reference's: the time windows, the step records
of the three train loops validated by BOTH packages' validators, the
reference's report tool reading the port's log, and the sink-off
contract."""
import json
import os
import sys
import threading

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu import telemetry as rtel
from mxnet_tpu_torch import config, telemetry

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import telemetry_report  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_registry():
    config.unset("telemetry.sink")
    telemetry.reset()
    yield
    config.unset("telemetry.sink")
    telemetry.reset()


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _mlp_module():
    data = mt.sym.Variable("data")
    label = mt.sym.Variable("softmax_label")
    h = mt.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = mt.sym.Activation(h, act_type="relu", name="relu1")
    h = mt.sym.FullyConnected(h, num_hidden=3, name="fc2")
    mod = mt.mod.Module(mt.sym.SoftmaxOutput(h, label, name="softmax"),
                        context=mt.cpu())
    mod.bind([("data", (4, 6))], [("softmax_label", (4,))])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="adam")
    rng = np.random.RandomState(0)
    batch = mt.io.DataBatch(
        [mt.nd.array(rng.randn(4, 6).astype(np.float32), ctx=mt.cpu())],
        [mt.nd.array((rng.rand(4) * 3).astype(np.float32), ctx=mt.cpu())])
    return mod, batch


# ------------------------------------------------------------- registry
def test_registry_instruments_and_dispatch_superset():
    c = telemetry.counter("t.concurrent")
    threads = [threading.Thread(target=lambda: [c.inc() for _ in range(500)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 2000
    telemetry.gauge("q.depth").set(3)
    snap = telemetry.snapshot()
    assert snap["gauges"]["q.depth"] == 3
    # the four dispatch counters are always present, as in the reference
    for name in rtel.DISPATCH_COUNTERS:
        assert snap["counters"][name] == 0
    assert set(telemetry.__all__) >= set(rtel.__all__)
    mt.profiler.counter_increment("fused_steps", 2)
    assert mt.profiler.counters()["fused_steps"] == 2
    mt.profiler.reset_counters()
    assert mt.profiler.counters()["fused_steps"] == 0


def test_timer_windowed_quantiles_match_reference():
    """The two-epoch window: the same observations at the same clock
    give the reference's stats, and a warm-up burst ages out of the
    windowed quantiles within a minute."""
    port, ref = telemetry.Timer("w"), rtel.Timer("w")
    base = port._win_start
    ref._win_start = base
    plan = [(0.5, base + 1.0)] * 5 + [(0.01, base + 35.0)] * 20 \
        + [(0.02, base + 70.0)] * 10
    for v, now in plan:
        port.observe(v, now=now)
        ref.observe(v, now=now)
    s = port.stats(now=base + 70.0)
    assert s == ref.stats(now=base + 70.0)
    for at in (base + 100.0, base + 200.0):
        assert port.stats(now=at) == ref.stats(now=at)
    # the burst has aged out of the window, not out of the reservoir
    assert s["count_1m"] == 30 and s["p99_1m"] == 0.02
    assert s["p50_1m"] == 0.01 and s["p99"] == 0.5


# -------------------------------------------------------------- the sink
def test_step_records_of_the_three_loops_validate_in_both(tmp_path):
    """Module (fused and eager), SPMDTrainer and gluon.Trainer step
    records pass both packages' validators; paths, compiles and the mesh
    are the reference's."""
    log = tmp_path / "steps.jsonl"
    config.set("telemetry.sink", "jsonl:%s" % log)
    assert telemetry.enabled() and telemetry.sink_path() == str(log)
    mod, batch = _mlp_module()
    for _ in range(2):
        mod.train_step(batch)
    config.set("module.fused_step", "off")
    try:
        mod.train_step(batch)
    finally:
        config.unset("module.fused_step")
    with mt.cpu():
        from mxnet_tpu_torch.gluon import nn
        from mxnet_tpu_torch.gluon.loss import L2Loss
        from mxnet_tpu_torch.parallel.trainer import SPMDTrainer
        net = nn.Dense(1, in_units=3)
        net.initialize(mt.init.Xavier())
        tr = SPMDTrainer(net, L2Loss(), "sgd", {"learning_rate": 0.1})
        x = np.ones((8, 3), np.float32)
        tr.step(x, np.zeros((8, 1), np.float32), pad=2)
        gnet = nn.Dense(1, in_units=3)
        gnet.initialize(mt.init.Xavier())
        gtr = mt.gluon.Trainer(gnet.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        with mt.autograd.record():
            loss = gnet(mt.nd.array(x)).sum()
        loss.backward()
        gtr.step(8)
    telemetry.flush()
    steps = [r for r in _records(log) if r["event"] == "step"]
    for rec in steps:
        telemetry.validate_step_record(rec)
        rtel.validate_step_record(rec)
    assert [(r["source"], r["step"], r["path"]) for r in steps] == [
        ("module", 1, "fused"), ("module", 2, "fused"),
        ("module", 3, "eager"), ("spmd", 1, "fused"), ("gluon", 1, "eager")]
    assert [r["compiles"] for r in steps[:2]] == [1, 0]
    assert steps[0]["samples"] == 4 and steps[0]["shape"] == [4, 6]
    assert steps[3]["mesh"] == {"dp": 1} and steps[3]["samples"] == 6
    assert steps[3]["host_syncs"] == 2
    assert steps[4]["samples"] == 8
    # the CPU has no device watermark: null, as the schema allows
    assert all(r["mem_bytes"] is None for r in steps)


def test_reference_records_validate_in_the_port_and_report_reads_port(
        tmp_path):
    """The reference's own step records pass the port's validator, and
    the reference's tools/telemetry_report.py summarizes the port's JSONL
    without a flag."""
    rlog = tmp_path / "ref.jsonl"
    rtel.configure_sink("jsonl:%s" % rlog)
    try:
        with rtel.step_scope("spmd", samples=16, shape=(16, 3),
                             mesh={"data": 8}, default_path="fused"):
            pass
        with pytest.raises(RuntimeError):
            with rtel.step_scope("module", samples=4):
                raise RuntimeError("boom")
    finally:
        rtel.configure_sink("")
    for rec in _records(rlog):
        telemetry.validate_step_record(rec)
    log = tmp_path / "port.jsonl"
    config.set("telemetry.sink", "jsonl:%s" % log)
    mod, batch = _mlp_module()
    for _ in range(4):
        mod.train_step(batch)
    config.unset("telemetry.sink")
    recs, bad = telemetry_report.load_records(str(log))
    assert bad == 0
    summary = telemetry_report.summarize(recs)
    table = summary["sources"]["module"]
    assert table["steps"] == 4 and table["paths"] == {"fused": 4}
    assert table["compiles"] == 1 and summary["other_events"] == 0
    assert "module" in telemetry_report.render(summary)


def test_failing_step_emits_record_with_error(tmp_path):
    log = tmp_path / "exc.jsonl"
    config.set("telemetry.sink", "jsonl:%s" % log)
    with pytest.raises(RuntimeError):
        with telemetry.step_scope("module", samples=4):
            raise RuntimeError("boom")
    config.unset("telemetry.sink")
    (rec,) = _records(log)
    rtel.validate_step_record(rec)
    assert rec["error"] == "RuntimeError: boom"
    assert telemetry.counter("module.step_errors").value == 1


def test_sink_off_builds_no_record(monkeypatch):
    """Off means off: no counter snapshot, no memory query, no json —
    the scope only feeds the timer and the step counter."""
    def boom():
        raise AssertionError("memory queried with the sink off")
    monkeypatch.setattr(telemetry, "device_memory_bytes", boom)
    monkeypatch.setattr(telemetry.json, "dumps", boom)
    with telemetry.step_scope("spmd", samples=16):
        pass
    assert telemetry.counter("spmd.steps").value == 1
    assert telemetry.timer("spmd.step").stats()["count"] == 1


def test_validate_step_record_rejects_what_the_reference_rejects():
    good = {"event": "step", "ts": 1.0, "source": "module", "step": 1,
            "path": "fused", "wall_ms": 1.0, "compiles": 0,
            "host_syncs": 0}
    telemetry.validate_step_record(dict(good))
    for broken in ({k: v for k, v in good.items() if k != "wall_ms"},
                   dict(good, step=0), dict(good, event="monitor"),
                   dict(good, compiles=True), dict(good, shape="8x6")):
        for lib in (telemetry, rtel):
            with pytest.raises(ValueError):
                lib.validate_step_record(broken)


def test_log_event_and_sink_knob_from_bare_path(tmp_path):
    log = tmp_path / "bare.jsonl"
    config.set("telemetry.sink", str(log))
    telemetry.log_event("custom", value=3)
    config.unset("telemetry.sink")
    assert not telemetry.enabled()
    (rec,) = _records(log)
    assert rec["event"] == "custom" and rec["value"] == 3
    with pytest.raises(ValueError):
        telemetry.configure_sink("jsonl:")
