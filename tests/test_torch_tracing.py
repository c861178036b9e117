"""The port's causal spans, Chrome sink, flight recorder and hang watchdog
(mxnet_tpu_torch.tracing) and its trace_merge, held against the
reference's formats: each package's traces and watchdog reports load and
validate in the other's readers, the Module step's span tree is the
reference's, and the prefetch workers carry the parent's trace."""
import glob
import gzip
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu import tracing as rtr
from mxnet_tpu_torch import config, telemetry, trace_merge, tracing


@pytest.fixture(autouse=True)
def _tracing_off():
    config.unset("tracing.sink")
    config.unset("tracing.watchdog")
    telemetry.reset()
    yield
    config.unset("tracing.sink")
    config.unset("tracing.watchdog")
    config.unset("tracing.watchdog_dir")
    for name in list(tracing._STALL_PROBES):
        tracing.unregister_stall_probe(name)
    telemetry.reset()


def _events(path):
    return tracing.validate_trace_events(tracing.load_trace(str(path)))


def _reports(d):
    return sorted(glob.glob(os.path.join(str(d), "watchdog_report_*.json")))


# ---------------------------------------------------------------- spans
def test_span_noop_when_off_and_nesting_in_chrome_trace(tmp_path):
    s = tracing.span("anything")
    assert s is tracing._NOOP and tracing.span("again") is s
    trace = tmp_path / "t.trace.json"
    config.set("tracing.sink", "chrome:%s" % trace)
    with tracing.span("root", cat="test") as root:
        with tracing.span("child", cat="test", extra=7) as child:
            assert tracing.current_span() is child
            assert child.parent_id == root.span_id
    with pytest.raises(ValueError):
        with tracing.span("failing"):
            raise ValueError("bad shard")
    config.unset("tracing.sink")
    by_name = {e["name"]: e for e in _events(trace)}
    assert by_name["child"]["args"]["parent_id"] == \
        by_name["root"]["args"]["span_id"]
    assert by_name["child"]["args"]["extra"] == 7
    assert by_name["failing"]["args"]["error"] == "ValueError: bad shard"


def test_chrome_traces_cross_validate(tmp_path):
    """The port's trace — whole, and cut mid-line as a killed job leaves
    it — loads and validates in the reference's readers, and the
    reference's in the port's."""
    port = tmp_path / "port.trace.json"
    config.set("tracing.sink", "chrome:%s" % port)
    with tracing.span("step"):
        with tracing.span("fwd"):
            pass
    tracing.flush()
    text = port.read_text()
    config.unset("tracing.sink")
    for path in (port, ):
        names = {e["name"] for e in rtr.validate_trace_events(
            rtr.load_trace(str(path)))}
        assert names == {"step", "fwd"}
    cut = tmp_path / "cut.trace.json"
    cut.write_text(text + '{"name": "half", "ph": "X", "ts": 1')
    for lib in (tracing, rtr):
        assert {e["name"] for e in lib.validate_trace_events(
            lib.load_trace(str(cut)))} == {"step", "fwd"}
    ref = tmp_path / "ref.trace.json"
    rtr.configure_sink("chrome:%s" % ref)
    try:
        with rtr.span("ref.step"):
            with rtr.span("ref.fwd"):
                pass
    finally:
        rtr.configure_sink("")
    assert {e["name"] for e in _events(ref)} == {"ref.step", "ref.fwd"}


def test_module_step_emits_the_reference_causal_tree(tmp_path):
    """tests/test_tracing.py:109-138 on the port: two module.step roots,
    each the parent of a module.fused_dispatch in its trace."""
    trace = tmp_path / "mod.trace.json"
    config.set("tracing.sink", "chrome:%s" % trace)
    data = mt.sym.Variable("data")
    label = mt.sym.Variable("softmax_label")
    h = mt.sym.FullyConnected(data, num_hidden=8, name="fc0")
    mod = mt.mod.Module(mt.sym.SoftmaxOutput(h, label, name="softmax"),
                        context=mt.cpu())
    mod.bind([("data", (4, 6))], [("softmax_label", (4,))])
    mod.init_params()
    mod.init_optimizer()
    rng = np.random.RandomState(0)
    batch = mt.io.DataBatch(
        [mt.nd.array(rng.randn(4, 6).astype(np.float32), ctx=mt.cpu())],
        [mt.nd.array((rng.rand(4) * 3).astype(np.float32), ctx=mt.cpu())])
    for _ in range(2):
        mod.train_step(batch)
    config.set("module.fused_step", "off")
    try:
        mod.train_step(batch)
    finally:
        config.unset("module.fused_step")
    config.unset("tracing.sink")
    xs = _events(trace)
    steps = {e["args"]["span_id"]: e for e in xs
             if e["name"] == "module.step"}
    assert len(steps) == 3
    tree = {}
    for e in xs:
        parent = steps.get(e["args"]["parent_id"])
        if parent is not None:
            assert e["args"]["trace_id"] == parent["args"]["trace_id"]
            tree.setdefault(parent["args"]["span_id"], []).append(e["name"])
    kids = [sorted(tree[i]) for i in sorted(tree)]
    assert kids[:2] == [["module.fused_dispatch"]] * 2
    assert kids[2] == ["executor.backward", "executor.forward",
                       "module.opt_update"]


@pytest.mark.parametrize("kind", ["PrefetchingIter", "DevicePrefetcher"])
def test_prefetch_worker_span_carries_parent_trace(tmp_path, kind):
    trace = tmp_path / "pf.trace.json"
    config.set("tracing.sink", "chrome:%s" % trace)
    base = mt.io.NDArrayIter(data=np.zeros((8, 2), np.float32),
                             label=np.zeros((8,), np.float32), batch_size=4)
    with mt.cpu(), tracing.span("epoch") as epoch:
        pf = getattr(mt.io, kind)(base)
        assert len(list(pf)) == 2
    config.unset("tracing.sink")
    xs = _events(trace)
    prefetch = [e for e in xs if e["name"] == "io.prefetch"]
    epoch_ev = next(e for e in xs if e["name"] == "epoch")
    assert prefetch
    for e in prefetch:
        assert e["args"]["trace_id"] == epoch.trace_id
        assert e["args"]["parent_id"] == epoch.span_id
        assert e["tid"] != epoch_ev["tid"]


def test_wrap_context_plain_thread():
    config.set("tracing.watchdog", 30)   # armed: span() is live
    seen = {}

    def worker():
        with tracing.span("inner") as s:
            seen.update(trace_id=s.trace_id, parent_id=s.parent_id)
    with tracing.span("outer") as outer:
        t = threading.Thread(target=tracing.wrap_context(worker))
        t.start()
        t.join()
    config.unset("tracing.watchdog")
    assert seen == {"trace_id": outer.trace_id, "parent_id": outer.span_id}


# -------------------------------------------------------------- watchdog
def test_watchdog_report_cross_validates_and_backs_off(tmp_path):
    """A stall under a 0.1 s deadline writes a report (its open spans,
    the ring with the last step) that both packages validate; a stall of
    under 0.3 s after it fires writes exactly one (the backoff)."""
    config.set("tracing.watchdog_dir", str(tmp_path))
    config.set("tracing.watchdog", 0.1)
    with telemetry.step_scope("module", samples=4):
        pass
    with tracing.span("stuck.allreduce", cat="collective"):
        deadline = time.perf_counter() + 0.45
        while not _reports(tmp_path) and time.perf_counter() < deadline:
            time.sleep(0.01)
        time.sleep(0.15)
    config.unset("tracing.watchdog")
    reports = _reports(tmp_path)
    assert len(reports) == 1, reports
    with open(reports[0]) as f:
        rep = json.load(f)
    tracing.validate_watchdog_report(rep)
    rtr.validate_watchdog_report(rep)
    assert [s["name"] for s in rep["open_spans"]] == ["stuck.allreduce"]
    assert any(r["kind"] == "step" and r["name"] == "module.step"
               for r in rep["ring"])
    assert telemetry.counter("tracing.watchdog_fires").value == 1
    # the reference's report validates in the port
    ref = rtr.dump_watchdog_report(path=str(tmp_path / "ref.json"))
    with open(ref) as f:
        tracing.validate_watchdog_report(json.load(f))


def test_watchdog_fires_inside_a_stalled_prefetch(tmp_path):
    """A data iterator that sleeps twice the deadline inside io.prefetch
    yields exactly one report, whose open spans include io.prefetch."""
    config.set("tracing.watchdog_dir", str(tmp_path))

    class Slow(mt.io.NDArrayIter):
        slept = False

        def next(self):
            if not self.slept:
                self.slept = True
                time.sleep(0.4)
            return super().next()
    config.set("tracing.watchdog", 0.2)
    with mt.cpu():
        batches = list(mt.io.PrefetchingIter(Slow(
            data=np.zeros((4, 2), np.float32),
            label=np.zeros((4,), np.float32), batch_size=4)))
    config.unset("tracing.watchdog")
    assert len(batches) == 1
    reports = _reports(tmp_path)
    assert len(reports) == 1, reports
    with open(reports[0]) as f:
        rep = tracing.validate_watchdog_report(json.load(f))
    assert "io.prefetch" in [s["name"] for s in rep["open_spans"]]


def test_ring_resize_and_stall_probes():
    config.set("tracing.ring_size", 3)
    try:
        for i in range(5):
            tracing.record_event("test", "e%d" % i)
        assert [e["name"] for e in tracing.ring_events()] == \
            ["e2", "e3", "e4"]
    finally:
        config.unset("tracing.ring_size")
    tracing.register_stall_probe("queue", lambda s: {"pending": 3})
    tracing.register_stall_probe("healthy", lambda s: None)
    tracing.register_stall_probe("broken", lambda s: 1 / 0)
    assert tracing.check_stall_probes(1.0) == {"queue": {"pending": 3}}
    tracing.unregister_stall_probe("queue")
    assert tracing.check_stall_probes(1.0) == {}
    tracing.notify_step("module", 1, 0.01)
    assert tracing.last_step_age_s() < 5.0


# ---------------------------------------------------------------- merge
def test_trace_merge_span_trace_with_a_torch_profiler_export(tmp_path):
    """The port's span trace beside a torch.profiler CPU export: the span
    plane is kept, the export's host lanes dropped (a CPU export has no
    GPU lane); Kineto's GPU stream lanes are kept as device planes."""
    trace = tmp_path / "spans.trace.json"
    config.set("tracing.sink", "chrome:%s" % trace)
    mt.profiler.start()
    with tracing.span("spmd.step", cat="spmd"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    mt.profiler.stop()
    config.unset("tracing.sink")
    export = tmp_path / "profile.json"
    mt.profiler.set_config(filename=str(export))
    try:
        assert mt.profiler.dump() == str(export)
    finally:
        mt.profiler.set_config(filename=None)
    # the span entered record_function inside the session
    assert "spmd.step" in {e.get("name") for e in
                           trace_merge.load_chrome_trace(str(export))}
    out = tmp_path / "merged.json"
    stats = trace_merge.merge_files(str(trace), str(export), str(out))
    assert stats["host_events"] == 1 and stats["device_events"] == 0
    merged = json.load(open(out))["traceEvents"]
    assert [e["name"] for e in merged if e.get("ph") == "X"] == ["spmd.step"]
    # a Kineto-shaped export with a GPU lane, gzipped
    kineto = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 4242,
         "args": {"name": "python3"}},
        {"ph": "X", "name": "aten::mm", "cat": "cpu_op", "pid": 4242,
         "tid": 1, "ts": 100.0, "dur": 5.0},
        {"ph": "M", "name": "process_labels", "pid": 0,
         "args": {"labels": "GPU 0"}},
        {"ph": "X", "name": "sgd_step_kernel", "cat": "kernel", "pid": 0,
         "tid": 7, "ts": 103.0, "dur": 2.0}]}
    gz = tmp_path / "kineto.json.gz"
    with gzip.open(str(gz), "wt") as f:
        json.dump(kineto, f)
    merged, stats = trace_merge.merge_traces(
        trace_merge.load_chrome_trace(str(trace)),
        trace_merge.load_chrome_trace(str(gz)))
    assert stats["device_events"] == 1 and stats["device_planes"] == 1
    dev = [e for e in merged if e.get("pid") == trace_merge.DEVICE_PID_BASE
           and e.get("ph") == "X"]
    assert [e["name"] for e in dev] == ["sgd_step_kernel"]
    assert dev[0]["ts"] == 0.0
    assert trace_merge.resolve_device_trace(str(tmp_path)) in (
        str(gz), str(export), str(out))
