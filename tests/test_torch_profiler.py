"""mx.profiler over torch.profiler (mxnet_tpu_torch.profiler): the
reference's API and sections on a CPU session, the Chrome export, the
empty-session report, and the profiler.autostart knob.  The DEVICE
section's kernels need the card (chip_smoke.py --phase observe)."""
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu import profiler as rprof
from mxnet_tpu_torch import profiler, telemetry


@pytest.fixture(autouse=True)
def _clean():
    profiler.stop()
    profiler.dumps(reset=True)
    yield
    profiler.stop()
    profiler.set_config(filename=None)
    profiler.dumps(reset=True)


def test_scoped_events_sections_and_export(tmp_path):
    assert set(rprof.__all__) <= set(profiler.__all__)
    profiler.set_config(filename=str(tmp_path / "prof.json"))
    profiler.start()
    dom = profiler.Domain("testdom")
    with dom.new_task("work"):
        x = mt.nd.array(np.ones((64, 64), np.float32), ctx=mt.cpu())
        mt.nd.dot(x, x).wait_to_read()
    with profiler.scope("outer"):
        (x * 2).wait_to_read()
    telemetry.timer("unit.step").observe(0.002)
    profiler.stop()
    table = profiler.dumps()
    for section in ("testdom::work", "outer", "Host events",
                    "Telemetry timers", "unit.step", "Gauges"):
        assert section in table
    # a CPU session asks for no CUDA activity: no device section, and not
    # an empty session either
    assert "Device ops" not in table and not profiler.empty_session()
    assert profiler.device_op_events() == {}
    path = profiler.dump()
    assert path == str(tmp_path / "prof.json")
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    # the scopes entered record_function inside the session
    assert {"testdom::work", "outer"} <= names
    assert any(n and n.startswith("aten::") for n in names)


def test_dump_without_session_writes_host_events(tmp_path):
    profiler.set_config(filename=str(tmp_path / "host.json"))
    with profiler.Frame(profiler.Domain("d"), "frame"):
        pass
    # a stopped session from an earlier test is dropped by start/stop; the
    # host-event form is written when no session ran
    profiler._STATE["last_session"] = None
    with open(profiler.dump()) as f:
        trace = json.load(f)
    assert [e["name"] for e in trace["traceEvents"]] == ["d::frame"]


def test_empty_cuda_session_is_reported_not_hidden(monkeypatch):
    """A session that asked for CUDA activity and recorded none bumps
    profiler.empty_sessions and says so in dumps()."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    profiler.start()
    profiler._STATE["cuda"] = True   # as a session on a card would be
    torch.ones(4) + 1
    profiler.stop()
    assert profiler.empty_session()
    assert telemetry.counter("profiler.empty_sessions").value == 1
    table = profiler.dumps()
    assert "not measured: the session recorded no CUDA activity" in table
    assert "profiler.empty_sessions=1" in table


def test_partial_cuda_session_is_reported(monkeypatch):
    """A session whose device side recorded fewer kernels than its host
    side launched bumps profiler.partial_sessions and says so; copies
    and the record_function ranges mirrored onto the GPU timeline are
    not kernels."""
    from torch.autograd import DeviceType

    def ev(name, dev):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(
                                   elapsed_us=lambda: 4.0))
    events = [ev("aten::mm", DeviceType.CPU), ev("spmd.step", DeviceType.CPU),
              ev("spmd.step", DeviceType.CUDA),
              ev("Memcpy HtoD (Pinned -> Device)", DeviceType.CUDA),
              ev("sgd_multi_kernel", DeviceType.CUDA)] + \
        [ev("cudaLaunchKernel", DeviceType.CPU)] * 3
    dev, launched, recorded = profiler._kernel_events(events)
    assert (launched, recorded) == (3, 1)
    assert sorted(dev) == ["Memcpy HtoD (Pinned -> Device)",
                           "sgd_multi_kernel"]

    class Session:
        def start(self):
            pass

        def stop(self):
            pass

        def events(self):
            return events
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda activities: Session())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    profiler.start()
    profiler._STATE["cuda"] = True   # as a session on a card would be
    profiler.stop()
    assert profiler.session_kernels() == (1, 3)
    assert not profiler.empty_session()
    assert telemetry.counter("profiler.partial_sessions").value == 1
    assert "recorded 1 of the 3 kernels it launched" in profiler.dumps()


def test_counter_marker_state_and_dispatch_counters():
    dom = profiler.Domain("d")
    c = dom.new_counter("cnt", 5)
    c.increment(2)
    c.decrement(1)
    assert c.value == 6
    dom.new_marker("m").mark()
    profiler.set_state("run")
    assert profiler._STATE["running"]
    profiler.pause()
    assert not profiler._STATE["running"]
    profiler.resume()
    profiler.set_state("stop")
    assert not profiler._STATE["running"]
    profiler.counter_increment("host_syncs", 2)
    assert profiler.counters()["host_syncs"] == 2
    assert "d::cnt" in profiler.dumps()


def test_autostart_knob_starts_a_session_at_import(monkeypatch):
    monkeypatch.setenv("MXNET_PROFILER_AUTOSTART", "1")
    try:
        importlib.reload(profiler)
        assert profiler._STATE["running"]
        profiler.stop()
    finally:
        monkeypatch.delenv("MXNET_PROFILER_AUTOSTART")
        importlib.reload(profiler)
    assert not profiler._STATE["running"]
