"""``mx.obs`` against the reference's: one telemetry snapshot rendered as
Prometheus text byte for byte alike, the access-record validator and the
SLO tracker's burn rates and alerts over the same scripted streams, the
exporter on port 0 (/metrics, /healthz with a failing source, /varz) and
the access log's writer."""
import json
import urllib.error
import urllib.request

import pytest

import mxnet_tpu.obs as robs

from mxnet_tpu_torch import config, obs, telemetry


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset()
    yield
    for k in ("obs.listen", "obs.access_log", "obs.slo"):
        config.unset(k)
    telemetry.reset()


def _snapshot():
    return {
        "counters": {"serving.requests": 12,
                     "serving.shed_requests": 3,
                     "serving.shed_requests.lm": 2,
                     "serving.shed_requests.r50": 1,
                     "serving.breaker_open.lm": 1,
                     "kernels.paged_attention": 240,
                     "weird name/with:chars": 5},
        "gauges": {"serving.pending": 4,
                   "quant.drift_ratio.r50.Convolution_3": 1.0625,
                   "serving.breaker_state.lm": 2,
                   "perf.mfu": 1.5e-8, "serving.kv_pages_in_use.lm": 17,
                   "nan_gauge": float("nan"), "inf_gauge": float("inf"),
                   "label": "text"},
        "timers": {"serving.request_ms": {
            "count": 10, "total": 123.5, "min": 1.0, "max": 40.0,
            "p50": 9.5, "p99": 39.0, "count_1m": 4, "p50_1m": 8.0,
            "p99_1m": 20.25},
            "serving.decode_step_ms": {
                "count": 3, "total": 30.0, "min": 9.0, "max": 11.0,
                "p50": 10.0, "p99": 11.0, "count_1m": 0, "p50_1m": 0.0,
                "p99_1m": 0.0}},
    }


def test_render_prometheus_equals_the_reference():
    config.unset("obs.slo")
    robs.configure_slo("")
    snap = _snapshot()
    text = obs.render_prometheus(snap)
    assert text == robs.render_prometheus(snap)
    assert "# TYPE mxnet_tpu_serving_shed_requests counter" in text
    assert 'mxnet_tpu_serving_shed_requests{model="lm"} 2' in text
    assert ('mxnet_tpu_quant_drift_ratio{model="r50",site="Convolution_3"} '
            '1.0625') in text
    assert 'mxnet_tpu_serving_request_ms{quantile="0.99"} 20.25' in text


def test_access_record_validation_equals_the_reference():
    good = {"event": "access", "ts": 1.5, "request_id": "7", "model": "m",
            "outcome": "ok", "queue_ms": 0.5, "dispatch_ms": 3.0,
            "ttft_ms": None, "tokens": 4, "bytes": 16}
    cases = [good, dict(good, outcome="shed"), dict(good, outcome="lost"),
             dict(good, tokens=-1), dict(good, tokens=True),
             {k: v for k, v in good.items() if k != "model"},
             dict(good, event="step"), dict(good, request_id=7),
             dict(good, error="ValueError: x", outcome="error"), "nope"]
    for rec in cases:
        outcomes = []
        for validate in (obs.validate_access_record,
                         robs.validate_access_record):
            try:
                validate(rec)
                outcomes.append("ok")
            except ValueError as exc:
                outcomes.append(str(exc))
        assert outcomes[0] == outcomes[1], rec
    assert obs.OUTCOMES == robs.OUTCOMES
    # the port's flops field
    obs.validate_access_record(dict(good, flops=123))
    with pytest.raises(ValueError):
        obs.validate_access_record(dict(good, flops=-1))


def test_slo_tracker_burn_rates_equal_the_reference():
    """The same (time, total, errors) stream into both trackers: equal
    burn rates over the 5m/30m/1h/6h windows and the same alerts."""
    port = obs.SLOTracker(availability=99.0)
    refr = robs.SLOTracker(availability=99.0)
    total = errors = 0
    t = 1000.0
    for i in range(400):
        total += 50
        errors += 10 if 150 <= i < 260 else 0
        t += 30.0
        for tr in (port, refr):
            tr.observe(total, errors, now=t)
        if i % 37 == 0 or i == 399:
            assert port.burn_rates() == refr.burn_rates()
            assert port.alerts() == refr.alerts()
    assert port.status(now=t)["burn_rates"] == refr.status(now=t)[
        "burn_rates"]
    assert port.error_budget == pytest.approx(0.01)
    for bad in ({"availability": 100.0}, {"latency_p99_ms": 0}):
        with pytest.raises(ValueError):
            obs.SLOTracker(**bad)
    with pytest.raises(ValueError):
        config.set("obs.slo", "availability=abc")
    assert config.get("obs.slo") == ""


def _get(addr, path):
    url = "http://%s:%d%s" % (addr[0], addr[1], path)
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_exporter_on_port_zero():
    config.set("obs.listen", "127.0.0.1:0")
    config.set("obs.slo", "availability=99.9,latency_p99_ms=50")
    addr = obs.exporter_address()
    assert addr is not None and addr[1] > 0
    telemetry.counter("serving.requests").inc(3)
    code, text = _get(addr, "/metrics")
    assert code == 200 and "mxnet_tpu_serving_requests 3" in text
    assert 'mxnet_tpu_slo_burn_rate{window="5m"} 0' in text
    assert _get(addr, "/healthz")[0] == 200
    obs.register_health_source("bad", lambda: {"healthy": False,
                                               "reasons": ["x"]})
    try:
        code, body = _get(addr, "/healthz")
        assert code == 503
        assert json.loads(body)["sources"]["bad"]["reasons"] == ["x"]
    finally:
        obs.unregister_health_source("bad")
    assert _get(addr, "/healthz")[0] == 200
    code, body = _get(addr, "/varz")
    varz = json.loads(body)
    assert varz["obs.listen"]["source"] == "override"
    assert varz["perf.autotune"] == {"value": "auto", "source": "default",
                                     "env": "MXNET_TPU_AUTOTUNE"}
    assert _get(addr, "/nope")[0] == 404
    config.unset("obs.listen")
    assert obs.exporter_address() is None
    with pytest.raises(ValueError):
        config.set("obs.listen", "no-port")
    assert config.get("obs.listen") == ""


def test_access_log_writer(tmp_path):
    path = tmp_path / "access.jsonl"
    assert not obs.access_log_enabled()
    obs.log_access("m", "ok")    # off: nothing queued
    config.set("obs.access_log", "jsonl:%s" % path)
    assert obs.access_log_enabled() and obs.access_log_path() == str(path)
    obs.log_access("m", "ok", request_id="12", queue_ms=1.25,
                   dispatch_ms=2.5, bytes=64, flops=1000)
    obs.log_access("m", "error", request_id=None,
                   error='RuntimeError: "quoted"')
    obs.flush_access_log()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["outcome"] for r in recs] == ["ok", "error"]
    for r in recs:
        obs.validate_access_record(r)
        robs.validate_access_record(r)
    assert recs[0]["flops"] == 1000 and recs[0]["request_id"] == "12"
    assert recs[1]["error"] == 'RuntimeError: "quoted"'
    config.unset("obs.access_log")
    assert not obs.access_log_enabled()
