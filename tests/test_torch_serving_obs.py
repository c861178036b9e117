"""The serving and generation seams of ``mx.obs``/``mx.tracing``/
``mx.perf`` on the CPU: the ``serving.*`` spans, one access record per
request at each terminal outcome (ok, shed, deadline, breaker) joined to
the Chrome trace, the registered cost of each warmed bucket, the engine's
stall probe and ``/healthz``'s stalled reason, the int8 stats twin
(site amaxes those of the float forward's site inputs) and the drift
EWMAs against the reference's ``numerics.update_quant_drift``."""
import json
import time

import numpy as np
import pytest
import torch

import mxnet_tpu.config as rconfig
import mxnet_tpu.numerics as rnum

import mxnet_tpu_torch as mt
import mxnet_tpu_torch.name  # noqa: F401
from mxnet_tpu_torch import (config, deploy, numerics, obs, perf,
                             quantization, serving, telemetry, tracing)

FEAT, HIDDEN, OUT = 6, 16, 4


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset()
    perf.reset()
    yield
    for k in ("obs.access_log", "tracing.sink", "tracing.watchdog",
              "tracing.watchdog_dir", "quant.drift_every"):
        config.unset(k)
    config.set("resilience.faults", "")
    telemetry.reset()


def _reqs(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, size=(s, FEAT)).astype(np.float32)
            for s in sizes]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """An f32 MLP and its int8 export (with the stats twin), made by the
    port."""
    d = tmp_path_factory.mktemp("serving_obs")
    calib = _reqs((8, 8), seed=5)
    with mt.cpu(), mt.name.NameManager():
        mt.random.seed(3)
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Dense(HIDDEN, activation="relu", in_units=FEAT),
                mt.gluon.nn.Dense(OUT, in_units=HIDDEN))
        net.initialize()
        net(mt.nd.array(calib[0]))
        deploy.export_model(net, str(d / "f32"), calib[0])
        cal = quantization.calibrate(net, calib)
        quantization.export_quantized(net, str(d / "q8"), cal)
    return {"f32": str(d / "f32"), "q8": str(d / "q8"), "calib": calib}


def _records(path):
    obs.flush_access_log()
    return [json.loads(line) for line in open(path) if line.strip()]


def _hold(srv, x):
    """One request held inside its dispatch by the serving_slow fault."""
    c0 = telemetry.counter("resilience.injected.serving_slow").value
    fut = srv.submit("m", x)
    deadline = time.perf_counter() + 10.0
    while telemetry.counter("resilience.injected.serving_slow").value <= c0:
        assert time.perf_counter() < deadline
        time.sleep(0.001)
    return fut


def test_spans_access_records_and_cost(artifacts, tmp_path):
    trace = tmp_path / "trace.json"
    access = tmp_path / "access.jsonl"
    config.set("tracing.sink", "chrome:%s" % trace)
    config.set("obs.access_log", "jsonl:%s" % access)
    srv = serving.Server(max_batch=4, max_queue_delay_ms=0.0, max_pending=1,
                         breaker_threshold=1, breaker_cooldown_ms=60000.0,
                         device="cpu")
    srv.register("m", artifacts["f32"])
    srv.start()
    try:
        x = _reqs((1,))[0]
        ok = srv.predict("m", x, timeout=10)
        assert ok.shape == (1, OUT)
        # shed and deadline behind a held dispatch
        config.set("resilience.faults", "serving_slow:1@step=1")
        held = _hold(srv, x)
        late = srv.submit("m", x, deadline_ms=10.0)
        with pytest.raises(serving.ServerOverloadedError):
            srv.submit("m", x)
        held.result(timeout=10)
        with pytest.raises(serving.DeadlineExceededError):
            late.result(timeout=10)
        # the breaker: one failed dispatch opens it
        config.set("resilience.faults", "serving_dispatch:1@step=1")
        assert srv.submit("m", x).exception(timeout=10) is not None
        with pytest.raises(serving.CircuitOpenError):
            srv.submit("m", x)
    finally:
        srv.stop()
        config.set("resilience.faults", "")
    recs = _records(access)
    for r in recs:
        obs.validate_access_record(r)
    outcomes = sorted(r["outcome"] for r in recs)
    assert outcomes == ["breaker", "deadline", "error", "ok", "ok", "shed"]
    okrec = [r for r in recs if r["outcome"] == "ok"]
    per_row = srv._models["m"].cost_per_item["flops"]
    assert per_row == 2 * FEAT * HIDDEN + 2 * HIDDEN * OUT
    assert all(r["flops"] == int(per_row) for r in okrec)
    tracing.flush()
    events = tracing.load_trace(str(trace))
    names = {e.get("name") for e in events}
    assert {"serving.compile", "serving.submit",
            "serving.dispatch"} <= names
    ids = {str(e["args"]["trace_id"]) for e in events
           if e.get("name") == "serving.submit"}
    assert all(r["request_id"] in ids for r in recs)
    progs = {p["key"] for p in perf.programs("serving")}
    assert {"m/b1", "m/b2", "m/b4"} <= progs
    g = telemetry.snapshot()["gauges"]
    assert g["serving.flops_per_request.m"] == per_row


def _lm(tmp_path):
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    torch.manual_seed(0)
    model = TransformerLM(TransformerLMConfig(
        vocab_size=32, num_layers=1, d_model=16, num_heads=2, d_ff=32,
        max_len=32, dtype=torch.float32), device="cpu")
    prefix = str(tmp_path / "lm")
    deploy.export_generation(model, None, prefix, page_size=8,
                             max_context=32)
    return prefix


def test_generation_probe_health_and_records(tmp_path):
    """The engine's stall probe while its loop is held, the server's
    health turning stalled under the watchdog knob and back, ok access
    records with the programs' FLOPs, one perf record per prefill bucket
    and decode width used."""
    access = tmp_path / "access.jsonl"
    config.set("obs.access_log", "jsonl:%s" % access)
    config.set("tracing.watchdog_dir", str(tmp_path))
    srv = serving.Server(device="cpu")
    eng = srv.register("lm", _lm(tmp_path), generate=True)
    srv.start()
    try:
        want = srv.generate("lm", [1, 2, 3], 4, timeout=30)
        assert eng._stall_probe(0.0) is None    # nothing waits
        config.set("tracing.watchdog", 0.2)
        with eng._held():
            fut = srv.submit_generate("lm", [1, 2, 3], 4)
            time.sleep(0.3)
            snap = eng._stall_probe(0.2)
            health = srv._health()
        assert snap["queued"] == 1 and snap["since_last_iteration_s"] >= 0.2
        assert snap["engine_alive"] and snap["model"] == "lm"
        assert "engine_stalled:lm" in health["reasons"]
        assert not health["healthy"]
        np.testing.assert_array_equal(fut.result(timeout=30), want)
        config.unset("tracing.watchdog")
        assert srv._health()["healthy"]
    finally:
        srv.stop()
    recs = _records(access)
    assert [r["outcome"] for r in recs] == ["ok", "ok"]
    assert all(r["tokens"] == 4 and r["flops"] > 0 for r in recs)
    progs = {p["key"]: p for p in perf.programs("serving")}
    assert set(progs) == {"lm/prefill-s%d" % s for s in eng._prefill} | {
        "lm/decode-w%d" % w for w in eng._decode}
    assert all(p["flops"] > 0 for p in progs.values())
    # the analytic counts (vocab 32, 1 layer, d_model 16, 2 heads, d_ff
    # 32): 2 x matmul parameters a token, the LM head, and attention; a
    # decode step charges the paged kernel at its launch geometry (every
    # slot of the page table), reading no length from the device
    D, F, V, hd, H = 16, 32, 32, 8, 2
    per_token = 2 * (4 * D * D + 2 * D * F)
    for s in eng._prefill:
        assert progs["lm/prefill-s%d" % s]["flops"] == (
            per_token * s + 2 * D * V + 4 * hd * H * s * (s + 1) // 2)
    b, psz = eng.decode_slots, eng.predictor.page_size
    for w in eng._decode:
        assert progs["lm/decode-w%d" % w]["flops"] == b * (
            per_token + 2 * D * V + 4 * hd * H * w * psz)


def test_drift_ewmas_equal_the_reference():
    sites = ["FullyConnected_0", "FullyConnected_1", "Convolution_2"]
    thresholds = {"FullyConnected_0": 2.0, "FullyConnected_1": 0.5,
                  "Convolution_2": 0.0}
    rng = np.random.RandomState(4)
    ewma, rewma = {}, {}
    config.set("quant.drift_threshold", 1.3)
    rconfig.set("quant.drift_threshold", 1.3)
    try:
        for _ in range(6):
            amax = rng.uniform(0.2, 3.0, len(sites)).astype(np.float32)
            got = numerics.update_quant_drift("m", sites, amax, thresholds,
                                              ewma)
            want = rnum.update_quant_drift("m", sites, amax, thresholds,
                                           rewma)
            assert got == want and ewma == rewma
    finally:
        config.unset("quant.drift_threshold")
        rconfig.unset("quant.drift_threshold")
    g = telemetry.snapshot()["gauges"]
    assert g["quant.drift_ratio.m.FullyConnected_0"] == round(
        ewma["FullyConnected_0"], 6)
    assert "quant.drift_ratio.m.Convolution_2" not in g


def test_stats_twin_is_the_float_forward_and_serves_drift(artifacts):
    """The twin's amaxes equal each int8 site's input |max| in the float
    forward of the artifact (its graph with the dequantized weights,
    recorded by overrides at the sites), and a Server at drift_every=2
    samples every second quantized dispatch into the drift gauges."""
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.symbol.symbol import _eval_symbol
    pred = deploy.load_model(artifacts["q8"], quantized=True, device="cpu")
    assert pred.meta["stats_sites"] == ["FullyConnected_0",
                                        "FullyConnected_1"]
    sites, fn = quantization.stats_twin(artifacts["q8"], pred._graph,
                                        pred.meta)
    x = torch.from_numpy(artifacts["calib"][1])
    env = dict(pred._params)
    env[pred._input] = x
    twin = fn(env)
    seen = {}

    def recorder(name, op):
        f = registry.get(op).fn

        def call(data, *args, **attrs):
            seen[name] = float(data.abs().amax())
            return f(data, *args, **attrs)
        return call
    overrides = {id(node): recorder(name, node.op) for name, node in
                 quantization._twin_sites(pred._graph, pred.meta)}
    _eval_symbol(pred._graph, dict(env), False, overrides=overrides)
    assert [float(a) for a in twin] == [seen[s] for s in sites]
    assert float(twin[0]) == float(x.abs().amax())
    config.set("quant.drift_every", 2)
    srv = serving.Server(max_batch=8, max_queue_delay_ms=0.0, device="cpu")
    srv.register("q", artifacts["q8"], quantized=True)
    srv.start()
    try:
        for r in _reqs((3, 5, 2, 4), seed=7):
            srv.predict("q", r, timeout=10)
    finally:
        srv.stop()
    c = telemetry.snapshot()
    assert c["counters"]["serving.drift_samples"] == 2
    for s in sites:
        assert "quant.drift_ratio.q.%s" % s in c["gauges"]
