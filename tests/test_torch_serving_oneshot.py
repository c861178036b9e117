"""The port's one-shot serving on the CPU: deploy artifacts carried from
the reference (f32 v2 dynamic and fixed batch, int8 v3) held against the
reference's ``StableHLOPredictor``, the format gates, the ``Server``'s
rows bitwise against batch-1 ``predict`` under concurrent ragged traffic,
and its fault paths (shedding, deadlines, the breaker under
``serving_dispatch``, the supervised batcher, the LRU table,
``load_server``, a quantized model beside an f32 one), and the
generation engine's restart supervisor."""
import json
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu.name  # noqa: F401

import mxnet_tpu_torch as mt
import mxnet_tpu_torch.name  # noqa: F401
from mxnet_tpu_torch import (config, convert, deploy, quantization,
                             serving, telemetry)
from mxnet_tpu_torch.serving import _Request

FEAT, HIDDEN, OUT = 6, 16, 4


def _mlp(pkg):
    nn = pkg.gluon.nn
    with pkg.name.NameManager():
        net = nn.HybridSequential()
        net.add(nn.Dense(HIDDEN, activation="relu", in_units=FEAT),
                nn.Dense(OUT, in_units=HIDDEN))
    return net


def _reqs(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, size=(s, FEAT)).astype(np.float32)
            for s in sizes]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The reference's MLP exported three ways (f32 dynamic, f32 fixed
    batch, int8) and carried to the port's artifacts."""
    d = tmp_path_factory.mktemp("oneshot")
    calib = _reqs((8, 8, 8), seed=5)
    ref.random.seed(3)
    rn = _mlp(ref)
    rn.initialize()
    rn(ref.nd.array(calib[0]))
    ref.deploy.export_model(rn, str(d / "r_dyn"), calib[0])
    ref.deploy.export_model(rn, str(d / "r_fix"), calib[0],
                            dynamic_batch=False)
    rcal = ref.quantization.calibrate(rn, calib)
    ref.quantization.export_quantized(rn, str(d / "r_q8"), rcal)
    with mt.cpu():
        pn = _mlp(mt)
        pn.initialize()
        convert.gluon_params_from_reference(
            pn, {n: p.data().asnumpy()
                 for n, p in rn.collect_params().items()})
        for name in ("dyn", "fix", "q8"):
            convert.oneshot_from_reference(pn, str(d / ("r_" + name)),
                                           str(d / ("p_" + name)))
    return {"dir": d, "calib": calib, "rcal": rcal, "port_net": pn,
            **{k: str(d / ("p_" + k)) for k in ("dyn", "fix", "q8")},
            **{"r_" + k: str(d / ("r_" + k)) for k in ("dyn", "fix", "q8")}}


@pytest.fixture(autouse=True)
def _clean_knobs():
    yield
    config.set("resilience.faults", "")
    config.set("resilience.retry_attempts", 3)
    config.set("resilience.retry_base_s", 0.05)


def _server(**kw):
    kw.setdefault("device", "cpu")
    return serving.Server(**kw)


# ------------------------------------------------------ deploy artifacts

@pytest.mark.parametrize("kind", ["dyn", "fix", "q8"])
def test_carried_artifact_matches_reference_predictor(models, kind):
    """One artifact, both predictors: f32 within 1e-6 (the products sum
    in different orders), int8 bitwise (exact int32 accumulators, the
    same f32 epilogue)."""
    quant = kind == "q8"
    rpred = ref.deploy.load_model(models["r_" + kind], quantized=quant)
    pred = deploy.load_model(models[kind], quantized=quant, device="cpu")
    assert pred.meta["format_version"] == rpred.meta["format_version"]
    assert pred.dynamic_batch == rpred.dynamic_batch == (kind != "fix")
    assert pred.signature() == rpred.signature()
    sizes = (8,) if kind == "fix" else (1, 3, 8, 11)
    for x in _reqs(sizes, seed=1):
        want = rpred.predict(x)
        got = pred.predict(x)
        assert got.shape == want.shape and got.dtype == want.dtype
        if quant:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if kind == "fix":
        with pytest.raises(ValueError, match="signature"):
            pred.predict(_reqs((3,))[0])


def test_port_export_model_matches_reference(models, tmp_path):
    """The port's own ``export_model`` of the same weights: the reference's
    meta fields and outputs."""
    x = models["calib"][0]
    with mt.cpu():
        paths = deploy.export_model(models["port_net"], str(tmp_path / "m"),
                                    x)
        pred = deploy.load_model(str(tmp_path / "m"), device="cpu")
    assert [p.rsplit("-", 1)[1] for p in paths] == [
        "symbol.json", "meta.json", "params.npz"]
    rmeta = json.load(open(models["r_dyn"] + "-meta.json"))
    for k in ("param_names", "input_shape", "input_dtype", "output_shape",
              "output_dtype", "dynamic_batch", "format_version"):
        assert pred.meta[k] == rmeta[k], k
    want = ref.deploy.load_model(models["r_dyn"]).predict(x)
    np.testing.assert_allclose(pred.predict(x), want, rtol=1e-6, atol=1e-6)


def test_format_gates(models, tmp_path):
    with pytest.raises(ValueError, match="QUANTIZED"):
        deploy.load_model(models["q8"], device="cpu")
    with pytest.raises(ValueError, match="plain fp32"):
        deploy.load_model(models["dyn"], quantized=True, device="cpu")
    with pytest.raises(ValueError, match="oneshot_from_reference"):
        deploy.load_model(models["r_dyn"], device="cpu")
    meta = json.load(open(models["dyn"] + "-meta.json"))
    meta["format_version"] = 9
    prefix = str(tmp_path / "future")
    with open(prefix + "-meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="newer"):
        deploy.load_model(prefix, device="cpu")


# ---------------------------------------------------------------- serving

def test_rows_bitwise_against_batch1_predict_under_threads(models):
    """8 threads of ragged 1-4-row requests: every served row equals the
    artifact's batch-1 predict of that row, bit for bit; the warmed
    shapes stay the bucket set."""
    pred = deploy.load_model(models["dyn"], device="cpu")
    srv = _server(max_batch=16, max_queue_delay_ms=2.0)
    srv.register("m", models["dyn"])
    c0 = telemetry.counter("serving.compiles").value
    srv.start()
    assert telemetry.counter("serving.compiles").value - c0 == 5
    rng = np.random.default_rng(11)
    reqs = _reqs(rng.integers(1, 5, 96), seed=2)
    results = [None] * len(reqs)
    d0 = telemetry.counter("serving.batch_dispatches").value

    def worker(k):
        futs = [(i, srv.submit("m", reqs[i]))
                for i in range(k, len(reqs), 8)]
        for i, f in futs:
            results[i] = f.result(timeout=30)

    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        srv.stop()
    dispatches = telemetry.counter("serving.batch_dispatches").value - d0
    assert dispatches < len(reqs)          # requests were coalesced
    for x, out in zip(reqs, results):
        want = np.concatenate([pred.predict(x[i:i + 1])
                               for i in range(x.shape[0])])
        np.testing.assert_array_equal(out, want)
    assert telemetry.counter("serving.compiles").value - c0 == 5


def test_oversized_request_chunks_and_validation(models):
    pred = deploy.load_model(models["dyn"], device="cpu")
    with _server(max_batch=4, max_queue_delay_ms=0.0) as srv:
        srv.register("m", models["dyn"])
        x = _reqs((11,))[0]
        out = srv.predict("m", x, timeout=30)
        want = np.concatenate([pred.predict(x[i:i + 1]) for i in range(11)])
        np.testing.assert_array_equal(out, want)
        with pytest.raises(ValueError, match="item shape"):
            srv.submit("m", np.zeros((2, FEAT + 1), np.float32))
        with pytest.raises(ValueError, match="dtype"):
            srv.submit("m", np.zeros((2, FEAT), np.float64))
        with pytest.raises(serving.ServingError, match="unknown"):
            srv.submit("nope", x)


def _hold_batcher(srv, x):
    """Submit one request under an armed ``serving_slow`` fault and wait
    until the batcher sleeps inside its dispatch."""
    c0 = telemetry.counter("resilience.injected.serving_slow").value
    fut = srv.submit("m", x)
    deadline = time.perf_counter() + 10.0
    while telemetry.counter(
            "resilience.injected.serving_slow").value <= c0:
        assert time.perf_counter() < deadline, "slow fault never fired"
        time.sleep(0.001)
    return fut


def test_overload_sheds_and_deadline_expires_in_queue(models):
    srv = _server(max_batch=4, max_queue_delay_ms=0.0, max_pending=2)
    srv.register("m", models["dyn"])
    srv.start()
    try:
        config.set("resilience.faults", "serving_slow:1@step=1")
        x = _reqs((1,))[0]
        held = _hold_batcher(srv, x)
        s0 = telemetry.counter("serving.shed_requests").value
        e0 = telemetry.counter("serving.deadline_exceeded").value
        late = srv.submit("m", x, deadline_ms=20.0)
        ok = srv.submit("m", x)
        with pytest.raises(serving.ServerOverloadedError):
            srv.submit("m", x)
        assert isinstance(serving.ServerOverloadedError("x"), OSError)
        assert telemetry.counter("serving.shed_requests").value - s0 == 1
        assert telemetry.counter("serving.shed_requests.m").value >= 1
        assert held.result(timeout=10).shape == (1, OUT)
        with pytest.raises(serving.DeadlineExceededError):
            late.result(timeout=10)
        assert ok.result(timeout=10).shape == (1, OUT)
        assert telemetry.counter("serving.deadline_exceeded").value \
            - e0 == 1
        # predict(timeout=) cancels its queued request, undispatched
        config.set("resilience.faults", "serving_slow:1@step=1")
        held = _hold_batcher(srv, x)
        with pytest.raises(serving.DeadlineExceededError, match="1 queued"):
            srv.predict("m", x, timeout=0.01)
        held.result(timeout=10)
    finally:
        srv.stop()


def test_breaker_opens_isolates_and_half_opens(models):
    srv = _server(max_batch=4, max_queue_delay_ms=0.0, breaker_threshold=2,
                  breaker_cooldown_ms=100.0)
    srv.register("m", models["dyn"])
    srv.register("b", models["fix"])
    srv.start()
    try:
        b0 = telemetry.counter("serving.breaker_open").value
        config.set("resilience.faults", "serving_dispatch:2@step=1")
        for _ in range(2):
            fut = srv.submit("m", _reqs((1,))[0])
            assert isinstance(fut.exception(timeout=10), OSError)
        assert srv.stats()["breakers"]["m"] == "open"
        assert telemetry.counter("serving.breaker_open").value - b0 == 1
        with pytest.raises(serving.CircuitOpenError):
            srv.submit("m", _reqs((1,))[0])
        # the other model keeps serving
        assert srv.predict("b", _reqs((8,))[0], timeout=10).shape \
            == (8, OUT)
        assert srv._health()["reasons"] == ["breaker_open:m"]
        time.sleep(0.15)  # the next dispatch is the half-open probe
        assert srv.predict("m", _reqs((1,))[0], timeout=10).shape \
            == (1, OUT)
        assert srv.stats()["breakers"]["m"] == "closed"
        assert srv._health()["healthy"]
    finally:
        srv.stop()


def test_batcher_crash_restarts_then_dies_past_its_budget(models):
    config.set("resilience.retry_base_s", 0.001)
    srv = _server(max_batch=8, max_queue_delay_ms=0.0)
    srv.register("m", models["dyn"])
    srv.start()
    try:
        c0 = telemetry.counter("serving.batcher_crashes").value
        victim = _Request("m", _reqs((1,))[0], Future())
        with srv._cond:
            srv._pending.append(None)  # poison: the batcher crashes on it
            srv._pending.append(victim)
            srv._cond.notify_all()
        assert isinstance(victim.future.exception(timeout=10),
                          AttributeError)
        assert telemetry.counter("serving.batcher_crashes").value - c0 == 1
        assert srv.predict("m", _reqs((2,))[0], timeout=10).shape \
            == (2, OUT)
        assert srv.stats()["batcher_alive"]
        for _ in range(2):   # spend the rest of the 3-attempt budget
            with srv._cond:
                srv._pending.append(None)
                srv._cond.notify_all()
            deadline = time.perf_counter() + 10.0
            n = telemetry.counter("serving.batcher_crashes").value
            while telemetry.counter("serving.batcher_crashes").value == n:
                assert time.perf_counter() < deadline
                time.sleep(0.001)
        deadline = time.perf_counter() + 10.0
        while srv._batcher_dead is None:
            assert time.perf_counter() < deadline, "supervisor never died"
            time.sleep(0.001)
        with pytest.raises(serving.ServingError, match="restart budget"):
            srv.submit("m", _reqs((1,))[0])
        assert "batcher_dead" in srv._health()["reasons"]
    finally:
        srv.stop()


def test_lru_unregister_and_load_server(models):
    srv = _server(max_batch=4, max_queue_delay_ms=0.0, max_models=2)
    srv.register("a", models["dyn"])
    srv.register("b", models["dyn"])
    srv.start()
    try:
        srv.predict("a", _reqs((1,))[0], timeout=10)   # touch a: b is LRU
        e0 = telemetry.counter("serving.models_evicted").value
        srv.register("c", models["dyn"])
        assert srv.models() == ["a", "c"]
        assert telemetry.counter("serving.models_evicted").value - e0 == 1
        with pytest.raises(serving.ServingError, match="unknown"):
            srv.submit("b", _reqs((1,))[0])
        srv.unregister("a")
        assert srv.models() == ["c"]
    finally:
        srv.stop()
    srv = serving.load_server({"m": models["dyn"], "f": models["fix"]},
                              max_batch=8, device="cpu")
    try:
        assert srv.models() == ["m", "f"]
        assert srv.predict("f", _reqs((8,))[0], timeout=10).shape \
            == (8, OUT)
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="QUANTIZED"):
        serving.load_server({"m": models["dyn"], "q": models["q8"]},
                            device="cpu")


def test_quantized_model_beside_f32_in_one_server(models):
    f32 = deploy.load_model(models["dyn"], device="cpu")
    q8 = deploy.load_model(models["q8"], quantized=True, device="cpu")
    assert q8.recolored_sites == ["FullyConnected_0", "FullyConnected_1"]
    srv = _server(max_batch=8, max_queue_delay_ms=1.0)
    srv.register("f", models["dyn"])
    srv.register("q", models["q8"], quantized=True)
    with pytest.raises(ValueError, match="QUANTIZED"):
        srv.register("bad", models["q8"])
    srv.start()
    try:
        q0 = telemetry.counter("serving.quantized_dispatches").value
        xs = _reqs((1, 3, 2, 4), seed=9)
        fq = [srv.submit("q", x) for x in xs]
        ff = [srv.submit("f", x) for x in xs]
        for x, a, b in zip(xs, fq, ff):
            np.testing.assert_array_equal(a.result(timeout=10),
                                          q8.predict(x))
            np.testing.assert_array_equal(b.result(timeout=10),
                                          f32.predict(x))
        assert telemetry.counter("serving.quantized_dispatches").value > q0
        assert srv.stats()["quantized"] == {"f": False, "q": True}
        # quant.drift_every > 0 serves int8 models; an artifact with no
        # stats twin (this one, carried from the reference) serves
        # without sampling
        config.set("quant.drift_every", 2)
        try:
            srv.register("q2", models["q8"], quantized=True)
            d0 = telemetry.counter("serving.drift_samples").value
            for x in xs:
                np.testing.assert_array_equal(
                    srv.predict("q2", x, timeout=10), q8.predict(x))
            assert telemetry.counter("serving.drift_samples").value == d0
        finally:
            config.set("quant.drift_every", 0)
    finally:
        srv.stop()


def test_quantized_artifact_through_port_pipeline(models, tmp_path):
    """calibrate -> export_quantized -> Server(quantized=True) in the
    port alone, from the reference's calibration."""
    cal = quantization.Calibration.from_dict(models["rcal"].to_dict())
    cal.batches = list(models["calib"])
    prefix = str(tmp_path / "q")
    with mt.cpu():
        quantization.export_quantized(models["port_net"], prefix, cal)
    rq = ref.deploy.load_model(models["r_q8"], quantized=True)
    with _server(max_batch=4) as srv:
        srv.register("q", prefix, quantized=True)
        x = _reqs((3,), seed=4)[0]
        np.testing.assert_array_equal(srv.predict("q", x, timeout=10),
                                      rq.predict(x))


# ------------------------------------------------------------- generation

def test_generation_engine_supervisor_restarts_after_a_crash(tmp_path):
    import torch
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    torch.manual_seed(0)
    model = TransformerLM(TransformerLMConfig(
        vocab_size=32, num_layers=1, d_model=16, num_heads=2, d_ff=32,
        max_len=32, dtype=torch.float32), device="cpu")
    prefix = str(tmp_path / "lm")
    deploy.export_generation(model, None, prefix, page_size=8,
                             max_context=32)
    config.set("resilience.retry_base_s", 0.001)
    srv = _server()
    engine = srv.register("lm", prefix, generate=True)
    srv.start()
    try:
        want = srv.generate("lm", [1, 2, 3], 4, timeout=30)
        real = engine._admit_locked
        calls = [0]

        def crash_once():
            calls[0] += 1
            if calls[0] == 1:
                raise RuntimeError("injected engine crash")
            return real()

        c0 = telemetry.counter("serving.batcher_crashes").value
        engine._admit_locked = crash_once
        fut = srv.submit_generate("lm", [1, 2, 3], 4)
        exc = fut.exception(timeout=30)
        assert isinstance(exc, RuntimeError) and "injected" in str(exc)
        assert telemetry.counter("serving.batcher_crashes").value - c0 == 1
        # the restarted loop serves the same stream
        np.testing.assert_array_equal(
            srv.generate("lm", [1, 2, 3], 4, timeout=30), want)
        assert engine.stats()["engine_alive"]
    finally:
        srv.stop()


# --------------------------------------------------------- fault harness

def test_fault_harness_draws_as_the_reference_and_drives_retries():
    import mxnet_tpu.resilience  # noqa: F401
    from mxnet_tpu_torch import resilience
    rules = resilience.parse_faults("io:0.5, serving_dispatch:2@step=3")
    assert rules == ref.resilience.parse_faults(
        "io:0.5, serving_dispatch:2@step=3")
    for bad in ("io", "io:1.5", "io:1@epoch=2"):
        with pytest.raises(ValueError):
            resilience.parse_faults(bad)
    # one spec and seed: the same draws as the reference's harness
    try:
        ref.resilience.configure_faults("x:0.3,y:2@step=4", seed=5)
        want = [(ref.resilience.should_inject("x"),
                 ref.resilience.should_inject("y")) for _ in range(40)]
    finally:
        ref.resilience.configure_faults("", seed=0)
    resilience.configure_faults("x:0.3,y:2@step=4", seed=5)
    got = [(resilience.should_inject("x"), resilience.should_inject("y"))
           for _ in range(40)]
    assert got == want and any(g[0] for g in got)
    # call_with_retry(inject_faults=True) draws before each attempt
    config.set("resilience.retry_base_s", 0.001)
    config.set("resilience.faults", "io:1@step=1")
    i0 = telemetry.counter("resilience.injected.io").value
    r0 = telemetry.counter("resilience.retries.io").value
    calls = []
    assert resilience.call_with_retry(lambda: calls.append(1) or 7,
                                      kind="io", inject_faults=True) == 7
    assert calls == [1]
    assert telemetry.counter("resilience.injected.io").value - i0 == 1
    assert telemetry.counter("resilience.retries.io").value - r0 == 1
    # without inject_faults the armed harness is not drawn
    config.set("resilience.faults", "io:1.0")
    assert resilience.call_with_retry(lambda: 3, kind="io") == 3
    with pytest.raises(resilience.InjectedFault):
        resilience.call_with_retry(lambda: 3, kind="io",
                                   inject_faults=True)


def test_quantization_knobs_validate():
    for knob, bad in (("quant.calib_mode", "bogus"),
                      ("quant.drift_every", -1)):
        before = config.get(knob)
        with pytest.raises(ValueError):
            config.set(knob, bad)
        assert config.get(knob) == before
    assert config.get("serving.max_batch") == 32
    assert config.get("serving.max_queue_delay_ms") == 2.0
