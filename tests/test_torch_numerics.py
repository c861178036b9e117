"""mx.numerics in the port (mxnet_tpu_torch.numerics) against the
reference's on the CPU: ``summarize`` on seeded arrays with planted NaN,
±Inf, subnormals and values over bf16's largest (amax, amin, nonfinite
and the two fractions bitwise, rms within 1e-6 relative); the capture
sites of the fused Module, SPMDTrainer, the Gluon eager loop,
ShardedEmbedding and the TransformerLM (scan and unroll) in the
reference's names and order, their statistics at each loop's parity
bounds; the nanguard abort's forensics naming the reference's first
site; a step that captures nothing running exactly the ATen ops of a
capture-off step; and the drift EWMA."""
import glob
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu import config as jconfig
from mxnet_tpu import numerics as jnum
from mxnet_tpu import resilience as jres

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import numerics as tnum
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import (params_to_reference,
                                     symbol_params_from_reference)

from test_torch_module import _fixed_init, _mlp, _toy_data, BATCH
from test_torch_persistence import _spmd_pair, _spmd_batch

MODULE_RTOL, MODULE_ATOL = 1e-5, 1e-7
SPMD_RTOL, SPMD_ATOL = 1e-4, 1e-5
GLUON_TOL = 1e-5
STAT_EXACT = (0, 1, 3, 4, 5)   # amax, amin, nonfinite and the fractions


@pytest.fixture(autouse=True)
def _numerics_off(tmp_path):
    def reset():
        for config, num, res in ((jconfig, jnum, jres),
                                 (tconfig, tnum, tres)):
            config.unset("numerics.capture")
            config.set("resilience.nanguard", "")
            config.set("resilience.faults", "")
            res.reset_nanguard()
            num.reset()
        tconfig.unset("tracing.watchdog_dir")
        tt.reset()
    reset()
    tconfig.set("tracing.watchdog_dir", str(tmp_path))
    with mt.cpu():
        yield
    reset()


# ------------------------------------------------------------- stats math
# the reference's summarize, compiled once a dtype
_JSUMMARIZE = jax.jit(jnum.summarize)


def _planted(dtype, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4099) * 50).astype(np.float32)
    pos = rng.permutation(x.size)
    x[pos[:3]] = np.nan
    x[pos[3:5]] = np.inf
    x[pos[5:7]] = -np.inf
    if dtype in ("float32", "bfloat16"):
        x[pos[7:12]] = rng.uniform(1e-41, 1e-39, 5) * rng.choice([-1, 1], 5)
    if dtype == "float32":
        x[pos[12:15]] = np.float32(3.4e38)   # above bf16's largest finite
    return x


@pytest.mark.parametrize("planted", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_summarize_matches_the_reference(dtype, planted):
    x = _planted(dtype, 3) if planted else \
        (np.random.RandomState(4).randn(4099) * 3).astype(np.float32)
    want = np.asarray(_JSUMMARIZE(jnp.asarray(x).astype(dtype)))
    got = tnum.summarize(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and got.shape == (6,)
    got = got.numpy()
    np.testing.assert_array_equal(got[list(STAT_EXACT)].view(np.int32),
                                  want[list(STAT_EXACT)].view(np.int32))
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    if planted:
        assert got[3] == 7 and (dtype != "float32" or got[4] > 0)
        assert dtype == "float16" or got[5] > 0
    assert tnum.stats_dict(got) == pytest.approx(jnum.stats_dict(want),
                                                 rel=1e-6)


# ----------------------------------------------------- knob and cadence
def test_knob_grammar_revert_epoch_neutral_and_cadence():
    for spec, every in (("", 0), ("off", 0), ("step:1", 1),
                        ("step:10", 10)):
        assert tnum.configure(spec) == jnum.configure(spec) == every
    for bad in ("step:0", "step:-3", "always", "step:x"):
        with pytest.raises(ValueError):
            tnum.configure(bad)
    e0 = tconfig.epoch()
    tconfig.set("numerics.capture", "step:2")
    with pytest.raises(ValueError):
        tconfig.set("numerics.capture", "bogus")
    assert tconfig.get("numerics.capture") == ""
    tconfig.set("numerics.capture", "step:4")
    tconfig.unset("numerics.capture")
    tconfig.set("quant.drift_every", 3)
    tconfig.set("quant.drift_threshold", 2.0)
    tconfig.unset("quant.drift_every")
    tconfig.unset("quant.drift_threshold")
    assert tconfig.epoch() == e0
    for config, num in ((jconfig, jnum), (tconfig, tnum)):
        config.set("numerics.capture", "step:3")
        got = [num.should_capture("t") for _ in range(7)]
        config.unset("numerics.capture")
        assert not num.should_capture("t")
        config.set("numerics.capture", "step:3")
        got.append(num.should_capture("t"))   # resumes mid-cycle
        config.unset("numerics.capture")
        assert got == [True, False, False, True, False, False, True, False]
    assert tnum.capture_token(False) == jnum.capture_token(False)


def test_collector_order_publish_poll_and_listeners():
    x = torch.ones(3)
    assert tnum.tap("nope", x) is x and not tnum.collecting()
    with tnum.collect() as sink:
        tnum.tap("z_early", torch.full((2,), float("inf")))
        tnum.tap("b", torch.full((2,), float("nan")))
        tnum.tap("z_early", torch.ones(2))        # dedup -> z_early#2
        tnum.tap("ids", torch.ones(2, dtype=torch.int32))  # skipped
        tnum.tap_stacked("layer_out", torch.zeros(2, 6))
    host = tnum.expand_stats(dict(sink))
    assert list(host) == ["z_early", "b", "z_early#2", "layer_out[0]",
                          "layer_out[1]"]
    assert tnum.first_nonfinite(host) == "z_early"
    seen = []

    def listener(src, step, stats):
        seen.append((src, step, list(stats)))
    tnum.add_listener(listener)
    tnum.publish("unit", 7, dict(sink))
    assert tnum.poll("unit", block=True) == 0 or True
    tnum.remove_listener(listener)
    step, got = tnum.latest("unit")
    assert step == 7 and list(got) == list(host)
    for site in host:
        np.testing.assert_array_equal(got[site], host[site])
    assert seen == [("unit", 7, list(host))]
    assert tnum.latest("missing") is None


# ------------------------------------------------- the loops' sites
def _ref_module(ref_args):
    mod = jmx.mod.Module(_mlp(jmx))
    mod.bind([("data", (BATCH, 10))], [("softmax_label", (BATCH,))])
    mod.init_params(arg_params={n: jmx.nd.array(v)
                                for n, v in ref_args.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    return mod


def _port_module(ref_args):
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind([("data", (BATCH, 10))], [("softmax_label", (BATCH,))])
    arg, _ = symbol_params_from_reference(ref_args, {}, ctx=mt.cpu())
    mod.init_params(arg_params=arg)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    return mod


def _close(got, want, rtol, atol):
    assert list(got) == list(want)
    for site in want:
        np.testing.assert_array_equal(got[site][[3, 4, 5]],
                                      want[site][[3, 4, 5]], err_msg=site)
        np.testing.assert_allclose(got[site], want[site], rtol=rtol,
                                   atol=atol, err_msg=site)


def test_fused_module_sites_match_the_reference():
    X, Y = _toy_data(n=3 * BATCH)
    stats = {}
    for lib, config, num, make in ((jmx, jconfig, jnum, _ref_module),
                                   (mt, tconfig, tnum, _port_module)):
        config.set("module.fused_step", "on")
        config.set("numerics.capture", "step:1")
        try:
            mod = make(_fixed_init())
            for batch in lib.io.NDArrayIter(X, Y, batch_size=BATCH):
                mod.train_step(batch)
            num.poll("module", block=True)
            step, stats[lib] = num.latest("module")
            assert step == 3
        finally:
            config.unset("module.fused_step") if config is tconfig \
                else config.set("module.fused_step", "auto")
    got, want = stats[mt], stats[jmx]
    assert list(got)[:4] == ["fc1", "relu1", "fc2", "softmax"]
    assert list(got)[4:] == ["grad." + n for n in sorted(_fixed_init())] + \
        ["update." + n for n in sorted(_fixed_init())]
    _close(got, want, MODULE_RTOL, 1e-6)


def test_spmd_sites_match_the_reference():
    jtr, ttr = _spmd_pair("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    jconfig.set("numerics.capture", "step:1")
    tconfig.set("numerics.capture", "step:1")
    for i in range(2):
        x, y = _spmd_batch(i)
        jtr.step(x, y)
        ttr.step(torch.from_numpy(x), torch.from_numpy(y))
    jnum.poll("spmd", block=True)
    tnum.poll("spmd", block=True)
    (js, want), (ts, got) = jnum.latest("spmd"), tnum.latest("spmd")
    assert js == ts == 2
    assert list(got)[:2] == ["out", "loss"]
    _close(got, want, SPMD_RTOL, SPMD_ATOL)


def test_gluon_eager_sites_match_the_reference():
    rng = np.random.RandomState(2)
    w = rng.randn(4, 3).astype(np.float32)
    x = rng.randn(8, 3).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    stats = {}
    for lib, config, num in ((jmx, jconfig, jnum), (mt, tconfig, tnum)):
        config.set("numerics.capture", "step:1")
        net = lib.gluon.nn.Dense(4, in_units=3, prefix="dense_")
        net.initialize()
        net.weight.set_data(lib.nd.array(w))
        tr = lib.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        with lib.autograd.record():
            loss = lib.gluon.loss.L2Loss()(net(lib.nd.array(x)),
                                           lib.nd.array(y))
        loss.backward()
        tr.step(8)
        num.poll("gluon", block=True)
        stats[lib] = num.latest("gluon")[1]
    assert list(stats[mt]) == ["grad.dense_bias", "update.dense_bias",
                               "grad.dense_weight", "update.dense_weight"]
    _close(stats[mt], stats[jmx], GLUON_TOL, 1e-7)


def test_sharded_embedding_capture_matches_the_reference():
    from mxnet_tpu.parallel.embedding import ShardedEmbedding as JEmb
    from mxnet_tpu_torch.parallel.embedding import ShardedEmbedding as TEmb
    ids = np.array([[1, 2, 3, 1, 31]], np.int32)
    jconfig.set("numerics.capture", "step:1")
    tconfig.set("numerics.capture", "step:1")
    jemb = JEmb(32, 8)
    jemb.lookup(ids)
    temb = TEmb(32, 8)
    temb.set_table(np.asarray(jemb.table))
    temb.lookup(ids)
    jnum.poll("embedding", block=True)
    tnum.poll("embedding", block=True)
    _close(tnum.latest("embedding")[1], jnum.latest("embedding")[1],
           1e-6, 0)


def test_transformer_layer_taps_scan_and_unroll_match_the_reference():
    from mxnet_tpu.models.transformer import (TransformerLM as JLM,
                                              TransformerLMConfig as JCfg)
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    kw = dict(vocab_size=32, num_layers=3, d_model=16, d_ff=32, num_heads=2,
              max_len=16)
    jlm = JLM(JCfg(dtype=jnp.float32, **kw))
    tlm = TransformerLM(TransformerLMConfig(dtype=torch.float32, **kw),
                        device="cpu").init(0)
    p = params_to_reference(tlm.state_dict())
    toks = np.random.RandomState(0).randint(0, 32, (2, 8))

    def taps(params, t):
        # the taps fill the collector at trace time and leave the program
        # as its output (the reference's eager ops take ~10 s to compile)
        with jnum.collect() as jsink:
            jlm.apply(params, t)
        return dict(jsink)
    want = jnum.expand_stats(jax.jit(taps)(p, jnp.asarray(toks)))
    got = {}
    for mode in ("scan", "unroll"):
        tconfig.set("runtime.stack_mode", mode)
        try:
            with tnum.collect() as sink:
                out = tlm.apply(torch.from_numpy(toks))
        finally:
            tconfig.unset("runtime.stack_mode")
        got[mode] = tnum.expand_stats(dict(sink))
    assert list(got["scan"]) == ["layer_out[0]", "layer_out[1]",
                                 "layer_out[2]"]
    _close(got["scan"], want, 1e-5, 1e-6)
    _close(got["unroll"], got["scan"], 0, 0)
    # the plain path taps nothing and computes the same output
    assert torch.equal(tlm.apply(torch.from_numpy(toks)), out)


# ------------------------------------------------- nanguard forensics
def test_spmd_nanguard_abort_runs_forensics_as_the_reference(tmp_path):
    """tests/test_numerics.py:371-390 on both packages: the same first
    non-finite site ("out"); the port's abort also wrote the watchdog
    report, whose ring holds the forensics event."""
    firsts = {}
    jtr, ttr = _spmd_pair("sgd", {"learning_rate": 0.1})
    for lib, config, num, res, tr in (
            (jmx, jconfig, jnum, jres, jtr), (mt, tconfig, tnum, tres, ttr)):
        config.set("resilience.nanguard", "abort")
        config.set("resilience.faults", "nan:1@step=2")
        with pytest.raises(res.NonFiniteStepError) as err:
            for i in range(6):
                x, y = _spmd_batch(i)
                if lib is mt:
                    x, y = torch.from_numpy(x), torch.from_numpy(y)
                tr.step(x, y)
                res.poll_streaks(block=True)
        (rec,) = num.forensics_records()
        assert rec["source"] == "spmd" and "out" in rec["nonfinite_sites"]
        firsts[lib] = rec["first_nonfinite_site"]
    assert firsts[mt] == firsts[jmx] == "out"
    assert tt.snapshot()["gauges"][
        "numerics.first_nonfinite_site.spmd"] == "out"
    (report,) = glob.glob(os.path.join(str(tmp_path),
                                       "watchdog_report_*.json"))
    assert report in str(err.value)
    import json
    with open(report) as f:
        rep = mt.tracing.validate_watchdog_report(json.load(f))
    assert any(e["name"] == "nanguard_forensics" and
               e["first_nonfinite_site"] == "out" for e in rep["ring"])


def test_module_and_gluon_forensics_leave_the_state_alone():
    X, Y = _toy_data(n=BATCH)
    tconfig.set("resilience.nanguard", "abort")
    mod = _port_module(_fixed_init())
    good = next(mt.io.NDArrayIter(X, Y, batch_size=BATCH))
    bad = mt.io.DataBatch([good.data[0] * float("nan")], good.label)
    mod.train_step(good)
    mod.train_step(bad)
    tres.poll_streaks(block=True)
    before = {n: v._data.clone() for n, v in mod.get_params()[0].items()}
    with pytest.raises(tres.NonFiniteStepError):
        mod.train_step(good)
    rec = tnum.forensics_records()[-1]
    assert rec["first_nonfinite_site"] == "fc1"
    assert "update.fc1_weight" in rec["nonfinite_sites"]
    for n, v in mod.get_params()[0].items():
        assert torch.equal(v._data, before[n]), n
    net = mt.gluon.nn.Dense(2, in_units=3, prefix="d_")
    net.initialize()
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    with mt.autograd.record():
        loss = net(mt.nd.array(np.full((2, 3), np.nan, np.float32))).sum()
    loss.backward()
    tr.step(2)
    with pytest.raises(tres.NonFiniteStepError):
        tr.step(2)
    rec = tnum.forensics_records()[-1]
    assert rec["source"] == "gluon"
    # the bias gradient of a summed output stays finite
    assert rec["first_nonfinite_site"] == "grad.d_weight"


# -------------------------------------------- capture off adds no op
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops_of(step):
    with _Ops() as rec:
        step()
    return rec.ops


@pytest.mark.parametrize("loop", ["spmd", "module", "gluon"])
def test_uncaptured_step_runs_the_ops_of_a_capture_off_step(loop):
    """At step:1000 the steps after the first capture nothing: each runs
    exactly the ATen ops, in order, of a step with capture off."""
    if loop == "spmd":
        _, tr = _spmd_pair("adam", {"learning_rate": 0.01})
        x, y = (torch.from_numpy(a) for a in _spmd_batch(0))

        def step():
            tr.step(x, y)
    elif loop == "module":
        mod = _port_module(_fixed_init())
        X, Y = _toy_data(n=BATCH)
        batch = next(mt.io.NDArrayIter(X, Y, batch_size=BATCH))

        def step():
            mod.train_step(batch)
    else:
        net = mt.gluon.nn.Dense(4, in_units=3)
        net.initialize()
        tr = mt.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 0.1})
        x = mt.nd.array(np.ones((8, 3), np.float32))

        def step():
            with mt.autograd.record():
                loss = net(x).sum()
            loss.backward()
            tr.step(8)
    step()
    off = _ops_of(step)
    tconfig.set("numerics.capture", "step:1000")
    captured = _ops_of(step)        # the capture era's first step
    uncaptured = _ops_of(step)
    assert len(captured) > len(off)
    assert uncaptured == off


# ------------------------------------------------- quantization drift
def test_update_quant_drift_matches_the_reference():
    thresholds = {"fc_0": 1.0, "fc_1": 2.0, "none": 0.0}
    samples = [np.array([1.0, 2.0, 9.0])] + \
        [np.array([3.0, 2.0, 9.0])] * 8
    out = {}
    for num in (jnum, tnum):
        ewma = {}
        drifted = [num.update_quant_drift("m", ("fc_0", "fc_1", "none"), s,
                                          thresholds, ewma,
                                          threshold_ratio=1.5)
                   for s in samples]
        out[num] = (drifted, ewma)
    assert out[tnum] == out[jnum]
    assert out[tnum][0][-1] == ["fc_0"]
    assert tt.counter("quant.drift_trips").value == 1
    assert tt.snapshot()["gauges"]["quant.drift_ratio.m.fc_1"] == 1.0
