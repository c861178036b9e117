"""The port's ``mx.mod.BucketingModule`` held against the reference's, on
the CPU.

``examples/rnn_bucketing.py``'s model (Embedding, a 2-layer LSTM unrolled
from ``LSTMCell``s or one ``FusedRNNCell``, a Dense readout,
SoftmaxOutput) trains 6 Adam steps over its three buckets (sentence
lengths 8, 16, 24; the default bucket is the longest) from the same numpy
weights and batches in both packages.  The port runs its fused step with
the kernel tier on (K3's plain version) and off (``Adam.step``); the
reference runs its eager route, whose Adam bias correction is taken in
doubles from a Python step count as both of the port's are
(``tests/test_torch_module.py``).  After every step the parameters, the
optimizer's moments and its step count must agree: a bucket that started
Adam's moments or count afresh would miss them.

Tolerance.  Parameters: max |port - ref| within 1e-3 of the learning
rate (1e-5).  Each Adam step moves a weight by about the learning rate
whatever the gradient's size, and where a gradient entry is near Adam's
epsilon (an embedding row few tokens touch), the step follows the
gradient's last bits, which the two packages sum in other orders through
24 unrolled steps (measured: 1.2e-6).  Moments: max |port - ref| within
1e-5 of the state tensor's largest magnitude (measured: 1.2e-6).  A
bucket whose moments restart moves weights by a good part of the
learning rate at its first step, far beyond both bounds.
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as ref
from mxnet_tpu import config as rconfig
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

LR = 0.01
PARAM_ATOL = 1e-3 * LR
STATE_RTOL = 1e-5
VOCAB, EMBED, HIDDEN, LAYERS, BATCH = 20, 6, 8, 2, 4
KEYS = (24, 8, 16, 8, 24, 16)


def _batches(pkg, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for key in KEYS:
        data = rng.randint(1, VOCAB, (BATCH, key)).astype(np.float32)
        label = np.roll(data, -1, axis=1)
        ctx = mt.cpu() if pkg is mt else ref.cpu()
        with ctx:
            b = pkg.io.DataBatch(
                [pkg.nd.array(data)], [pkg.nd.array(label)], pad=0,
                provide_data=[pkg.io.DataDesc("data", data.shape)],
                provide_label=[pkg.io.DataDesc("softmax_label",
                                               label.shape)])
        b.bucket_key = key
        out.append(b)
    return out


def _params(fused):
    sym, _, _ = chip_smoke.bucket_sym_gen(
        mt, chip_smoke.bucket_cell(mt, HIDDEN, LAYERS, fused), VOCAB,
        EMBED, HIDDEN)(24)
    shapes, _, _ = sym.infer_shape(data=(BATCH, 24),
                                   softmax_label=(BATCH, 24))
    rng = np.random.RandomState(1)
    return {n: (rng.randn(*s) * 0.2).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _train(pkg, fused, params, on_step):
    """6 steps; ``on_step(step, module)`` after each."""
    ctx = mt.cpu() if pkg is mt else ref.cpu()
    with ctx:
        cell = chip_smoke.bucket_cell(pkg, HIDDEN, LAYERS, fused)
        kw = {"context": mt.cpu()} if pkg is mt else {}
        mod = pkg.mod.BucketingModule(
            chip_smoke.bucket_sym_gen(pkg, cell, VOCAB, EMBED, HIDDEN),
            default_bucket_key=24, **kw)
        batches = _batches(pkg)
        mod.bind(batches[0].provide_data, batches[0].provide_label)
        mod.init_params(initializer=None, arg_params={
            n: pkg.nd.array(v) for n, v in params.items()})
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": LR})
        for step, batch in enumerate(batches):
            mod.forward_backward(batch)
            mod.update()
            on_step(step, mod)
        return mod


def _port_state(mod, name):
    st = mod._buckets[24]._fused_shared.state[name]
    return [s.detach().numpy().copy() for s in st]


def _ref_state(mod, name):
    default = mod._buckets[24]
    st = default._updater.states[default._param_names.index(name)]
    return [s.asnumpy() for s in st]


_REF_RUNS = {}


def _reference_run(fused, params):
    """The reference's parameters, moments and step count after each step
    (one run a cell kind, shared by the tier cases)."""
    if fused in _REF_RUNS:
        return _REF_RUNS[fused]
    want = []

    def keep_ref(step, mod):
        arg, _ = mod.get_params()
        want.append(({n: v.asnumpy() for n, v in arg.items()},
                     {n: _ref_state(mod, n) for n in params},
                     mod._buckets[24]._optimizer.num_update))

    prev = rconfig.get("module.fused_step")
    rconfig.set("module.fused_step", "off")
    try:
        _train(ref, fused, params, keep_ref)
    finally:
        rconfig.set("module.fused_step", prev)
    _REF_RUNS[fused] = want
    return want


@pytest.mark.parametrize("tier", [True, False], ids=["tier_on", "tier_off"])
@pytest.mark.parametrize("fused", [False, True], ids=["unrolled", "fused"])
def test_bucketing_adam_matches_reference_every_step(fused, tier):
    params = _params(fused)
    want = _reference_run(fused, params)

    def check(step, mod):
        warg, wstate, wt = want[step]
        arg, _ = mod.get_params()
        assert mod._buckets[24]._fused_shared.t == wt == step + 1
        for n in params:
            np.testing.assert_allclose(arg[n].asnumpy(), warg[n], rtol=0,
                                       atol=PARAM_ATOL, err_msg="%s step %d"
                                       % (n, step))
            for k, (g, w) in enumerate(zip(_port_state(mod, n), wstate[n])):
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=STATE_RTOL * np.abs(w).max(),
                    err_msg="%s state %d step %d" % (n, k, step))

    tconfig.set("kernels.enabled", tier)
    try:
        mod = _train(mt, fused, params, check)
    finally:
        tconfig.unset("kernels.enabled")
    assert sorted(mod._buckets) == [8, 16, 24]


def test_buckets_share_parameters_and_optimizer_state():
    """Every bucket's parameters ARE the default bucket's NDArrays (a
    switch copies nothing), and one optimizer, updater and fused state
    serve them all."""
    params = _params(False)
    mod = _train(mt, False, params, lambda step, m: None)
    default = mod._buckets[24]
    for key in (8, 16):
        other = mod._buckets[key]
        for n in params:
            assert other._exec.arg_dict[n] is default._exec.arg_dict[n]
        assert other._param_names == default._param_names
        assert other._optimizer is default._optimizer
        assert other._updater is default._updater
        assert other._fused_shared is default._fused_shared


def test_bucket_parameter_missing_from_default_raises():
    def sym_gen(key):
        data = mt.sym.Variable("data")
        h = mt.sym.FullyConnected(data, num_hidden=4, name="fc")
        if key != 3:
            h = mt.sym.FullyConnected(h, num_hidden=4, name="extra")
        return mt.sym.LinearRegressionOutput(h, name="out"), ("data",), \
            ("out_label",)
    with mt.cpu():
        mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=3,
                                     context=mt.cpu())
        mod.bind([("data", (2, 5))], [("out_label", (2, 4))])
        mod.init_params()
        with pytest.raises(ValueError, match="extra_weight"):
            mod.switch_bucket(5, [("data", (2, 5))], [("out_label", (2, 4))])
