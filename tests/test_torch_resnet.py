"""The port's Gluon path held against the reference's, on the CPU: ops,
layers, ``resnet50_v1`` and the SGD optimizer.

Inputs are made by numpy from a seed and handed to both packages; weights
are drawn by the port and carried across
(``convert.gluon_params_to_reference``), so the two random streams never
have to agree.  Tolerances, each stated where it is used:

* convolution, pooling, dense and the loss: f32, 1e-5 relative to the
  output's largest magnitude (the packages sum in different orders; max
  pooling is exact);
* BatchNorm: f32, 1e-5 relative, on the output, the batch mean and
  variance and the layer's moving statistics;
* ``resnet50_v1``, f32: the 193 trainable and 106 aux names, shapes and
  order exactly; the logits within RESNET_RTOL (inference, 1x3x64x64) or
  RESNET_TRAIN_RTOL (training mode, 4x3x64x64) of their largest
  magnitude;
* SGD ``update`` / ``update_multi_precision``: bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ops import nn as jops
from mxnet_tpu.ops import tensor as jtensor  # noqa: F401 (registers pick)
from mxnet_tpu.parallel import functionalize as jfunctionalize

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import (gluon_params_from_reference,
                                     gluon_params_to_reference)
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.parallel import functionalize

RTOL = 1e-5
# resnet50_v1 logits, f32, after 53 convolutions summed in different
# orders by XLA and PyTorch: measured 2.2e-6 in inference; bounded at
# 1e-4.
RESNET_RTOL = 1e-4
# In training mode every BatchNorm divides by its batch std, and at
# 4x3x64x64 the last stage normalises each channel over 16 positions
# (2x2 maps): the net amplifies f32 summation-order differences layer by
# layer.  Measured 7.6e-4 at the logits (1.4e-4 with the exact two-pass
# variance; the first BatchNorm alone differs by 2e-5, its single-pass
# E[x^2] - E[x]^2 cancelling in channels whose |mean| is many times their
# std).  Bounded at 5e-3.  The ops themselves are held at 1e-5 above.
RESNET_TRAIN_RTOL = 5e-3


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, "max |port - reference| / max |reference| = %g" % err


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ ops
@pytest.mark.parametrize("groups,bias", [(1, True), (2, False)],
                         ids=["bias", "grouped"])
def test_convolution_matches_reference(groups, bias):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 9, 9).astype(np.float32)
    w = rng.randn(6, 4 // groups, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32) if bias else None
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=6,
              num_group=groups, no_bias=not bias)
    want = jops._convolution(jnp.asarray(x), jnp.asarray(w),
                             None if b is None else jnp.asarray(b), **kw)
    got = tops._convolution(_t(x), _t(w), None if b is None else _t(b),
                            **kw)
    _close(got, want)


def test_convolution_nhwc_internal_layout_keeps_the_values():
    """``conv.internal_layout=NHWC`` (channels_last in memory) gives the
    native layout's values."""
    rng = np.random.RandomState(1)
    x, w = _t(rng.randn(2, 8, 7, 7).astype(np.float32)), \
        _t(rng.randn(4, 8, 1, 1).astype(np.float32))
    kw = dict(kernel=(1, 1), stride=(1, 1), pad=(0, 0), num_filter=4)
    native = tops._convolution(x, w, **kw)
    mt.config.set("conv.internal_layout", "NHWC")
    try:
        nhwc = tops._convolution(x, w, **kw)
    finally:
        mt.config.unset("conv.internal_layout")
    _close(nhwc, native.numpy())


@pytest.mark.parametrize("case", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(2, 2), stride=(2, 2), pad=(0, 0), pool_type="avg"),
    dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="avg",
         count_include_pad=False),
    dict(global_pool=True, pool_type="avg"),
    dict(global_pool=True, pool_type="max")],
    ids=["max-pad", "avg", "avg-nopad", "global-avg", "global-max"])
def test_pooling_matches_reference(case):
    x = np.random.RandomState(2).randn(2, 3, 9, 9).astype(np.float32) - 2.0
    want = jops._pooling(jnp.asarray(x), **case)
    got = tops._pooling(_t(x), **case)
    if case["pool_type"] == "max":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)


@pytest.mark.parametrize("mode", ["train", "train-two-pass", "inference",
                                  "fix-gamma"])
def test_batch_norm_op_matches_reference(mode):
    """Output, batch mean and batch variance; the input sits off zero
    (mean 3, std 2) and the moving mean (the shift) off the batch mean."""
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 5, 6, 6) * 2.0 + 3.0).astype(np.float32)
    gamma = rng.rand(5).astype(np.float32) + 0.5
    beta = rng.randn(5).astype(np.float32)
    mm = rng.randn(5).astype(np.float32)
    mv = rng.rand(5).astype(np.float32) + 0.5
    kw = dict(eps=1e-5, fix_gamma=mode == "fix-gamma",
              training=mode != "inference")
    two = mode == "train-two-pass"
    jmx.config.set("bn_two_pass_stats", two)
    mt.config.set("bn_two_pass_stats", two)
    try:
        want = jops._batch_norm(*(jnp.asarray(a) for a in
                                  (x, gamma, beta, mm, mv)), **kw)
        got = tops._batch_norm(*(_t(a) for a in (x, gamma, beta, mm, mv)),
                               **kw)
    finally:
        jmx.config.unset("bn_two_pass_stats")
        mt.config.unset("bn_two_pass_stats")
    for g, w in zip(got, want):
        _close(g, w)


def test_batch_norm_layer_moving_stats_match_reference():
    """The layer's training forward: output and the moving statistics it
    writes (momentum 0.9, biased batch variance), from the same state."""
    x = (np.random.RandomState(4).randn(3, 4, 5, 5) * 1.5 + 0.5).astype(
        np.float32)
    jbn, tbn = jnn.BatchNorm(in_channels=4), tnn.BatchNorm(in_channels=4)
    jbn.initialize()
    tbn.initialize(ctx=mt.cpu())
    for p in jbn.collect_params().values():
        p.set_data(jmx.nd.array(np.random.RandomState(5).rand(4) + 0.5))
    gluon_params_from_reference(
        tbn, {n: p.data().asnumpy() for n, p in
              jbn.collect_params().items()})
    with jmx.autograd.train_mode():
        jout = jbn(jmx.nd.array(x))
    with mt.autograd.train_mode():
        tout = tbn(mt.nd.array(x, ctx=mt.cpu()))
    _close(tout.asnumpy(), jout.asnumpy())
    for name in ("running_mean", "running_var"):
        _close(getattr(tbn, name).data().asnumpy(),
               getattr(jbn, name).data().asnumpy())


def test_dense_and_loss_match_reference():
    """Dense (flattening a 4-D input) into SoftmaxCrossEntropyLoss with
    float labels: the per-example losses."""
    rng = np.random.RandomState(6)
    x = rng.randn(4, 3, 2, 2).astype(np.float32)
    w = rng.randn(10, 12).astype(np.float32)
    b = rng.randn(10).astype(np.float32)
    label = rng.randint(0, 10, (4,)).astype(np.float32)
    jlogits = jops._fully_connected(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b))
    tlogits = tops._fully_connected(_t(x), _t(w), _t(b))
    _close(tlogits, jlogits)
    from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JLoss
    jl = JLoss()(jmx.nd.array(np.asarray(jlogits)), jmx.nd.array(label))
    tl = SoftmaxCrossEntropyLoss()(mt.nd.array(tlogits, ctx=mt.cpu()),
                                   mt.nd.array(label, ctx=mt.cpu()))
    assert tl.shape == (4,)
    _close(tl.asnumpy(), jl.asnumpy())


# ------------------------------------------------------------- resnet50
def test_resnet50_v1_matches_reference():
    """Structure: the same 193 trainable and 106 aux names (after each
    net's own top prefix), shapes and order as the reference's
    ``functionalize(net)``, 25,575,912 trainable parameters.  Values: the
    port's seeded Xavier weights carried into the reference, one f32
    forward at 1x3x64x64 in inference mode and one at 4x3x64x64 in
    training mode."""
    mt.random.seed(0)
    tnet = tvision.get_model("resnet50_v1", classes=1000)
    tnet.initialize(mt.init.Xavier(), ctx=mt.cpu())
    jnet = jvision.get_model("resnet50_v1", classes=1000)
    jnet.initialize(jmx.init.Zero())   # values come from the port
    x = np.random.RandomState(7).rand(1, 3, 64, 64).astype(np.float32)
    tnet(mt.nd.array(x, ctx=mt.cpu()))     # resolve the deferred shapes
    jnet(jmx.nd.array(x))
    tf, jf = functionalize(tnet), jfunctionalize(jnet)
    tp, jp = len(tnet.prefix), len(jnet.prefix)
    assert [n[tp:] for n in tf.trainable] == [n[jp:] for n in jf.trainable]
    assert [n[tp:] for n in tf.aux] == [n[jp:] for n in jf.aux]
    assert (len(tf.trainable), len(tf.aux)) == (193, 106)
    assert [tf.params[n].shape for n in tf.trainable + tf.aux] == \
        [jf.params[n].shape for n in jf.trainable + jf.aux]
    assert sum(int(np.prod(tf.params[n].shape)) for n in tf.trainable) \
        == 25575912
    for name, val in gluon_params_to_reference(tnet, jnet.prefix).items():
        jf.params[name].set_data(jmx.nd.array(val))
    _close(tnet(mt.nd.array(x, ctx=mt.cpu())).asnumpy(),
           jnet(jmx.nd.array(x)).asnumpy(), RESNET_RTOL)
    x4 = np.random.RandomState(8).rand(4, 3, 64, 64).astype(np.float32)
    with mt.autograd.train_mode():
        tout = tnet(mt.nd.array(x4, ctx=mt.cpu()))
    with jmx.autograd.train_mode():
        jout = jnet(jmx.nd.array(x4))
    _close(tout.asnumpy(), jout.asnumpy(), RESNET_TRAIN_RTOL)


def test_gluon_params_from_reference_refuses_what_does_not_pair():
    net = tnn.Dense(3, in_units=4)
    net.initialize(ctx=mt.cpu())
    ok = {"dense7_weight": np.ones((3, 4), np.float32),
          "dense7_bias": np.zeros(3, np.float32)}
    gluon_params_from_reference(net, ok)
    assert float(net.weight.data().asnumpy().sum()) == 12.0
    back = gluon_params_to_reference(net, "dense7_")
    assert sorted(back) == sorted(ok)
    with pytest.raises(ValueError, match="pair up"):
        gluon_params_from_reference(net, {"dense7_weight": ok[
            "dense7_weight"], "dense7_gamma": ok["dense7_bias"]})
    with pytest.raises(ValueError, match="shape"):
        gluon_params_from_reference(net, {"dense7_weight": np.ones(
            (4, 3), np.float32), "dense7_bias": ok["dense7_bias"]})


# --------------------------------------------------------------- SGD
class _Tier:
    """The kernel tier of both packages on or off, for one block."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        jmx.config.set("kernels.enabled", self.on)
        mt.config.set("kernels.enabled", self.on)

    def __exit__(self, *exc):
        jmx.config.unset("kernels.enabled")
        mt.config.unset("kernels.enabled")


def _bits(t):
    return t.float().view(torch.int32) if t.dtype == torch.bfloat16 \
        else t.view(torch.int32)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("tier", [True, False], ids=["tier-on", "tier-off"])
def test_sgd_update_multi_precision_bitwise_with_reference(tier, momentum):
    """A bf16 weight over an f32 master, SGD with wd, three updates: the
    bf16 weight, the master and the momentum equal the reference's bit
    for bit.  Tier on, both take their fused step (K1's plain version
    here, the Pallas kernel there; one ``kernels.fused_step`` per update);
    tier off, their plain ``step``."""
    rng = np.random.RandomState(8)
    w0 = (rng.randn(33, 17) * 0.05).astype(np.float32)
    grads = [rng.randn(33, 17).astype(np.float32) for _ in range(3)]
    kw = dict(learning_rate=0.1, momentum=momentum, wd=1e-4,
              multi_precision=True)
    jo, to = jmx.optimizer.create("sgd", **kw), mt.optimizer.create("sgd",
                                                                    **kw)
    jw = jmx.nd.array(w0, dtype="bfloat16")
    tw = _t(w0).to(torch.bfloat16)
    jstate = jo.create_state_multi_precision(0, jw)
    tstate = to.create_state_multi_precision(0, tw)
    jtel.reset()
    tt.reset()
    with _Tier(tier):
        for g in grads:
            jo.update_multi_precision(0, jw, jmx.nd.array(
                g, dtype="bfloat16"), jstate)
            to.update_multi_precision(0, tw, _t(g).to(torch.bfloat16),
                                      tstate)
    fused = jtel.snapshot()["counters"].get("kernels.fused_step", 0)
    assert fused == (3 if tier else 0)
    assert tt.snapshot()["counters"].get("kernels.fused_step", 0) == fused
    pairs = [(tw, jw), (tstate[0], jstate[0])]
    if momentum:
        pairs.append((tstate[1], jstate[1]))
    else:
        assert tstate[1] is None and jstate[1] is None
    for got, want in pairs:
        want = _t(np.asarray(want.asnumpy(), np.float32)).to(got.dtype)
        assert torch.equal(_bits(got), _bits(want)), \
            "port and reference differ"


def test_sgd_update_f32_bitwise_with_reference():
    """``update`` on an f32 weight (no master): SGD's plain ``step``, which
    rounds each product and sum once as the reference's eager step does."""
    rng = np.random.RandomState(9)
    w0 = rng.randn(40).astype(np.float32)
    jo = jmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                              wd=1e-4)
    to = mt.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                             wd=1e-4)
    jw, tw = jmx.nd.array(w0), _t(w0).clone()
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for _ in range(3):
        g = rng.randn(40).astype(np.float32)
        jo.update(0, jw, jmx.nd.array(g), js)
        to.update(0, tw, _t(g), ts)
    np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                  jw.asnumpy().view(np.uint32))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  js.asnumpy().view(np.uint32))


# ------------------------------------------------------ honest failures
def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    net = tnn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    assert net.weight.data()._data.device.type == "cpu"
    with mt.cpu():
        assert mt.nd.zeros((2,)).context == mt.cpu()
        assert mt.parallel.make_mesh().device.type == "cpu"
    if torch.cuda.is_available():
        assert mt.parallel.make_mesh().device == torch.device("cuda", 0)
        return
    for entry in (lambda: tnn.Dense(2, in_units=3).initialize(),
                  lambda: mt.nd.array(np.zeros(2)),
                  mt.parallel.make_mesh,
                  lambda: mt.parallel.SPMDTrainer(net, lambda o, l: o,
                                                  "sgd")):
        with pytest.raises(mt.MXNetErrorNoDevice):
            entry()
