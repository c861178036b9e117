"""The port's int8 quantization against the reference on the CPU: the 14
quantized ops, the int8 product route's plain versions, the calibration
core (KL threshold and thresholds bitwise on one numpy input), the
calibration runner's sites, ``export_quantized`` -> ``load_model(
quantized=True)`` from the reference's calibration, the guardrail,
excluded sites and ``quantize_model``'s graph rewrite.

Int8 codes and int32 accumulators are held bit for bit; an f32 output is
held bit for bit where both packages round alike, else within the stated
tolerance."""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as ref
import mxnet_tpu.name  # noqa: F401
from mxnet_tpu.contrib import quantization as ref_cq
from mxnet_tpu.ops.registry import _REGISTRY as REF_OPS

import mxnet_tpu_torch as mt
import mxnet_tpu_torch.name  # noqa: F401
from mxnet_tpu_torch import deploy, quantization, telemetry
from mxnet_tpu_torch.contrib import quantization as port_cq
from mxnet_tpu_torch.convert import gluon_params_from_reference
from mxnet_tpu_torch.ops import int8
from mxnet_tpu_torch.ops.registry import _REGISTRY as PORT_OPS

RNG = np.random.default_rng(7)


def _f32(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _i8(*shape):
    return RNG.integers(-127, 128, shape).astype(np.int8)


def _run_ref(name, args, attrs):
    out = REF_OPS[name].fn(*[jnp.asarray(a) for a in args], **attrs)
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list))
                                    else (out,))]


def _run_port(name, args, attrs):
    out = PORT_OPS[name].fn(*[torch.from_numpy(np.array(a)) for a in args],
                            **attrs)
    return [o.numpy() for o in (out if isinstance(out, (tuple, list))
                                else (out,))]


# (op, inputs, attrs, f32 tolerance: 0 = bitwise)
OP_CASES = {
    "_contrib_quantize_v2": (lambda: [_f32(4, 9)],
                             {"min_calib_range": -1.5,
                              "max_calib_range": 2.0}, 0),
    "quantize_v2": (lambda: [_f32(3, 5, 2)], {}, 0),
    "_contrib_dequantize": (lambda: [_i8(4, 6), np.float32(-2.5),
                                     np.float32(1.75)], {}, 0),
    "_sim_quant": (lambda: [_f32(5, 7)], {"amax": 1.3}, 0),
    "_contrib_quantized_fully_connected": (
        lambda: [_f32(6, 2, 5), _f32(8, 10), _f32(8)],
        {"amax_data": 2.5, "amax_weight": 1.8, "num_hidden": 8}, 0),
    "quantized_fully_connected": (
        lambda: [_f32(5, 12), _f32(4, 12)],
        {"amax_data": 0.0, "amax_weight": 2.0, "no_bias": True}, 0),
    "_contrib_quantized_conv": (
        lambda: [_f32(2, 4, 9, 9), _f32(6, 2, 3, 3), _f32(6)],
        {"amax_data": 3.0, "amax_weight": 1.5, "kernel": (3, 3),
         "stride": (2, 2), "pad": (1, 1), "num_filter": 6,
         "num_group": 2}, 0),
    "_contrib_quantize": (lambda: [_f32(3, 8), np.float32(-1.0),
                                   np.float32(1.2)], {}, 0),
    "_contrib_requantize": (
        lambda: [RNG.integers(-2 ** 30, 2 ** 30, (4, 6)).astype(np.int32),
                 np.float32(-3.0), np.float32(2.0)], {}, 0),
    "requantize": (
        lambda: [RNG.integers(-2 ** 30, 2 ** 30, (5,)).astype(np.int32),
                 np.float32(-3.0), np.float32(2.0)],
        {"min_calib_range": -0.5, "max_calib_range": 0.75}, 0),
    "_contrib_quantized_act": (lambda: [_i8(3, 7), np.float32(-2.0),
                                        np.float32(2.0)], {}, 0),
    "_contrib_quantized_flatten": (lambda: [_i8(2, 3, 4), np.float32(-1.0),
                                            np.float32(1.5)], {}, 0),
    "_contrib_quantized_concat": (
        lambda: [_i8(2, 3), _i8(2, 5), np.float32([-1.0]),
                 np.float32([-4.0]), np.float32([1.5]),
                 np.float32([3.0])], {"dim": 1, "num_args": 2}, 0),
    "_contrib_quantized_elemwise_add": (
        lambda: [_i8(4, 5), _i8(4, 5), np.float32(-1.0), np.float32(1.0),
                 np.float32(-2.5), np.float32(3.0)], {}, 0),
    "_contrib_quantized_pooling": (
        lambda: [_i8(2, 3, 6, 6), np.float32(-1.0), np.float32(1.0)],
        {"kernel": (2, 2), "pool_type": "max"}, 0),
    "quantized_pooling": (
        lambda: [_i8(2, 3, 6, 6), np.float32(-1.0), np.float32(1.0)],
        {"kernel": (3, 3), "stride": (2, 2), "pool_type": "avg"}, 0),
    "_contrib_quantized_batch_norm": (
        lambda: [_i8(2, 4, 3, 3), _f32(4), _f32(4),
                 _f32(4), np.abs(_f32(4)) + 0.5, np.float32(-2.0),
                 np.float32(2.0)], {"eps": 1e-3}, 0),
    "_contrib_calibrate_entropy": (
        lambda: [np.histogram(np.abs(_f32(20000)), bins=501)[0]
                 .astype(np.float32),
                 np.histogram(np.abs(_f32(20000)), bins=501)[1]
                 .astype(np.float32)], {"num_quantized_bins": 255}, 0),
}


def test_the_fourteen_ops_are_registered_under_every_alias():
    canon = {REF_OPS[n].name for n in OP_CASES}
    assert len(canon) == 14
    for name, op in REF_OPS.items():
        if op.name in canon:
            assert PORT_OPS[name].name == op.name, name


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_quantized_op_against_reference(name):
    make, attrs, tol = OP_CASES[name]
    args = make()
    want = _run_ref(name, args, dict(attrs))
    got = _run_port(name, args, dict(attrs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if g.dtype.kind in "iu" or tol == 0:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


# ------------------------------------------------------- the product route

def _np_conv(x, w, stride, pad, dil, groups):
    x, w = x.astype(np.int64), w.astype(np.int64)
    n, c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    ho = (h + 2 * pad - dil * (kh - 1) - 1) // stride + 1
    wo = (wd + 2 * pad - dil * (kw - 1) - 1) // stride + 1
    out = np.zeros((n, o, ho, wo), np.int64)
    og = o // groups
    for oc in range(o):
        g = oc // og
        for i in range(kh):
            for j in range(kw):
                win = xp[:, g * cg:(g + 1) * cg,
                         i * dil:i * dil + stride * (ho - 1) + 1:stride,
                         j * dil:j * dil + stride * (wo - 1) + 1:stride]
                out[:, oc] += np.einsum("nchw,c->nhw", win, w[oc, :, i, j])
    return out


@pytest.mark.parametrize("case", [
    (3, 64, 7, 2, 3, 1, 1),     # ResNet-50's first conv: K = 147
    (8, 8, 3, 1, 1, 1, 4),      # grouped
    (6, 4, 3, 2, 1, 2, 2),      # grouped, strided, dilated
    (16, 8, 1, 1, 0, 1, 1),     # 1x1
])
def test_int8_conv_plain_against_numpy(case):
    c, o, k, s, p, d, g = case
    x, w = _i8(2, c, 13, 11), _i8(o, c // g, k, k)
    got = int8.int8_conv(torch.from_numpy(x), torch.from_numpy(w), s, p, d,
                         g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np_conv(x, w, s, p, d, g))


@pytest.mark.parametrize("mkn", [(5, 147, 9), (33, 64, 1000), (1, 8, 3)])
def test_int8_matmul_plain_and_padded_route_against_numpy(mkn):
    """The plain version, and the card route's zero padding to
    ``_int_mm``'s shape rules (run through ``torch._int_mm`` on the CPU),
    both exact."""
    m, k, n = mkn
    a, b = _i8(m, k), _i8(n, k)
    want = a.astype(np.int64) @ b.astype(np.int64).T
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(int8.int8_matmul(ta, tb).numpy(), want)
    before = int8.PRODUCTS["int8_mm"]
    np.testing.assert_array_equal(int8._mm_cuda(ta, tb).numpy(), want)
    assert int8.PRODUCTS["int8_mm"] == before + 1


def test_int8_accumulators_bitwise_with_reference():
    """The int32 accumulators of the reference's ``lax.dot_general`` /
    ``conv_general_dilated`` at ``preferred_element_type=int32``."""
    from jax import lax
    a, b = _i8(7, 147), _i8(24, 147)
    want = lax.dot_general(jnp.asarray(a), jnp.asarray(b),
                           (((1,), (1,)), ((), ())),
                           preferred_element_type=jnp.int32)
    got = int8.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x, w = _i8(2, 6, 10, 10), _i8(8, 3, 3, 3)
    dn = lax.conv_dimension_numbers(x.shape, w.shape,
                                    ("NCHW", "OIHW", "NCHW"))
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), ((1, 1), (1, 1)),
        rhs_dilation=(1, 1), dimension_numbers=dn, feature_group_count=2,
        preferred_element_type=jnp.int32)
    got = int8.int8_conv(torch.from_numpy(x), torch.from_numpy(w), 2, 1, 1,
                         2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_route_refuses_what_it_cannot_take():
    with pytest.raises(mt.KernelUnsupportedError):
        int8.int8_matmul(torch.zeros(2, 3), torch.zeros(2, 3))
    with pytest.raises(mt.KernelUnsupportedError):
        int8.int8_conv(torch.zeros(1, 3, 4, 4, dtype=torch.int8),
                       torch.zeros(4, 2, 3, 3, dtype=torch.int8), groups=2)


# ----------------------------------------------------- the calibration core

def test_kl_threshold_and_calib_thresholds_bitwise():
    acts = {"a": np.abs(_f32(50000)) ** 1.5,
            "b": _f32(3000, scale=0.2),
            "c": np.zeros(16, np.float32),
            "d": np.array([1.0, np.inf, 2.0, np.nan], np.float32)}
    for mode in ("naive", "entropy"):
        assert port_cq.calib_thresholds(acts, mode=mode, num_bins=2001) \
            == ref_cq.calib_thresholds(acts, mode=mode, num_bins=2001)
    hist, edges = np.histogram(acts["a"], bins=1001)
    for bins in (255, 127):
        assert port_cq._kl_threshold(hist, edges, bins) \
            == ref_cq._kl_threshold(hist, edges, bins)
    assert port_cq._kl_threshold(np.zeros(8), np.arange(9.0)) == 8.0


# ------------------------------------------------ calibrate / export / load

def _cbrpd(pkg):
    """conv-BN-ReLU-pool-Dense, built under a fresh NameManager so both
    packages name it alike."""
    nn = pkg.gluon.nn
    with pkg.name.NameManager():
        net = nn.HybridSequential()
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=8), nn.Activation("relu"),
                nn.MaxPool2D(2), nn.Conv2D(8, 3, padding=1, in_channels=8),
                nn.Activation("relu"), nn.Dense(10, in_units=8 * 4 * 4))
    return net


def _batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((4, 3, 8, 8)).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def nets():
    """The same weights in both packages (drawn by the reference)."""
    batches = _batches()
    rn = _cbrpd(ref)
    rn.initialize()
    rn(ref.nd.array(batches[0]))
    with mt.cpu():
        pn = _cbrpd(mt)
        pn.initialize()
        pn(mt.nd.array(batches[0]))
        gluon_params_from_reference(pn, {n: p.data().asnumpy() for n, p
                                         in rn.collect_params().items()})
    return rn, pn, batches


def test_calibrate_sites_and_weight_map_equal_the_reference(nets):
    rn, pn, batches = nets
    rcal = ref.quantization.calibrate(rn, batches, mode="naive")
    with mt.cpu():
        pcal = quantization.calibrate(pn, batches, mode="naive")
    assert pcal.sites == rcal.sites
    assert [s["name"] for s in pcal.sites] == [
        "Convolution_0", "Convolution_1", "FullyConnected_2"]
    assert pcal.num_samples == rcal.num_samples
    assert pcal.num_batches == rcal.num_batches == 3
    # the first site reads the input itself: its naive amax is bitwise
    assert pcal.thresholds["Convolution_0"] \
        == rcal.thresholds["Convolution_0"]
    for k in rcal.thresholds:
        assert abs(pcal.thresholds[k] - rcal.thresholds[k]) \
            <= 1e-5 * rcal.thresholds[k]
    assert json.loads(json.dumps(pcal.to_dict()))["sites"] == pcal.sites


def _port_cal(rcal):
    cal = quantization.Calibration.from_dict(rcal.to_dict())
    cal.batches = list(rcal.batches)
    return cal


@pytest.mark.parametrize("excluded", [(), ("Convolution_1",),
                                      ("Convolution",)])
def test_export_quantized_matches_reference_artifact(nets, tmp_path,
                                                     excluded):
    """From the reference's Calibration, the port's artifact ships the
    reference's int8 payloads and scales bitwise, recolors the same
    sites, and its predictions equal the reference predictor's bit for
    bit (the f32 parts here round alike in both packages)."""
    rn, pn, batches = nets
    rcal = ref.quantization.calibrate(rn, batches, mode="entropy")
    rpre, ppre = str(tmp_path / "r"), str(tmp_path / "p")
    ref.quantization.export_quantized(rn, rpre, rcal, excluded=excluded)
    with mt.cpu():
        quantization.export_quantized(pn, ppre, _port_cal(rcal),
                                      excluded=excluded)
        pred = deploy.load_model(ppre, quantized=True, device="cpu")
    rmeta = json.load(open(rpre + "-meta.json"))
    assert pred.meta["quantized_params"] == rmeta["quantized_params"]
    assert pred.meta["excluded"] == rmeta["excluded"]
    assert abs(pred.meta["measured_error"] - rmeta["measured_error"]) \
        <= 1e-5
    with np.load(rpre + "-params.npz") as r, \
            np.load(ppre + "-params.npz") as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            assert r[k].dtype == p[k].dtype, k
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    sites = [s["name"] for s in rcal.sites
             if s["name"] not in excluded and s["op"] not in excluded]
    assert pred.recolored_sites == sites
    want = ref.deploy.load_model(rpre, quantized=True).predict(batches[1])
    got = pred.predict(batches[1])
    np.testing.assert_array_equal(got, want)


def test_guardrail_refuses_and_writes_nothing(nets, tmp_path):
    _, pn, batches = nets
    with mt.cpu():
        cal = quantization.calibrate(pn, batches)
        prefix = str(tmp_path / "never")
        before = telemetry.counter("quantization.guardrail_rejects").value
        with pytest.raises(quantization.QuantizationError,
                           match="budget"):
            quantization.export_quantized(pn, prefix, cal,
                                          error_budget=1e-9)
    assert not any(os.path.exists(prefix + s) for s in
                   ("-symbol.json", "-meta.json", "-params.npz"))
    assert telemetry.counter("quantization.guardrail_rejects").value \
        == before + 1


def test_excluded_by_op_type_is_exactly_f32(nets, tmp_path):
    _, pn, batches = nets
    with mt.cpu():
        cal = quantization.calibrate(pn, batches)
        assert quantization.quantized_error(
            pn, cal, excluded=("Convolution", "FullyConnected")) == 0.0
        prefix = str(tmp_path / "fc_only")
        quantization.export_quantized(pn, prefix, cal,
                                      excluded=("Convolution",))
        pred = deploy.load_model(prefix, quantized=True, device="cpu")
    assert pred.recolored_sites == ["FullyConnected_2"]
    with np.load(prefix + "-params.npz") as z:
        assert z["conv0_weight"].dtype == np.float32
        assert z["dense0_weight"].dtype == np.int8


def test_quantize_model_symbol_rewrite_matches_reference():
    """The legacy entry point: thresholds from the weights and the calibration
    taps, and the rewritten graph's quantized nodes, as the reference's."""
    def graph(pkg):
        s = pkg.sym
        data = s.Variable("data")
        fc1 = s.FullyConnected(data, num_hidden=8, name="fc1")
        act = s.Activation(fc1, act_type="relu", name="relu1")
        return s.FullyConnected(act, num_hidden=4, name="fc2")

    rng = np.random.default_rng(3)
    arg = {"fc1_weight": rng.standard_normal((8, 6)).astype(np.float32),
           "fc1_bias": rng.standard_normal(8).astype(np.float32),
           "fc2_weight": rng.standard_normal((4, 8)).astype(np.float32),
           "fc2_bias": rng.standard_normal(4).astype(np.float32)}
    data = rng.standard_normal((16, 6)).astype(np.float32)
    rsym, _, _ = ref_cq.quantize_model(
        graph(ref), {k: ref.nd.array(v) for k, v in arg.items()}, {},
        calib_mode="naive", calib_data=ref.io.NDArrayIter(data,
                                                          batch_size=8),
        excluded_sym_names=("fc2",))
    with mt.cpu():
        psym, _, _ = port_cq.quantize_model(
            graph(mt), {k: mt.nd.array(v) for k, v in arg.items()}, {},
            ctx=mt.cpu(), calib_mode="naive",
            calib_data=mt.io.NDArrayIter(data, batch_size=8),
            excluded_sym_names=("fc2",))
    rnodes = json.loads(rsym.tojson())["nodes"]
    pnodes = json.loads(psym.tojson())["nodes"]
    assert [(n["name"], n["op"]) for n in pnodes] \
        == [(n["name"], n["op"]) for n in rnodes]
    q = [n for n in pnodes if n["op"] == "_contrib_quantized_fully_connected"]
    assert [n["name"] for n in q] == ["fc1"]
    rq = [n for n in rnodes if n["name"] == "fc1"][0]
    assert q[0]["attrs"]["amax_data"] == rq["attrs"]["amax_data"]
    assert q[0]["attrs"]["amax_weight"] == rq["attrs"]["amax_weight"]
    # the rewritten graph runs: int8 fc1, f32 fc2
    with mt.cpu():
        exe = psym.bind(mt.cpu(), args=dict(
            {k: mt.nd.array(v) for k, v in arg.items()},
            data=mt.nd.array(data)))
        out = exe.forward()[0].asnumpy()
    rexe = rsym.bind(ref.cpu(), args=dict(
        {k: ref.nd.array(v) for k, v in arg.items()},
        data=ref.nd.array(data)))
    np.testing.assert_allclose(out, rexe.forward()[0].asnumpy(),
                               rtol=1e-5, atol=1e-5)
