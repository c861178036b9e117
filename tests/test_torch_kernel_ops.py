"""The port's registered kernel ops held against the reference's, on the
CPU: ``pallas_softmax`` (K5 forward and backward), ``pallas_scale_bias_
relu`` (K6) and ``pallas_flash_attention`` (K2f, K2dq, K2dkv).  The
port runs each kernel's plain version (CPU tensors); the reference runs
its Pallas kernels in interpret mode, as its own tests do.  Inputs are
made with numpy from a seed and handed to both.

Tolerances:

* K5 f32: ``rtol=atol=1e-6``, as the reference's own check
  (``tests/test_rtc_pallas.py:21``): both compute exp(x - m) / l in f32
  with sums taken in another order.  The input gradient through both
  tapes (f32 and bf16): per row, max |port - reference| <= the dtype's
  tolerance x the row's largest term ``y * (|dy| + |sum(dy * y)|)``
  (dx = y (dy - dot) cancels where a row saturates, so its own size is
  no scale; the bf16 reference rounds y, the dot and the difference).
* K5 bf16: per row, max |port - reference| <= 2^-5 x the row's largest
  |reference|.  The reference rounds to bf16 at points of its own
  (measured within 2^-7 of an f32-accurate softmax a row); the port is
  f32-accurate and rounds once.  The saved row max and sum come out in
  x's dtype in both, and the row max is equal (the max of bf16 values is
  one of them).
* K6: bitwise, NaN and -0.0 included (a NaN equals a NaN whatever its
  payload bits).
* flash attention: per tensor, max |port - reference| <= 1e-5 x its
  largest |reference| (``test_torch_training.py``'s GRAD_RTOL).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.ops import pallas_kernels as jpk

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops import registry as treg

F32_TOL = 1e-6
BF16_ROW_TOL = 2.0 ** -5
GRAD_TERM_TOL = 1e-6
FLASH_RTOL = 1e-5
SOFTMAX_SHAPES = [(3, 8), (4, 8, 16), (32, 64), (5, 1000)]


def _np(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


def _pair(x, dtype):
    """The same values as a port tensor and a reference array."""
    t = torch.from_numpy(x.astype(np.float32))
    j = jnp.asarray(x.astype(np.float32))
    if dtype == "bfloat16":
        return t.bfloat16(), j.astype(jnp.bfloat16)
    return t, j


def _row_err(a, b, scale=None):
    a = np.asarray(a, np.float64).reshape(-1, a.shape[-1])
    b = np.asarray(b, np.float64).reshape(-1, b.shape[-1])
    s = np.abs(b) if scale is None else np.abs(
        np.asarray(scale, np.float64).reshape(b.shape))
    return float((np.abs(a - b).max(-1) / np.maximum(s.max(-1), 1e-30))
                 .max())


def _f32(j):
    return np.asarray(j.astype(jnp.float32))


# --------------------------------------------------------------- K5
@pytest.mark.parametrize("shape", SOFTMAX_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_softmax_plain_matches_reference(shape, dtype):
    x = np.random.RandomState(0).randn(*shape) * 3
    t, j = _pair(x, dtype)
    tflat = t.reshape(-1, shape[-1])
    y, m, l = ck.row_softmax_plain(tflat)
    jy, jm, jl = jpk._softmax_fwd_call(j.reshape(-1, shape[-1]))
    assert y.dtype == m.dtype == l.dtype == t.dtype
    assert jm.dtype == jl.dtype == j.dtype
    assert tuple(m.shape) == tuple(jm.shape) == (tflat.shape[0], 1)
    np.testing.assert_array_equal(m.float().numpy(), _f32(jm))
    if dtype == "float32":
        for ours, theirs in ((y, jy), (l, jl)):
            np.testing.assert_allclose(ours.numpy(), _f32(theirs),
                                       rtol=F32_TOL, atol=F32_TOL)
    else:
        assert _row_err(y.float().numpy(), _f32(jy)) <= BF16_ROW_TOL
        assert _row_err(l.float().numpy(), _f32(jl)) <= BF16_ROW_TOL
    # the registered op (any leading shape) is the same function
    op = mt.nd.pallas_softmax(mt.nd.NDArray(t, ctx=mt.cpu()))
    np.testing.assert_array_equal(op.asnumpy(),
                                  y.float().reshape(shape).numpy())


@pytest.mark.parametrize("shape", SOFTMAX_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_softmax_grad_through_both_tapes(shape, dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape) * 3
    c = rng.randn(*shape)
    t, j = _pair(x, dtype)
    tc, jc = _pair(c, dtype)
    with mt.cpu():
        tx = mt.nd.NDArray(t)
        tx.attach_grad()
        with tag.record():
            tloss = (mt.nd.pallas_softmax(tx) * mt.nd.NDArray(tc)).sum()
        tloss.backward()
        tg = tx.grad.asnumpy()
    jx = jmx.nd.array(j)
    jx.attach_grad()
    with jag.record():
        jloss = (jmx.nd.pallas_softmax(jx) * jmx.nd.array(jc)).sum()
    jloss.backward()
    jg = _f32(jx.grad._data)
    assert tx.grad._data.dtype == t.dtype
    xs, cs = t.double().numpy(), tc.double().numpy()
    y = np.exp(xs - xs.max(-1, keepdims=True))
    y /= y.sum(-1, keepdims=True)
    terms = y * (np.abs(cs) + np.abs((cs * y).sum(-1, keepdims=True)))
    tol = GRAD_TERM_TOL if dtype == "float32" else BF16_ROW_TOL
    assert _row_err(tg, jg, terms) <= tol


def test_row_softmax_backward_plain_is_the_formula():
    """The plain backward is y (dy - sum(dy y)) from the saved m and l."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(6, 40).astype(np.float32))
    dy = torch.from_numpy(rng.randn(6, 40).astype(np.float32))
    y, m, l = ck.row_softmax_plain(x)
    dx = ck.row_softmax_bwd_plain(x, m, l, dy)
    yd = torch.softmax(x.double(), -1)
    want = yd * (dy.double() - (dy.double() * yd).sum(-1, keepdim=True))
    np.testing.assert_allclose(dx.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_row_softmax_wrappers_check_what_the_kernels_take():
    x = torch.zeros(4, 8)
    assert ck.row_softmax_unsupported_reason(x) is None
    assert "rank" in ck.row_softmax_unsupported_reason(torch.zeros(2, 3, 4))
    assert "f32, bf16 or f16" in ck.row_softmax_unsupported_reason(
        torch.zeros(4, 8, dtype=torch.float64))
    m = torch.zeros(4, 1)
    assert ck.row_softmax_bwd_unsupported_reason(x, m, m, x) is None
    assert "m must be" in ck.row_softmax_bwd_unsupported_reason(
        x, torch.zeros(4), m, x)
    assert "dy must be" in ck.row_softmax_bwd_unsupported_reason(
        x, m, m, x.bfloat16())
    meta = torch.zeros(4, 8, dtype=torch.float64, device="meta")
    with pytest.raises(mt.KernelUnsupportedError):
        ck.row_softmax(meta)
    with pytest.raises(mt.KernelUnsupportedError):
        ck.scale_bias_relu(meta, meta[0], meta[0])


# --------------------------------------------------------------- K6
def _sbr_inputs(dtype, n=48, d=200, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    x.reshape(-1)[::37] = np.nan
    x.reshape(-1)[5::41] = -0.0
    x.reshape(-1)[7::53] = 0.0
    s = rng.randn(d).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    b[::9] = -0.0
    b[1::9] = 0.0
    return [_pair(v, dtype) for v in (x, s, b)]


def _same_bits(a, b):
    """Equal bit for bit, a NaN equal to any NaN."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    nan = np.isnan(a) & np.isnan(b)
    return int(((a.view(np.int32) != b.view(np.int32)) & ~nan).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_bias_relu_plain_is_bitwise_the_reference(dtype):
    (tx, jx), (ts, js), (tb, jb) = _sbr_inputs(dtype)
    ours = ck.scale_bias_relu_plain(tx, ts, tb)
    theirs = jmx.nd.pallas_scale_bias_relu(jmx.nd.array(jx),
                                           jmx.nd.array(js),
                                           jmx.nd.array(jb))
    assert ours.dtype == tx.dtype
    assert _same_bits(ours.float().numpy(), _f32(theirs._data)) == 0
    out = ours.float().numpy()
    assert np.isnan(out).sum() == np.isnan(tx.float().numpy()).sum()
    assert not np.signbit(out[~np.isnan(out)]).any()   # no -0
    with mt.cpu():
        op = mt.nd.pallas_scale_bias_relu(mt.nd.NDArray(tx),
                                          mt.nd.NDArray(ts),
                                          mt.nd.NDArray(tb))
    assert _same_bits(op.asnumpy(), out) == 0


def test_scale_bias_relu_f32_is_one_fma():
    """The f32 kernel rounds x*s+b once: the plain version equals the
    f64 product and sum rounded to f32, where a separate multiply and
    add differs."""
    rng = np.random.RandomState(4)
    x = rng.randn(64, 256).astype(np.float32)
    s = rng.randn(256).astype(np.float32)
    b = rng.randn(256).astype(np.float32)
    got = ck.scale_bias_relu_plain(torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(b)).numpy()
    fma = np.maximum((x.astype(np.float64) * s + b).astype(np.float32), 0)
    two = np.maximum(x * s + b, 0)
    assert _same_bits(got, fma) == 0
    assert _same_bits(got, two) > 0


def test_scale_bias_relu_is_not_taped_in_either_package():
    (tx, jx), (ts, js), (tb, jb) = _sbr_inputs("float32", n=4, d=8)
    with mt.cpu():
        x = mt.nd.NDArray(tx.nan_to_num())
        x.attach_grad()
        with tag.record():
            y = mt.nd.pallas_scale_bias_relu(x, mt.nd.NDArray(ts),
                                             mt.nd.NDArray(tb))
            z = (y + x).sum()
        assert not y._on_tape and not y._data.requires_grad
        with pytest.raises(ValueError):
            y.backward()
        z.backward()
        tg = x.grad.asnumpy()
    jxa = jmx.nd.array(jnp.nan_to_num(jx))
    jxa.attach_grad()
    with jag.record():
        jy = jmx.nd.pallas_scale_bias_relu(jxa, jmx.nd.array(js),
                                           jmx.nd.array(jb))
        jz = (jy + jxa).sum()
    with pytest.raises(ValueError):
        jy.backward()
    jz.backward()
    np.testing.assert_array_equal(tg, jxa.grad.asnumpy())
    np.testing.assert_array_equal(tg, np.ones((4, 8), np.float32))


def test_kernel_ops_are_registered_in_both_packages():
    from mxnet_tpu.ops import registry as jreg
    for name, diff in (("pallas_softmax", True),
                       ("pallas_scale_bias_relu", False),
                       ("pallas_flash_attention", True)):
        assert treg.get(name).differentiable == diff
        assert jreg.get(name).differentiable == diff
        assert callable(getattr(mt.nd, name))
        assert callable(getattr(jmx.nd, name))


# --------------------------------------------------------------- flash
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_op_forward_and_grads_match_reference(causal):
    rng = np.random.RandomState(5)
    B, H, S, D = 1, 2, 128, 64
    q, k, v, do = (rng.randn(B, H, S, D).astype(np.float32)
                   for _ in range(4))
    with mt.cpu():
        targs = [mt.nd.array(a) for a in (q, k, v)]
        for a in targs:
            a.attach_grad()
        with tag.record():
            to = mt.nd.pallas_flash_attention(*targs, causal=causal)
        to.backward(mt.nd.array(do))
    jargs = [jmx.nd.array(a) for a in (q, k, v)]
    for a in jargs:
        a.attach_grad()
    with jag.record():
        jo = jmx.nd.pallas_flash_attention(*jargs, causal=causal)
    jo.backward(jmx.nd.array(do))
    pairs = [("o", to, jo)] + [("d" + n, t.grad, j.grad) for n, t, j in
                               zip("qkv", targs, jargs)]
    for name, t, j in pairs:
        want = j.asnumpy()
        err = np.abs(t.asnumpy() - want).max()
        assert err <= FLASH_RTOL * np.abs(want).max(), (name, err)
