"""The port's NDArray held against the reference's, on the CPU: dtypes and
their 64-bit canonicalization, the comparison, ``%`` and ``@`` operators,
in-place operators, ``__setitem__``, negative-step slicing, f16/bf16 host
copies and files, the MAE regression head's name and the ``sum``/``lp``
pooling types.  Each case runs on both packages from the same numpy
inputs and returns a dict; every value must agree: the same dtype name
and the same numbers (exactly, except where the packages sum in their own
order: the pooling windows of O(1) inputs, and a small Dense net trained
two steps, ``rtol=atol=1e-6``, a few f32 ulps of the terms).

The first parametrised test holds one case per fault the port had against
the reference (the probe rows of the repair); the second holds the wider
forms of each repair.  The rest cover what only one package can show: x64
switched on in the port (the reference's switch flips jax's global state),
bf16 without ``ml_dtypes``, files crossing between the packages, and the
tape and ``gluon.Trainer`` reading an array written in place.
"""
import builtins
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag

PKGS = {"port": (mt, tag), "reference": (jmx, jag)}
RNG = np.random.RandomState(0)
RAND22 = RNG.rand(2, 2)
A4 = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
SIGNED = np.array([-7.5, -3.0, -1.0, 0.0, 2.0, 5.5], np.float32)
M34 = np.arange(12, dtype=np.float32).reshape(3, 4)
T234 = RNG.randn(2, 3, 4).astype(np.float32)


def _run(pkg, case):
    mx, ag = PKGS[pkg]
    if pkg == "port":
        with mt.cpu():
            return case(mx, ag)
    return case(mx, ag)


def _norm(v):
    """A result as (kind, dtype name, value) for comparison."""
    if hasattr(v, "asnumpy"):
        a = v.asnumpy()
        return ("array", a.dtype.name, np.asarray(a, np.float64)
                if a.dtype.name == "bfloat16" else a)
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.name, np.asarray(v, np.float64)
                if v.dtype.name == "bfloat16" else v)
    if isinstance(v, np.dtype):
        return ("dtype", v.name, None)
    return ("value", type(v).__name__, v)


def _agree(case, tol=0.0):
    got, want = _run("port", case), _run("reference", case)
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = _norm(got[key]), _norm(want[key])
        assert g[:2] == w[:2], (key, g[:2], w[:2])
        if g[0] in ("array", "ndarray"):
            assert g[2].shape == w[2].shape, key
            if tol:
                np.testing.assert_allclose(g[2], w[2], rtol=tol, atol=tol,
                                           err_msg=key)
            else:
                np.testing.assert_array_equal(g[2], w[2], err_msg=key)
        else:
            assert g[2] == w[2], (key, g[2], w[2])
    return got


# ------------------------------------------------------------ probe rows
def probe_array_f64_dtype(mx, ag):
    return {"dtype": mx.nd.array(RAND22).dtype}


def probe_dtype_equals_numpy(mx, ag):
    return {"eq": bool(mx.nd.array(RAND22).dtype == np.float32)}


def probe_greater_scalar(mx, ag):
    return {"out": mx.nd.array(A4) > 1}


def probe_equal_self(mx, ag):
    a = mx.nd.array(A4)
    return {"out": a == a}


def probe_iadd_alias(mx, ag):
    a = mx.nd.array(A4)
    b = a
    b += 1
    return {"a": a, "same": b is a}


def probe_setitem_full_slice(mx, ag):
    c = mx.nd.array(A4)
    c[:] = 2
    return {"c": c}


def probe_reverse_slice(mx, ag):
    return {"out": mx.nd.array(A4)[::-1]}


def probe_asnumpy_f16(mx, ag):
    return {"host": mx.nd.array(A4 / 3).astype("float16").asnumpy()}


def probe_maeregression_output(mx, ag):
    return {"out": mx.nd.maeregression_output(mx.nd.array(A4),
                                              mx.nd.array(A4[::-1].copy()))}


def probe_pooling_sum(mx, ag):
    return {"out": mx.nd.Pooling(mx.nd.ones((1, 1, 4, 4)), kernel=(2, 2),
                                 stride=(2, 2), pool_type="sum")}


def probe_mod_scalar(mx, ag):
    return {"out": mx.nd.array(A4) % 3}


PROBES = [probe_array_f64_dtype, probe_dtype_equals_numpy,
          probe_greater_scalar, probe_equal_self, probe_iadd_alias,
          probe_setitem_full_slice, probe_reverse_slice, probe_asnumpy_f16,
          probe_maeregression_output, probe_pooling_sum, probe_mod_scalar]


@pytest.mark.parametrize("case", PROBES, ids=lambda c: c.__name__[6:])
def test_probe_row_matches_reference(case):
    _agree(case)


# ------------------------------------------------------------- wider forms
def compare_ops(mx, ag):
    a, b = mx.nd.array(SIGNED), mx.nd.array(SIGNED[::-1].copy())
    out = {}
    for name, fn in (("eq", lambda x, y: x == y), ("ne", lambda x, y: x != y),
                     ("gt", lambda x, y: x > y), ("ge", lambda x, y: x >= y),
                     ("lt", lambda x, y: x < y), ("le", lambda x, y: x <= y)):
        out[name] = fn(a, b)
        out[name + "_scalar"] = fn(a, 2.0)
        out[name + "_reflected"] = fn(2.0, a)
    return out


def mod_forms(mx, ag):
    a = mx.nd.array(SIGNED)
    b = mx.nd.array(np.array([2, -3, 4, 5, -2, 3], np.float32))
    return {"arrays": a % b, "scalar": a % 3, "negative": a % -2,
            "reflected": 7 % b, "op": mx.nd.mod(a, b),
            "broadcast": mx.nd.broadcast_mod(mx.nd.array(M34),
                                             mx.nd.array([[5.0]]))}


def matmul_forms(mx, ag):
    x = mx.nd.array(M34)
    y = mx.nd.array(M34.T.copy())
    t = mx.nd.array(T234)
    u = mx.nd.array(np.ones((2, 4, 5), np.float32))
    return {"2d": x @ y, "batched": t @ u,
            "op": mx.nd.batch_dot_auto(t, u)}


def inplace_forms(mx, ag):
    a = mx.nd.array(SIGNED)
    alias = a
    a -= 1
    a *= mx.nd.array(np.full(6, 2.0, np.float32))
    a /= 4
    c = mx.nd.array(A4)
    view = c[1:3]   # a slice taken before the write keeps its values
    c += c
    return {"a": a, "alias": alias, "c": c, "view": view}


def setitem_forms(mx, ag):
    m = mx.nd.array(M34)
    m[1:, ::2] = mx.nd.array([[9.0, 8.0], [7.0, 6.0]])
    m[0] = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
    m[2, 1] = -5
    m[::-1, 3] = np.array([10.0, 20.0, 30.0], np.float32)
    m[:, 1:3] = mx.nd.array([[0.5, 0.25]])   # broadcast over rows
    i = mx.nd.array(np.arange(6).reshape(2, 3), dtype="int32")
    i[:] = np.array([7, 8, 9], np.int32)
    return {"m": m, "i": i}


def getitem_negative_steps(mx, ag):
    t = mx.nd.array(T234)
    m = mx.nd.array(M34)
    return {"rev_rows": m[::-1], "step2": m[:, ::-2], "range": m[2:0:-1, 3:0:-2],
            "int_and_rev": m[1, ::-1], "ellipsis": t[..., ::-1],
            "newaxis": t[None, ::-1, 1], "middle": t[:, ::-2, 1:3],
            "empty": m[1:3:-1]}


def dtype_forms(mx, ag):
    out = {"int64": mx.nd.array(np.arange(3)).dtype,
           "int64_asked": mx.nd.array(np.arange(3), dtype="int64").dtype,
           "list": mx.nd.array([1, 2, 3]).dtype,
           "zeros_f64": mx.nd.zeros((2,), dtype="float64").dtype,
           "ones_i64": mx.nd.ones((2,), dtype=np.int64).dtype,
           "astype_i64": mx.nd.array(A4).astype("int64").dtype,
           "f16": mx.nd.array(A4).astype("float16").dtype,
           "bf16": mx.nd.array(A4).astype("bfloat16").dtype,
           "int32": mx.nd.array(np.arange(3, dtype=np.int32)).dtype}
    out["f32_is_np"] = bool(out["list"] == np.float32)
    out["i32_is_np"] = bool(out["int64"] == np.int32)
    return out


def host_copies(mx, ag):
    a = mx.nd.array(SIGNED / 3)
    return {"f32": a.asnumpy(), "f16": a.astype("float16").asnumpy(),
            "bf16": a.astype("bfloat16").asnumpy(),
            "i32": mx.nd.array(np.arange(4), dtype="int32").asnumpy()}


def hash_forms(mx, ag):
    a, b = mx.nd.array(A4), mx.nd.array(A4)
    d = {a: "a", b: "b"}
    return {"lookup": d[a] + d[b], "member": a in {a}, "hash": hash(a) == id(a)}


def mae_gradient(mx, ag):
    data = mx.nd.array(SIGNED)
    label = mx.nd.array(np.zeros(6, np.float32) + 0.5)
    data.attach_grad()
    with ag.record():
        out = mx.nd.maeregression_output(data, label)
    out.backward()
    named = mx.nd.MAERegressionOutput(data, label)
    return {"out": out, "grad": data.grad, "named": named}


def tape_sees_inplace(mx, ag):
    x = mx.nd.array(np.array([1.0, 2.0, 3.0], np.float32))
    x.attach_grad()
    x += 1
    with ag.record():
        y = (x * x).sum()
    y.backward()
    g1 = x.grad.copy()
    x[1:] = 5.0
    with ag.record():
        y = (x * x * x).sum()
    y.backward()
    return {"g1": g1, "g2": x.grad, "x": x}


def inplace_in_record_raises(mx, ag):
    x = mx.nd.array(A4)
    x.attach_grad()
    out = {}
    for name, write in (("iadd", lambda v: v.__iadd__(1)),
                        ("setitem", lambda v: v.__setitem__(0, 1.0))):
        with ag.record():
            try:
                write(x)
                out[name] = "no error"
            except RuntimeError:
                out[name] = "RuntimeError"
    x += 1   # outside record() the same write is allowed
    out["after"] = x
    return out


WIDER = [compare_ops, mod_forms, matmul_forms, inplace_forms, setitem_forms,
         getitem_negative_steps, dtype_forms, host_copies, hash_forms,
         mae_gradient, tape_sees_inplace, inplace_in_record_raises]


@pytest.mark.parametrize("case", WIDER, ids=lambda c: c.__name__)
def test_ndarray_form_matches_reference(case):
    _agree(case)


POOLS = [("sum", (2, 2), (2, 2), (0, 0), (2, 3, 6, 7)),
         ("sum", (3, 3), (1, 2), (1, 1), (1, 2, 7, 6)),
         ("lp", (2, 2), (2, 2), (0, 0), (2, 3, 6, 7)),
         ("lp", (3, 2), (2, 1), (1, 0), (1, 2, 7, 6)),
         ("sum", (3,), (2,), (1,), (2, 3, 9)),
         ("lp", (2,), (1,), (0,), (2, 3, 9)),
         ("sum", (2, 2, 2), (1, 1, 1), (1, 0, 1), (1, 2, 4, 5, 3)),
         ("lp", (2, 2, 2), (2, 2, 2), (0, 0, 0), (1, 2, 4, 4, 4))]


@pytest.mark.parametrize("pool", POOLS, ids=lambda p: "%s-k%s-s%s-p%s" % p[:4])
def test_pooling_sum_lp_matches_reference(pool):
    pool_type, kernel, stride, pad, shape = pool
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)

    def case(mx, ag):
        return {"out": mx.nd.Pooling(mx.nd.array(x), kernel=kernel,
                                     stride=stride, pad=pad,
                                     pool_type=pool_type),
                "global": mx.nd.Pooling(mx.nd.array(x), kernel=kernel,
                                        global_pool=True,
                                        pool_type=pool_type)}
    _agree(case, tol=1e-6)


# ------------------------------------------------------------ port alone
def test_x64_switch_keeps_64_bit_dtypes():
    with mt.cpu():
        assert mt.nd.array(np.arange(3)).dtype == np.int32
        mt.config.enable_x64()
        try:
            assert mt.nd.array(np.arange(3)).dtype == np.int64
            assert mt.nd.array(RAND22).dtype == np.float64
            assert mt.nd.zeros((2,), dtype="float64").dtype == np.float64
            np.testing.assert_array_equal(mt.nd.array(RAND22).asnumpy(),
                                          RAND22)
        finally:
            mt.config.unset("numpy.enable_x64")
        assert mt.nd.array(RAND22).dtype == np.float32
    assert "numpy.enable_x64" in mt.config.describe()


@pytest.fixture
def no_ml_dtypes(monkeypatch):
    """``import ml_dtypes`` fails, as on a machine without the package."""
    real_import = builtins.__import__

    def fake_import(name, *args, **kwargs):
        if name == "ml_dtypes" or name.startswith("ml_dtypes."):
            raise ImportError("ml_dtypes hidden for this test")
        return real_import(name, *args, **kwargs)
    monkeypatch.delitem(sys.modules, "ml_dtypes", raising=False)
    monkeypatch.setattr(builtins, "__import__", fake_import)


def _bf16_values():
    return (SIGNED / 3).astype(np.float32)


@pytest.mark.parametrize("hidden", [False, True], ids=["ml_dtypes",
                                                       "no_ml_dtypes"])
def test_bf16_host_copy_and_file_round_trip(hidden, tmp_path, request):
    if hidden:
        request.getfixturevalue("no_ml_dtypes")
    with mt.cpu():
        a = mt.nd.array(_bf16_values()).astype("bfloat16")
        bits = a._data.view(torch.int16).clone()
        host = a.asnumpy()
        if hidden:
            assert a.dtype == torch.bfloat16
            assert host.dtype == np.float32
        else:
            assert a.dtype.name == "bfloat16" and host.dtype.name == "bfloat16"
        np.testing.assert_array_equal(np.asarray(host, np.float32),
                                      a._data.float().numpy())
        path = os.fspath(tmp_path / "bf16.npz")
        mt.nd.save(path, {"w": a, "h": a.astype("float16")})
        back = mt.nd.load(path)
    assert back["w"]._data.dtype == torch.bfloat16
    assert torch.equal(back["w"]._data.view(torch.int16), bits)
    assert back["h"]._data.dtype == torch.float16


@pytest.mark.parametrize("hidden", [False, True], ids=["ml_dtypes",
                                                       "no_ml_dtypes"])
def test_load_reads_reference_file(hidden, tmp_path, request):
    """A file the reference's ``nd.save`` wrote (bf16 lands as numpy's
    2-byte void) loads in the port with every dtype and bit kept."""
    path = os.fspath(tmp_path / "ref.npz")
    vals = _bf16_values()
    ref = {"bf16": jmx.nd.array(vals).astype("bfloat16"),
           "f16": jmx.nd.array(vals).astype("float16"),
           "f32": jmx.nd.array(vals),
           "i32": jmx.nd.array(np.arange(5), dtype="int32")}
    jmx.nd.save(path, ref)
    if hidden:
        request.getfixturevalue("no_ml_dtypes")
    with mt.cpu():
        got = mt.nd.load(path)
    assert sorted(got) == sorted(ref)
    want_bits = np.asarray(ref["bf16"].asnumpy()).view(np.int16)
    np.testing.assert_array_equal(
        got["bf16"]._data.view(torch.int16).numpy(), want_bits)
    for name, dt in (("f16", torch.float16), ("f32", torch.float32),
                     ("i32", torch.int32)):
        assert got[name]._data.dtype == dt
        np.testing.assert_array_equal(got[name]._data.numpy(),
                                      ref[name].asnumpy())


def test_reference_reads_port_file(tmp_path):
    """The port writes f16, f32 and int32 as they are; the reference's
    ``nd.load`` reads them back with the same dtypes and values."""
    path = os.fspath(tmp_path / "port.npz")
    vals = _bf16_values()
    with mt.cpu():
        arrs = [mt.nd.array(vals).astype("float16"), mt.nd.array(vals),
                mt.nd.array(np.arange(5), dtype="int32")]
        mt.nd.save(path, arrs)
    got = jmx.nd.load(path)
    for g, a in zip(got, arrs):
        assert g.dtype == a.dtype
        np.testing.assert_array_equal(g.asnumpy(), a.asnumpy())


def test_mae_head_registered_under_reference_names():
    from mxnet_tpu_torch.ops import registry
    op = registry.get("MAERegressionOutput")
    assert registry.get("maeregression_output") is op
    with pytest.raises(AttributeError):
        registry.get("mae_regression_output")


def _dense_steps(mx, ag, nn, gluon):
    net = nn.Dense(2, in_units=3)
    net.initialize(mx.init.One())
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    x = mx.nd.array(M34[:, :3].copy())
    w = net.weight.data()
    w[:, 1] = np.array([1.0, -1.0], np.float32)   # in place, before training
    losses = []
    for _ in range(2):
        with ag.record():
            loss = (net(x) * net(x)).sum()
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(loss)
    w += 0.25   # in place, after training
    return {"w": net.weight.data(), "b": net.bias.data(),
            "out": net(x), "loss0": losses[0], "loss1": losses[1],
            "same_handle": net.weight.data() is w}


def test_trainer_updates_see_inplace_writes():
    """``x[key] = v`` and ``+=`` on a parameter's array are what the next
    forward, backward and ``gluon.Trainer`` step read, in both packages."""
    def case(mx, ag):
        pkg = mt if mx is mt else jmx
        return _dense_steps(mx, ag, pkg.gluon.nn, pkg.gluon)
    _agree(case, tol=1e-6)
