"""API faults of the port repaired against the reference, on the CPU.

Each case runs both packages from the same numpy inputs:

* the optimizers on NDArrays: ``create_state``,
  ``create_state_multi_precision``, ``update`` and
  ``update_multi_precision`` take NDArrays, return NDArray state and write
  the new values into the NDArrays, as the reference's do; SGD (momentum
  0.9) and Adam over three updates, held bitwise (weight, master and
  state), as the port's tensor-route tests are, except an f16 weight
  updated without a master (F16_RTOL);
* ``backward()`` from a head recorded inside ``autograd.record()`` whose
  inputs were none of them attached returns and leaves every grad as it
  was; a head computed outside ``record()`` raises in both;
* ``Initializer`` is callable (``init(desc, arr)``, ``init.init``), has
  ``dumps`` and ``__eq__``, honours an ``InitDesc``'s ``__init__``
  attribute, and ``sym.Variable(init=...)`` stores that attribute, which
  ``Module.init_params`` honours; deterministic initializers bitwise,
  random ones (the packages' streams differ) by shape, dtype and range;
* the aliases ``mx.kv`` and ``mx.NDArray``.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt


@pytest.fixture(autouse=True)
def _cpu_and_streams():
    """The port on the CPU; both packages' global random streams left as
    each test found them (the initializer cases draw from them, and other
    files' tests initialize from the streams' state)."""
    from mxnet_tpu import random as jrandom
    from mxnet_tpu_torch import random as trandom
    saved = (jrandom._STATE.key, jrandom._STATE.counter,
             trandom._STATE.seed_val, trandom._STATE.counter)
    with mt.cpu():
        yield
    (jrandom._STATE.key, jrandom._STATE.counter, trandom._STATE.seed_val,
     trandom._STATE.counter) = saved


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


# An f16 weight updated in f16 (no master): PyTorch rounds each op of a
# step to f16, the reference's XLA rounds once at the end of a fused
# expression, so each step's few ops differ by a few f16 roundings (2^-11
# relative each) of the tensor's largest term, compounding over the three
# steps through the state; measured at most 1.3e-3 of the tensor's
# largest |value| (SGD and Adam).  A wrong lr, wd or state moves entries
# by O(1) of their size.
F16_RTOL = 2.0 ** -8


def _bits(a):
    """An NDArray of either package as f32 bit patterns (f16 widens
    exactly)."""
    return np.asarray(a.asnumpy(), np.float32).view(np.uint32)


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [x for s in state for x in _leaves(s)]
    return [state]


# ------------------------------------------------------------ optimizers
def _scheduler(lib):
    return {"lr_scheduler": lib.lr_scheduler.FactorScheduler(step=1,
                                                             factor=0.9)}


# name -> (optimizer kwargs of a package, weight dtype, multi_precision)
_OPT_CASES = {
    "plain": (lambda lib: {}, "float32", False),
    "wd-clip-rescale": (lambda lib: {"wd": 0.01, "clip_gradient": 0.05,
                                     "rescale_grad": 0.5}, "float32", False),
    "scheduler": (_scheduler, "float32", False),
    "lr-wd-mult": (lambda lib: {"wd": 0.01,
                                "param_idx2name": {0: "fc_weight"}},
                   "float32", False),
    "f16": (lambda lib: {"wd": 0.01}, "float16", False),
    "f16-multi-precision": (lambda lib: {"wd": 0.01,
                                         "multi_precision": True},
                            "float16", True),
}


def _make(lib, name, case):
    kwargs, _, _ = _OPT_CASES[case]
    kw = dict(kwargs(lib), learning_rate=0.1)
    if name == "sgd":
        kw["momentum"] = 0.9
    opt = lib.optimizer.create(name, **kw)
    if case == "lr-wd-mult":
        opt.set_lr_mult({"fc_weight": 0.5})
        opt.set_wd_mult({"fc_weight": 2.0})
    return opt


@pytest.mark.parametrize("tier", [False, True], ids=["tier-off", "tier-on"])
@pytest.mark.parametrize("case", list(_OPT_CASES))
@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizer_updates_ndarrays_as_the_reference(name, case, tier):
    """Three updates of one weight from the same NDArrays: the port's
    state is NDArrays like the reference's, and the weight and every
    state array equal the reference's bit for bit after each update (an
    f16 weight without a master within F16_RTOL).
    Tier on, the f16 multi-precision update takes each package's fused
    step (the port's plain K1/K3 version, the reference's Pallas kernel
    in interpret mode)."""
    _, dtype, mp = _OPT_CASES[case]
    rng = np.random.RandomState(5)
    w0 = (rng.randn(7, 5) * 0.5).astype(np.float32)
    grads = [rng.randn(7, 5).astype(np.float32) for _ in range(3)]
    jo, to = _make(jmx, name, case), _make(mt, name, case)
    jw = jmx.nd.array(w0, dtype=dtype)
    tw = mt.nd.array(w0, dtype=dtype)
    create = "create_state_multi_precision" if mp else "create_state"
    jstate = getattr(jo, create)(0, jw)
    tstate = getattr(to, create)(0, tw)
    assert len(_leaves(tstate)) == len(_leaves(jstate))
    for t, j in zip(_leaves(tstate), _leaves(jstate)):
        assert isinstance(t, mt.nd.NDArray)
        assert t.dtype == j.dtype and t.shape == j.shape
    update = "update_multi_precision" if mp else "update"
    with _Tier(tier):
        for g in grads:
            getattr(jo, update)(0, jw, jmx.nd.array(g, dtype=dtype), jstate)
            getattr(to, update)(0, tw, mt.nd.array(g, dtype=dtype), tstate)
            assert tw.dtype == jw.dtype
            for t, j in zip([tw] + _leaves(tstate), [jw] + _leaves(jstate)):
                if dtype == "float16" and not mp:
                    t, j = t.asnumpy(), j.asnumpy()
                    assert np.abs(t.astype(np.float64) - j).max() <= \
                        F16_RTOL * np.abs(j.astype(np.float64)).max()
                else:
                    np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizer_ndarray_lists_match_per_index_updates(name):
    """``update`` and ``update_multi_precision`` over lists of NDArrays
    (MXNet's aggregated update) give the reference's per-index results
    bit for bit, and each NDArray takes its new value."""
    rng = np.random.RandomState(6)
    ws = [(rng.randn(4, 3) * 0.5).astype(np.float32) for _ in range(3)]
    gs = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    jo, to = _make(jmx, name, "plain"), _make(mt, name, "plain")
    jw = [jmx.nd.array(w) for w in ws]
    tw = [mt.nd.array(w) for w in ws]
    jst = [jo.create_state(i, w) for i, w in enumerate(jw)]
    tst = [to.create_state(i, w) for i, w in enumerate(tw)]
    for i in range(3):
        jo.update(i, jw[i], jmx.nd.array(gs[i]), jst[i])
    to.update([0, 1, 2], tw, [mt.nd.array(g) for g in gs], tst)
    for t, j in zip(tw, jw):
        np.testing.assert_array_equal(_bits(t), _bits(j))
    for i in range(3):
        jo.update_multi_precision(i, jw[i], jmx.nd.array(gs[i]), jst[i])
    to.update_multi_precision([0, 1, 2], tw, [mt.nd.array(g) for g in gs],
                              tst)
    for t, j in zip(tw + _leaves(tst), jw + _leaves(jst)):
        np.testing.assert_array_equal(_bits(t), _bits(j))


# -------------------------------------------------------------- autograd
def _record_head(lib, ctx_kw):
    """A head recorded from arrays none of which is attached, beside an
    attached array whose grad holds 7s."""
    x = lib.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), **ctx_kw)
    w = lib.nd.array(np.ones((2, 3), np.float32), **ctx_kw)
    w.attach_grad()
    w.grad[:] = 7.0
    with lib.autograd.record():
        y = (x * 2 + 1).sum()
    return y, w


@pytest.mark.parametrize("lib", ["reference", "port"])
def test_backward_on_a_head_with_no_attached_variable_returns(lib):
    pkg, kw = (jmx, {}) if lib == "reference" else (mt, {"ctx": mt.cpu()})
    y, w = _record_head(pkg, kw)
    y.backward()
    np.testing.assert_array_equal(w.grad.asnumpy(), np.full((2, 3), 7.0))
    assert float(y.asnumpy()) == 36.0


def _batchnorm_head(lib):
    """``BatchNorm(center=False, scale=False)`` on a plain input under
    ``record()``: no array of it is attached."""
    x = lib.nd.array(np.random.RandomState(2).rand(4, 3).astype(np.float32))
    net = lib.gluon.nn.BatchNorm(center=False, scale=False, in_channels=3)
    net.initialize()
    with lib.autograd.record():
        y = net(x)
    y.backward()
    return y.asnumpy(), {n: p.data().asnumpy()
                         for n, p in net.collect_params().items()}


def test_backward_through_batchnorm_without_attached_variables():
    """Both packages return from ``backward()`` and agree on the output
    and the moving statistics the training-mode forward folded in."""
    jy, jparams = _batchnorm_head(jmx)
    ty, tparams = _batchnorm_head(mt)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-6)
    strip = {n.split("_", 1)[1]: v for n, v in jparams.items()}
    for n, v in tparams.items():
        np.testing.assert_allclose(v, strip[n.split("_", 1)[1]], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("lib", ["reference", "port"])
def test_backward_on_a_head_computed_outside_record_raises(lib):
    pkg = jmx if lib == "reference" else mt
    x = pkg.nd.array([1.0, 2.0])
    x.attach_grad()
    y = x * x
    with pytest.raises(ValueError, match="record"):
        y.backward()


# ----------------------------------------------------------- initializers
_DETERMINISTIC = [
    ("zero", "fc_weight"), ("one", "fc_weight"), ("xavier", "bn_gamma"),
    ("uniform", "bn_beta"), ("normal", "fc_bias"),
    ("xavier", "bn_running_mean"), ("uniform", "bn_moving_var")]


@pytest.mark.parametrize("init,name", _DETERMINISTIC,
                         ids=["%s-%s" % c for c in _DETERMINISTIC])
@pytest.mark.parametrize("call", ["__call__", "init"])
def test_initializer_call_is_bitwise_where_deterministic(init, name, call):
    """``init(desc, arr)`` sets ``arr``: Zero and One everywhere, and any
    initializer on the names it sets by rule (gamma and running_var /
    moving_var to ones, beta, bias and running_mean to zeros)."""
    ja = jmx.nd.array(np.full((4, 3), 5.0, np.float32))
    ta = mt.nd.array(np.full((4, 3), 5.0, np.float32))
    getattr(jmx.init.create(init), call)(jmx.init.InitDesc(name), ja)
    getattr(mt.init.create(init), call)(mt.init.InitDesc(name), ta)
    assert ta.dtype == ja.dtype and ta.shape == ja.shape
    np.testing.assert_array_equal(_bits(ta), _bits(ja))


@pytest.mark.parametrize("init,bound", [
    (lambda lib: lib.init.Uniform(0.2), 0.2),
    (lambda lib: lib.init.Normal(0.5), None),
    (lambda lib: lib.init.Xavier(magnitude=2), (2 / ((16 + 8) / 2)) ** 0.5),
], ids=["uniform", "normal", "xavier"])
def test_random_initializer_call_by_shape_dtype_and_range(init, bound):
    """The packages draw from different streams: a random initializer is
    held by the shape, dtype and range of what it writes, and it writes
    something other than the array's old value."""
    for lib in (jmx, mt):
        arr = lib.nd.array(np.zeros((8, 16), np.float16), dtype="float16")
        init(lib)(lib.init.InitDesc("fc_weight"), arr)
        got = arr.asnumpy()
        assert got.shape == (8, 16) and got.dtype == np.float16
        assert np.isfinite(got).all() and np.abs(got).max() > 0
        if bound is not None:
            assert np.abs(got.astype(np.float32)).max() <= bound * (1 + 2e-3)


def test_initializer_dumps_and_eq_match_the_reference():
    for make in (lambda lib: lib.init.Xavier(factor_type="in", magnitude=2),
                 lambda lib: lib.init.Uniform(0.3),
                 lambda lib: lib.init.One()):
        assert json.loads(make(mt).dumps()) == json.loads(make(jmx).dumps())
        assert make(mt) == make(mt)
    assert mt.init.Xavier() != mt.init.Xavier(magnitude=2)
    assert mt.init.Uniform(0.07) != mt.init.Normal(0.07)
    assert mt.init.Zero() != "zero"


@pytest.mark.parametrize("lib", ["reference", "port"])
def test_initdesc_init_attribute_takes_precedence(lib):
    """An ``InitDesc`` whose attrs carry ``__init__`` is set by that
    initializer; the caller becomes its ``global_init``."""
    pkg = jmx if lib == "reference" else mt
    desc = pkg.init.InitDesc("fc_weight",
                             {"__init__": pkg.init.One().dumps()})
    arr = pkg.nd.array(np.full((2, 2), 3.0, np.float32))
    outer = pkg.init.Zero()
    outer(desc, arr)
    np.testing.assert_array_equal(arr.asnumpy(), np.ones((2, 2)))
    assert desc.global_init is outer
    with pytest.raises(TypeError):
        outer(3, arr)


def _fc_module(lib):
    data = lib.sym.Variable("data")
    w = lib.sym.Variable("fc_weight", init=lib.init.One())
    fc = lib.sym.FullyConnected(data, weight=w, num_hidden=4, name="fc")
    mod = lib.mod.Module(fc, data_names=["data"], label_names=None)
    mod.bind(data_shapes=[("data", (2, 3))])
    mod.init_params(lib.init.Zero())
    return fc, {n: v.asnumpy() for n, v in mod.get_params()[0].items()}


def test_variable_init_is_honoured_by_module_init_params():
    """``sym.Variable(init=One())`` stores the initializer's dumps in its
    ``__init__`` attr, and ``Module.init_params(Zero())`` gives that
    variable ones and the others zeros, in both packages alike."""
    jsym, jparams = _fc_module(jmx)
    tsym, tparams = _fc_module(mt)
    assert (tsym.attr_dict()["fc_weight"]["__init__"]
            == jsym.attr_dict()["fc_weight"]["__init__"])
    assert tparams.keys() == jparams.keys()
    for n in jparams:
        np.testing.assert_array_equal(tparams[n], jparams[n])
    np.testing.assert_array_equal(tparams["fc_weight"], np.ones((4, 3)))
    np.testing.assert_array_equal(tparams["fc_bias"], np.zeros(4))


# ---------------------------------------------------------------- aliases
def test_kv_and_ndarray_aliases():
    assert mt.kv is mt.kvstore and jmx.kv is jmx.kvstore
    assert mt.NDArray is mt.nd.NDArray
    assert isinstance(mt.nd.array([1.0]), mt.NDArray)
    assert isinstance(jmx.nd.array([1.0]), jmx.NDArray)
    kv = mt.kv.create("local")
    assert kv.type == jmx.kv.create("local").type
