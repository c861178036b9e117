"""The NDArray methods, ``mx.nd`` functions and ``mx.random`` samplers the
op library brings, each held against the reference's on the same inputs:
the op methods (``abs`` ... ``topk``), ``T``, ``copyto`` and
``as_in_ctx`` across contexts and into arrays, ``tolist``, ``stype`` /
``tostype``, ``wait_to_write``, the creation functions, and ``out=`` on
the update ops writing the weight and the state."""
import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu_torch as mt

import _torch_ops as T

RNG = np.random.RandomState(11)
X = (RNG.randn(3, 4) * 0.5).astype(np.float32)
POS = RNG.uniform(0.5, 1.5, (3, 4)).astype(np.float32)
IDX = np.asarray([2, 0, 1], np.float32)

# (method, receiver, positional args as ("nd", array) or values, kwargs)
METHODS = [
    ("abs", X, (), {}), ("sign", X, (), {}), ("exp", X, (), {}),
    ("log", POS, (), {}), ("sqrt", POS, (), {}), ("square", X, (), {}),
    ("relu", X, (), {}), ("sigmoid", X, (), {}), ("tanh", X, (), {}),
    ("softmax", X, (), {"axis": 0}), ("log_softmax", X, (), {}),
    ("max", X, (), {"axis": 1}), ("min", X, (), {"axis": [0, 1]}),
    ("prod", POS, (), {"axis": 0, "keepdims": True}),
    ("norm", X, (), {}), ("norm", X, (), {"ord": 1, "axis": 1}),
    ("argmax", X, (), {"axis": 1}), ("argmin", X, (), {}),
    ("argsort", X, (), {"is_ascend": False}), ("sort", X, (), {"axis": 0}),
    ("topk", X, (), {"k": 2, "ret_typ": "both"}),
    ("dot", X, (("nd", X.T.copy()),), {}),
    ("dot", X, (("nd", X),), {"transpose_b": True}),
    ("broadcast_to", X[:1], ((3, 4),), {}),
    ("broadcast_like", X[:, :1], (("nd", X),), {}),
    ("tile", X, ((2, 1),), {}), ("tile", X, (2,), {}),
    ("repeat", X, (2,), {"axis": 0}),
    ("pad", X.reshape(1, 1, 3, 4), (), {"mode": "edge",
                                        "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
    ("slice_axis", X, (1, 1, 3), {}),
    ("take", X, (("nd", IDX),), {}), ("take", X, (("nd", IDX),),
                                      {"axis": 1, "mode": "wrap"}),
    ("one_hot", IDX, (4,), {"on_value": 2.0, "off_value": -1.0}),
    ("clip", X, (-0.2, 0.3), {}),
    ("swapaxes", X, (0, 1), {}),
    ("reshape_like", X, (("nd", X.reshape(4, 3)),), {}),
]


def _call(pkg, method, recv, args, kwargs):
    a = pkg.nd.array(recv)
    args = [pkg.nd.array(v[1]) if isinstance(v, tuple) and len(v) == 2
            and v[0] == "nd" else v for v in args]
    return getattr(a, method)(*args, **kwargs)


@pytest.mark.parametrize("method,recv,args,kwargs", METHODS,
                         ids=["%s-%d" % (m[0], i)
                              for i, m in enumerate(METHODS)])
def test_ndarray_method_matches_reference(method, recv, args, kwargs):
    with mt.cpu():
        got = T._outs(_call(mt, method, recv, args, kwargs))
    want = T._outs(_call(ref, method, recv, args, kwargs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        T.assert_same(method, "value", g.asnumpy(), w.asnumpy())


def test_every_method_the_op_library_brings_exists():
    names = {m[0] for m in METHODS} | {
        "T", "copyto", "as_in_ctx", "tolist", "wait_to_write", "stype",
        "tostype"}
    assert len(names) == 39
    for n in names:
        assert hasattr(mt.nd.NDArray, n), n


def test_transpose_property_tolist_stype_and_wait_to_write():
    with mt.cpu():
        a = mt.nd.array(X)
        np.testing.assert_array_equal(a.T.asnumpy(),
                                      ref.nd.array(X).T.asnumpy())
        assert a.tolist() == ref.nd.array(X).tolist()
        assert a.stype == ref.nd.array(X).stype == "default"
        assert a.tostype("default") is a
        with pytest.raises(NotImplementedError):
            a.tostype("row_sparse")
        assert a.wait_to_write() is a


def test_copyto_and_as_in_ctx_across_contexts_and_into_arrays():
    with mt.cpu():
        a = mt.nd.array(X)
        b = a.copyto(mt.cpu())
        assert b is not a and b.context == mt.cpu()
        np.testing.assert_array_equal(b.asnumpy(), X)
        assert a.as_in_ctx(mt.cpu()) is a
        # into an array: its dtype and device, the same array returned
        dst = mt.nd.zeros((3, 4), dtype="float16")
        assert a.copyto(dst) is dst and dst.dtype == np.float16
        rdst = ref.nd.zeros((3, 4), dtype="float16")
        ref.nd.array(X).copyto(rdst)
        np.testing.assert_array_equal(dst.asnumpy(), rdst.asnumpy())
        with pytest.raises(TypeError):
            a.copyto("cpu")
        # to a context under record(): on the tape
        a.attach_grad()
        with mt.autograd.record():
            y = (a.copyto(mt.cpu()) * 3.0).sum()
        y.backward()
        np.testing.assert_array_equal(a.grad.asnumpy(), np.full_like(X, 3))
        if mt.num_gpus() == 0:
            with pytest.raises(mt.MXNetErrorNoDevice):
                a.copyto(mt.gpu(0))


# ------------------------------------------------------------ mx.nd
CREATION = [
    ("arange", (1, 7, 2), {}), ("arange", (5,), {"repeat": 2}),
    ("arange", (0.0, 1.0, 0.125), {}),
    ("eye", (3,), {}), ("eye", (3, 4, 1), {}),
    ("linspace", (0.0, 1.0, 5), {}), ("linspace", (-2.0, 3.0, 6),
                                       {"endpoint": False}),
    ("empty", ((2, 3),), {}),
]


@pytest.mark.parametrize("fn,args,kwargs", CREATION,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(CREATION)])
def test_nd_creation_matches_reference(fn, args, kwargs):
    with mt.cpu():
        got = getattr(mt.nd, fn)(*args, **kwargs)
        assert got.context == mt.cpu()
    want = getattr(ref.nd, fn)(*args, **kwargs)
    # linspace's start * (1 - t) + stop * t: XLA may fuse the two
    # products into one rounding, PyTorch rounds each (an ulp apart)
    T.assert_same(fn, "value", got.asnumpy(), want.asnumpy(),
                  exact=fn != "linspace")


def test_nd_split_stack_where_and_random():
    c = (RNG.rand(3, 4) > 0.5).astype(np.float32)
    with mt.cpu():
        parts = mt.nd.split(mt.nd.array(X), 2, axis=1)
        sq = mt.nd.split(mt.nd.array(X), 3, axis=0, squeeze_axis=True)
        st = mt.nd.stack(mt.nd.array(X), mt.nd.array(POS), axis=1)
        wh = mt.nd.where(mt.nd.array(c), mt.nd.array(X), mt.nd.array(POS))
        assert mt.nd.random is mt.random
    rparts = ref.nd.split(ref.nd.array(X), 2, axis=1)
    rsq = ref.nd.split(ref.nd.array(X), 3, axis=0, squeeze_axis=True)
    for g, w in zip(list(parts) + list(sq), list(rparts) + list(rsq)):
        T.assert_same("split", "part", g.asnumpy(), w.asnumpy(), exact=True)
    T.assert_same("stack", "value", st.asnumpy(),
                  ref.nd.stack(ref.nd.array(X), ref.nd.array(POS),
                               axis=1).asnumpy(), exact=True)
    T.assert_same("where", "value", wh.asnumpy(),
                  ref.nd.where(ref.nd.array(c), ref.nd.array(X),
                               ref.nd.array(POS)).asnumpy(), exact=True)


# ------------------------------------------------------------ mx.random
N = 20000
SAMPLERS = [
    ("uniform", (-1.0, 3.0, (N,)), {}),
    ("normal", (1.0, 2.0, (N,)), {}),
    ("randn", (100, 200), {"loc": 1.0, "scale": 0.5}),
    ("randint", (-3, 9, (N,)), {}),
    ("randint", (7,), {"shape": (N,)}),
    ("exponential", (2.0, (N,)), {}),
    ("gamma", (2.5, 0.5, (N,)), {}),
    ("poisson", (4.0, (N,)), {}),
    ("negative_binomial", (3, 0.4, (N,)), {}),
    ("generalized_negative_binomial", (2.0, 0.5, (N,)), {}),
]


@pytest.mark.parametrize("fn,args,kwargs", SAMPLERS,
                         ids=["%s-%d" % (s[0], i)
                              for i, s in enumerate(SAMPLERS)])
def test_random_sampler_matches_reference(fn, args, kwargs):
    """Shape, dtype, and mean and variance within 6 standard errors of
    the reference's at fixed seeds; the same seed gives the same draw."""
    with mt.cpu():
        mt.random.seed(4)
        got = getattr(mt.random, fn)(*args, **kwargs)
        assert got.context == mt.cpu()
        mt.random.seed(4)
        again = getattr(mt.random, fn)(*args, **kwargs)
    ref.random.seed(4)
    want = getattr(ref.random, fn)(*args, **kwargs)
    g, w = got.asnumpy(), want.asnumpy()
    np.testing.assert_array_equal(g, again.asnumpy())
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    g, w = g.reshape(-1).astype(np.float64), w.reshape(-1).astype(np.float64)
    se = np.hypot(g.std(), w.std()) / np.sqrt(g.size)
    assert abs(g.mean() - w.mean()) <= 6 * se
    m4 = max(((g - g.mean()) ** 4).mean(), ((w - w.mean()) ** 4).mean())
    assert abs(g.var() - w.var()) <= 6 * np.sqrt(2 * m4 / g.size)


def test_random_multinomial_and_seed_keys():
    probs = np.asarray([[0.2, 0.8], [0.9, 0.1]], np.float32)
    with mt.cpu():
        mt.random.seed(1)
        got = mt.random.multinomial(mt.nd.array(probs), shape=N).asnumpy()
        one = mt.random.multinomial(mt.nd.array(probs)).asnumpy()
        k1, k2 = mt.random.new_eager_seed_key(), \
            mt.random.new_eager_seed_key()
    ref.random.seed(1)
    want = ref.random.multinomial(ref.nd.array(probs), shape=N).asnumpy()
    rone = ref.random.multinomial(ref.nd.array(probs)).asnumpy()
    assert got.shape == want.shape == (2, N) and got.dtype == want.dtype
    assert one.shape == rone.shape and one.dtype == rone.dtype
    np.testing.assert_allclose(got.mean(axis=1), want.mean(axis=1),
                               atol=6 * np.sqrt(0.25 / N) * np.sqrt(2))
    assert k1.initial_seed() != k2.initial_seed()


def test_every_sampler_the_reference_has_exists():
    for n in ("uniform", "normal", "randn", "randint", "multinomial",
              "exponential", "gamma", "poisson", "negative_binomial",
              "generalized_negative_binomial", "new_eager_seed_key"):
        assert callable(getattr(mt.random, n)), n
    for n in ("arange", "empty", "eye", "linspace", "split", "stack",
              "where", "random"):
        assert hasattr(mt.nd, n), n


def test_update_op_out_writes_the_weight_and_the_state():
    """``mx.nd.sgd_mom_update(w, g, m, out=[w, m])``: the reference's
    functional op, its results written into the caller's arrays."""
    rng = np.random.RandomState(2)
    w, g, m = (rng.randn(5).astype(np.float32) for _ in range(3))
    with mt.cpu():
        pw, pg, pm = mt.nd.array(w), mt.nd.array(g), mt.nd.array(m)
        res = mt.nd.sgd_mom_update(pw, pg, pm, out=[pw, pm], lr=0.1,
                                   momentum=0.9, wd=0.01)
        assert res[0] is pw and res[1] is pm
        aw, ag, am, av = (mt.nd.array(v) for v in (w, g, m, np.abs(m)))
        mt.nd.adam_update(aw, ag, am, av, out=[aw, am, av], lr=0.01)
    rw, rg, rm = ref.nd.array(w), ref.nd.array(g), ref.nd.array(m)
    ref.nd.sgd_mom_update(rw, rg, rm, out=[rw, rm], lr=0.1, momentum=0.9,
                          wd=0.01)
    bw, bg, bm, bv = (ref.nd.array(v) for v in (w, g, m, np.abs(m)))
    ref.nd.adam_update(bw, bg, bm, bv, out=[bw, bm, bv], lr=0.01)
    for got, want in ((pw, rw), (pm, rm), (aw, bw), (am, bm), (av, bv)):
        T.assert_same("update out=", "value", got.asnumpy(),
                      want.asnumpy())
    assert not np.array_equal(pw.asnumpy(), w)
