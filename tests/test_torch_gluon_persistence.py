"""Block and ParameterDict persistence, the hooks, ``apply`` and
``zero_grad``, the initializers this slice ports, ``gluon.utils`` and
``model_store``, held against the reference on the CPU
(``tests/test_torch_gluon_export.py`` holds ``summary``, ``export`` and
``SymbolBlock``).  Parameter files are the reference's npz container in
both packages: a file either writes loads in the other bit for bit."""
import os

import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu.gluon.model_zoo.model_store as ref_store
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.gluon.model_zoo.model_store as mt_store

import _torch_gluon as G


def _small(p):
    """A small net of every parameter kind: conv, BatchNorm (aux), dense."""
    net = p.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(p.gluon.nn.Conv2D(4, 3, padding=1),
                p.gluon.nn.BatchNorm(),
                p.gluon.nn.Activation("relu"),
                p.gluon.nn.MaxPool2D(2),
                p.gluon.nn.Dense(3))
    return net


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(make=_small, shape=(2, 3, 8, 8)):
    """Both packages' nets from the reference's values, deferred shapes
    resolved."""
    rb, pb = G.build(make)
    G.run(G.ref, rb, [_x(*shape)], None, training=False, grads=False)
    G.carry(rb, pb)
    G.run(mt, pb, [_x(*shape)], None, training=False, grads=False)
    return rb, pb


def _values(block):
    return {n: p.data().asnumpy() for n, p in
            block._collect_params_with_prefix().items()}


def _keys(fname):
    with mt.cpu():
        return set(mt.nd.load(fname))


def _same(a, b):
    assert set(a) == set(b)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_save_parameters_loads_across_packages_bitwise(tmp_path,
                                                       direction):
    rb, pb = _pair()
    src, dst = (pb, rb) if direction == "port-to-ref" else (rb, pb)
    # move the destination's values away first
    with mt.cpu():
        for p in list(rb.collect_params().values()) + list(
                pb.collect_params().values()):
            p.set_data(p.data() * 0 + 7)
        G.run(G.ref, rb, [_x(2, 3, 8, 8)], None, grads=False)
    src_vals = _values(src)
    fname = str(tmp_path / "net.params")
    src.save_parameters(fname)
    with mt.cpu():
        dst.load_parameters(fname)
    _same(_values(dst), src_vals)
    keys = _keys(fname)
    assert keys == set(src_vals) and all("." in k for k in keys)


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_legacy_params_files_load_across_packages(tmp_path, direction):
    """``save_params`` (collect_params().save with the prefix stripped):
    keys without a '.', read by load_parameters' legacy branch."""
    rb, pb = _pair()
    src, dst = (pb, rb) if direction == "port-to-ref" else (rb, pb)
    fname = str(tmp_path / "legacy.params")
    with pytest.warns(UserWarning):
        src.save_params(fname)
    assert not any("." in k for k in _keys(fname))
    with mt.cpu():
        for p in dst.collect_params().values():
            p.set_data(p.data() * 0 + 3)
        with pytest.warns(UserWarning):
            dst.load_params(fname)
    _same(_values(dst), _values(src))


def test_load_parameters_checks_names_and_dtypes(tmp_path):
    rb, pb = _pair()
    fname = str(tmp_path / "net.params")
    pb.save_parameters(fname)
    with mt.cpu():
        # the file's conv only: its other entries are extra
        other = mt.gluon.nn.HybridSequential()
        with other.name_scope():
            other.add(mt.gluon.nn.Conv2D(4, 3, padding=1))
        with pytest.raises(ValueError):
            other.load_parameters(fname)
        other.load_parameters(fname, ignore_extra=True)
        np.testing.assert_array_equal(other[0].weight.data().asnumpy(),
                                      pb[0].weight.data().asnumpy())
        # one layer more than the file: its entries are missing
        bigger = _small(mt)
        bigger.add(mt.gluon.nn.Dense(2))
        with pytest.raises(AssertionError):
            bigger.load_parameters(fname)
        bigger.load_parameters(fname, allow_missing=True)
        # a bf16 net reads the f32 file only with cast_dtype
        _, half = _pair()
        half.cast("bfloat16")
        with pytest.raises(AssertionError):
            half.load_parameters(fname)
        half.load_parameters(fname, cast_dtype=True)
        assert str(half[0].weight.data()._data.dtype) == "torch.bfloat16"
        half.load_parameters(fname, cast_dtype=True, dtype_source="saved")
        assert str(half[0].weight.data()._data.dtype) == "torch.float32"


def test_parameter_dict_save_load_prefixes(tmp_path):
    rb, pb = _pair()
    fname = str(tmp_path / "dict.params")
    pb.collect_params().save(fname, strip_prefix=pb.prefix)
    with pytest.raises(ValueError):
        pb.collect_params().save(fname, strip_prefix="nope_")
    theirs = rb.collect_params()
    theirs.load(fname, restore_prefix=rb.prefix)
    for (n, a), (_, b) in zip(theirs.items(), pb.collect_params().items()):
        np.testing.assert_array_equal(a.data().asnumpy(),
                                      b.data().asnumpy(), err_msg=n)


def test_parameter_dict_helpers_match_reference():
    rb, pb = _pair()
    assert [str(c) for c in pb.collect_params().list_ctx()] == ["cpu(0)"]
    with mt.cpu():
        pb.collect_params().setattr("lr_mult", 0.5)
        assert all(p.lr_mult == 0.5 for p in pb.collect_params().values())
        pb.collect_params().reset_ctx(mt.cpu())
        w = pb[0].weight
        assert len(w.list_data()) == 1 and w.list_data()[0] is w.data()
        pd = pb.collect_params()
        const = pd.get_constant("c", [[1.0, 2.0]])
        assert isinstance(const, mt.gluon.Constant)
        assert pd.get_constant("c") is const
        const.initialize(ctx=mt.cpu())
        np.testing.assert_array_equal(const.data().asnumpy(), [[1, 2]])
        assert const.grad_req == "null"
        with pytest.raises(KeyError):
            pd.get_constant("missing")
    rc = rb.collect_params().get_constant("c", [[1.0, 2.0]])
    assert rc.shape == const.shape and rc.grad_req == const.grad_req
    v = w.var()
    assert v.name == w.name and v.list_arguments() == [w.name]


def test_hooks_apply_and_zero_grad():
    _, pb = _pair()
    seen = []
    with mt.cpu():
        h1 = pb.register_forward_pre_hook(
            lambda b, args: seen.append(("pre", args[0].shape)))
        h2 = pb.register_forward_hook(
            lambda b, args, out: seen.append(("post", out.shape)))
        x = mt.nd.array(_x(2, 3, 8, 8))
        pb(x)
        h1.detach()
        h2.detach()
        pb(x)
    assert seen == [("pre", (2, 3, 8, 8)), ("post", (2, 3))]
    names = []
    pb.apply(lambda b: names.append(type(b).__name__))
    assert names == ["Conv2D", "BatchNorm", "Activation", "MaxPool2D",
                     "Dense", "HybridSequential"]
    with mt.cpu():
        with mt.autograd.record():
            y = pb(x)
        y.backward()
        assert any(p.grad().asnumpy().any()
                   for p in pb.collect_params().values()
                   if p.grad_req != "null")
        pb.zero_grad()
        assert not any(p.grad().asnumpy().any()
                       for p in pb.collect_params().values()
                       if p.grad_req != "null")


# ------------------------------------------------------------ initializers
def _init(pkg, init, shape, name="w_weight", seed=0):
    pkg.random.seed(seed)
    with (mt.cpu() if pkg is mt else ref.cpu()):
        arr = pkg.nd.zeros(shape)
        init(name, arr)
        return arr.asnumpy()


@pytest.mark.parametrize("make", [
    lambda p: p.init.Constant(0.25),
    lambda p: p.init.Bilinear(),
    lambda p: p.init.LSTMBias(forget_bias=2.0),
    lambda p: p.init.Mixed([".*bias", ".*"], [p.init.Zero(),
                                              p.init.Constant(3.0)]),
    lambda p: p.init.Load({"arg:w_weight": np.arange(
        24, dtype=np.float32).reshape(2, 3, 2, 2)}),
], ids=["constant", "bilinear", "lstmbias", "mixed", "load"])
def test_deterministic_initializers_match_reference(make):
    shape = (8,) if "lstmbias" in str(make) else (2, 3, 2, 2)
    name = "w_bias" if shape == (8,) else "w_weight"
    np.testing.assert_array_equal(_init(mt, make(mt), shape, name),
                                  _init(ref, make(ref), shape, name))


def test_random_initializers_keep_their_laws():
    """Orthogonal: orthonormal rows times its scale; MSRAPrelu: gaussian
    with variance 2 / ((1 + slope^2) * fan_avg)."""
    w = _init(mt, mt.init.Orthogonal(scale=1.5), (16, 32))
    np.testing.assert_allclose(w @ w.T, 2.25 * np.eye(16), atol=1e-5)
    w = _init(mt, mt.init.MSRAPrelu(slope=0.25), (256, 256, 3, 3))
    fan = 256 * 9.0
    np.testing.assert_allclose(w.std(), np.sqrt(2 / 1.0625 / fan),
                               rtol=0.01)
    assert mt.init.MSRAPrelu().dumps() == ref.init.MSRAPrelu().dumps()


def test_prelu_default_alpha_is_a_quarter():
    with mt.cpu():
        layer = mt.gluon.nn.PReLU()
        layer.initialize(ctx=mt.cpu())
        np.testing.assert_array_equal(layer.alpha.data().asnumpy(), [0.25])


# ------------------------------------------------------------- gluon.utils
def test_split_and_load_and_split_data_match_reference():
    x = _x(10, 3)
    for even in (True, False):
        for n in (1, 2, 3):
            if even and 10 % n:
                with pytest.raises(ValueError):
                    mt.gluon.utils.split_data(mt.nd.array(x, ctx=mt.cpu()),
                                              n)
                continue
            got = mt.gluon.utils.split_data(mt.nd.array(x, ctx=mt.cpu()), n,
                                            even_split=even)
            want = ref.gluon.utils.split_data(ref.nd.array(x), n,
                                              even_split=even)
            assert [g.shape for g in got] == [w.shape for w in want]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    got = mt.gluon.utils.split_and_load(x, [mt.cpu(), mt.cpu()])
    assert [g.shape for g in got] == [(5, 3), (5, 3)]
    assert all(str(g.context) == "cpu(0)" for g in got)
    np.testing.assert_array_equal(np.concatenate([g.asnumpy() for g in got]),
                                  x)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_reference(max_norm):
    xs = [_x(3, 4), _x(5, seed=1)]
    got = [mt.nd.array(a, ctx=mt.cpu()) for a in xs]
    want = [ref.nd.array(a) for a in xs]
    gn = mt.gluon.utils.clip_global_norm(got, max_norm)
    wn = ref.gluon.utils.clip_global_norm(want, max_norm)
    np.testing.assert_allclose(gn, wn, rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-6)
    tn = mt.gluon.utils.clip_global_norm(
        [mt.nd.array(a, ctx=mt.cpu()) for a in xs], max_norm,
        check_isfinite=False)
    np.testing.assert_allclose(float(tn), wn, rtol=1e-6)
    with pytest.warns(UserWarning):
        mt.gluon.utils.clip_global_norm(
            [mt.nd.array([np.inf, 1.0], ctx=mt.cpu())], 1.0)


def test_download_check_sha1_and_shape_is_known(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"weights")
    import hashlib
    sha = hashlib.sha1(b"weights").hexdigest()
    dst = str(tmp_path / "out" / "copy.bin")
    assert mt.gluon.utils.download("file://" + str(src), dst,
                                   sha1_hash=sha) == dst
    assert mt.gluon.utils.check_sha1(dst, sha)
    assert not mt.gluon.utils.check_sha1(dst, "0" * 40)
    # present and matching: returned as it is
    assert mt.gluon.utils.download("http://example.invalid/copy.bin", dst,
                                   sha1_hash=sha) == dst
    with pytest.raises(RuntimeError):
        mt.gluon.utils.download("http://example.invalid/other.bin",
                                str(tmp_path / "other.bin"))
    for shape in [None, (), (2, 0), (2, 3)]:
        assert mt.gluon.utils.shape_is_known(shape) == \
            ref.gluon.utils.shape_is_known(shape)


# ------------------------------------------------------------ model_store
@pytest.mark.parametrize("hashed", [False, True], ids=["plain", "hashed"])
def test_load_pretrained_from_a_written_file(tmp_path, hashed):
    """A params file the test writes (by the reference, in its store's
    naming) loads through ``pretrained=True`` in the port."""
    root = str(tmp_path / "models")
    os.makedirs(root)
    with ref.name.NameManager():
        rnet = ref.gluon.model_zoo.vision.get_model("mobilenet0.25",
                                                    classes=10)
    ref.random.seed(0)
    rnet.initialize(ref.init.Xavier())
    rnet(ref.nd.array(_x(1, 3, 32, 32)))
    fname = "mobilenet0.25-0123abcd.params" if hashed \
        else "mobilenet0.25.params"
    rnet.save_parameters(os.path.join(root, fname))
    assert mt_store.get_model_file("mobilenet0.25", root) == \
        ref_store.get_model_file("mobilenet0.25", root)
    with mt.cpu():
        net = mt.gluon.model_zoo.vision.get_model(
            "mobilenet0.25", classes=10, pretrained=True, root=root,
            ctx=mt.cpu())
    _same(_values(net), _values(rnet))
    mt_store.purge(root)
    assert not os.listdir(root)
    with pytest.raises(RuntimeError):
        mt_store.get_model_file("mobilenet0.25", root)
