"""The Gluon layers this slice ports, held against the reference's on the
CPU: each layer built in both packages from the same code, the
reference's drawn weights carried onto the port's, one forward on seeded
numpy inputs and one backward with a seeded head gradient; outputs, input
gradients and parameter gradients within RTOL of the reference's largest
magnitude (f32; the packages sum in different orders, and the
transposed convolutions and 3-D pools run through different library
routines).  Dropout's training mask is each package's own draw: it is
held by its properties.

The reference's tape does not record an NDArray passed to an op by
keyword, so its LayerNorm and GroupNorm (``gamma=``, ``beta=``) and
PReLU (``gamma=alpha``) give those parameters no gradient.  The port's
does; their gradients are held against the reference's layer with the
parameters passed by position (``POSITIONAL``).  The reference's grouped
``Deconvolution`` does not run (its lowering divides the input channels
by the groups twice), so the grouped transposed convolution is held by
its weight layout only."""
import numpy as np
import pytest

import mxnet_tpu_torch as mt

import _torch_gluon as G

RTOL = 1e-5


def _rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (id, make(pkg) -> block, input shapes)
LAYERS = [
    ("conv1d", lambda p: p.gluon.nn.Conv1D(4, 3, strides=2, padding=1),
     [(2, 3, 9)]),
    ("conv1d-dilated-nobias", lambda p: p.gluon.nn.Conv1D(
        4, 3, dilation=2, use_bias=False, activation="relu"), [(2, 3, 9)]),
    ("conv3d", lambda p: p.gluon.nn.Conv3D(4, 3, padding=1),
     [(1, 2, 5, 5, 5)]),
    ("conv1d-transpose", lambda p: p.gluon.nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), [(2, 3, 5)]),
    ("conv2d-transpose", lambda p: p.gluon.nn.Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), [(1, 3, 4, 4)]),
    ("conv3d-transpose", lambda p: p.gluon.nn.Conv3DTranspose(2, 3,
                                                             strides=2),
     [(1, 2, 3, 3, 3)]),
    ("maxpool1d", lambda p: p.gluon.nn.MaxPool1D(3, 2, 1), [(2, 3, 9)]),
    ("maxpool3d", lambda p: p.gluon.nn.MaxPool3D(2), [(1, 2, 4, 4, 4)]),
    ("avgpool1d", lambda p: p.gluon.nn.AvgPool1D(3, 2, 1), [(2, 3, 9)]),
    ("avgpool1d-nopad", lambda p: p.gluon.nn.AvgPool1D(
        3, 2, 1, count_include_pad=False), [(2, 3, 9)]),
    ("avgpool2d", lambda p: p.gluon.nn.AvgPool2D(3, 2, 1),
     [(2, 3, 7, 7)]),
    ("avgpool3d", lambda p: p.gluon.nn.AvgPool3D(2), [(1, 2, 4, 4, 4)]),
    ("globalmaxpool1d", lambda p: p.gluon.nn.GlobalMaxPool1D(),
     [(2, 3, 9)]),
    ("globalmaxpool2d", lambda p: p.gluon.nn.GlobalMaxPool2D(),
     [(2, 3, 5, 5)]),
    ("globalmaxpool3d", lambda p: p.gluon.nn.GlobalMaxPool3D(),
     [(1, 2, 3, 3, 3)]),
    ("globalavgpool1d", lambda p: p.gluon.nn.GlobalAvgPool1D(),
     [(2, 3, 9)]),
    ("globalavgpool3d", lambda p: p.gluon.nn.GlobalAvgPool3D(),
     [(1, 2, 3, 3, 3)]),
    ("reflectionpad2d", lambda p: p.gluon.nn.ReflectionPad2D(2),
     [(1, 2, 5, 5)]),
    ("layernorm", lambda p: p.gluon.nn.LayerNorm(), [(3, 8)]),
    ("layernorm-axis1", lambda p: p.gluon.nn.LayerNorm(axis=1),
     [(2, 5, 3)]),
    ("groupnorm", lambda p: p.gluon.nn.GroupNorm(num_groups=2),
     [(2, 4, 3, 3)]),
    ("instancenorm", lambda p: p.gluon.nn.InstanceNorm(scale=True),
     [(2, 3, 5, 5)]),
    ("instancenorm-axis2", lambda p: p.gluon.nn.InstanceNorm(axis=2),
     [(2, 3, 4, 5)]),
    ("elu", lambda p: p.gluon.nn.ELU(0.7), [(3, 8)]),
    ("gelu", lambda p: p.gluon.nn.GELU(), [(3, 8)]),
    ("leakyrelu", lambda p: p.gluon.nn.LeakyReLU(0.1), [(3, 8)]),
    ("prelu", lambda p: p.gluon.nn.PReLU(), [(2, 3, 4)]),
    ("selu", lambda p: p.gluon.nn.SELU(), [(3, 8)]),
    ("swish", lambda p: p.gluon.nn.Swish(1.5), [(3, 8)]),
    ("hybridlambda-name", lambda p: p.gluon.nn.HybridLambda("tanh"),
     [(3, 8)]),
    ("hybridlambda-fn", lambda p: p.gluon.nn.HybridLambda(
        lambda F, x: F.relu(x) * 2), [(3, 8)]),
    ("lambda", lambda p: p.gluon.nn.Lambda(lambda x: x * 3 + 1),
     [(3, 8)]),
    ("dropout-predict", lambda p: p.gluon.nn.Dropout(0.5), [(3, 8)]),
]


def _sequential(p):
    net = p.gluon.nn.Sequential()
    with net.name_scope():
        net.add(p.gluon.nn.Dense(6, activation="relu"),
                p.gluon.nn.Lambda("tanh"), p.gluon.nn.Dense(3))
    return net


LAYERS.append(("sequential", _sequential, [(4, 5)]))


def _positional(ref_layer, forward):
    """The reference's layer class with ``hybrid_forward`` replaced."""
    return type(ref_layer.__name__, (ref_layer,),
                {"hybrid_forward": forward})


POSITIONAL = {
    "layernorm": lambda r, **kw: _positional(
        r.gluon.nn.LayerNorm, lambda self, F, x, gamma, beta: F.LayerNorm(
            x, gamma, beta, axis=self._axis, eps=self._epsilon))(**kw),
    "groupnorm": lambda r, **kw: _positional(
        r.gluon.nn.GroupNorm, lambda self, F, x, gamma, beta: F.GroupNorm(
            x, gamma, beta, num_groups=self._num_groups,
            eps=self._epsilon))(**kw),
    "prelu": lambda r, **kw: _positional(
        r.gluon.nn.PReLU, lambda self, F, x, alpha: F.LeakyReLU(
            x, alpha, act_type="prelu"))(**kw),
}
REF_MAKE = {"layernorm": lambda r: POSITIONAL["layernorm"](r),
            "layernorm-axis1": lambda r: POSITIONAL["layernorm"](r, axis=1),
            "groupnorm": lambda r: POSITIONAL["groupnorm"](r, num_groups=2),
            "prelu": lambda r: POSITIONAL["prelu"](r)}


@pytest.mark.parametrize("layer", LAYERS, ids=[i for i, _, _ in LAYERS])
def test_layer_matches_reference(layer):
    name, make, shapes = layer
    inputs = [_rnd(*s, seed=k) for k, s in enumerate(shapes)]
    G.check(make, inputs, RTOL, training="predict" not in name,
            ref_make=REF_MAKE.get(name))


def test_reference_drops_keyword_parameter_gradients():
    """The fault POSITIONAL works around: the reference's own LayerNorm
    gives gamma a zero gradient, the port's does not."""
    x = [_rnd(3, 8)]
    heads = [_rnd(3, 8, seed=4)]
    rb, pb = G.build(lambda p: p.gluon.nn.LayerNorm())
    G.run(G.ref, rb, x, None, grads=False)
    G.carry(rb, pb)
    want = G.run(G.ref, rb, x, heads)[2]
    got = G.run(mt, pb, x, heads)[2]
    assert not want["layernorm0_gamma"].any()
    assert np.abs(got["layernorm0_gamma"]).max() > 0.1


def test_dropout_predict_is_the_identity_and_training_masks():
    x = _rnd(64, 64) + 3.0
    _, pb = G.build(lambda p: p.gluon.nn.Dropout(0.25))
    with mt.cpu():
        nd = mt.nd.array(x)
        np.testing.assert_array_equal(pb(nd).asnumpy(), x)
        with mt.autograd.record():
            y = pb(nd).asnumpy()
    kept = y != 0
    np.testing.assert_allclose(y[kept], (x / 0.75)[kept], rtol=1e-6)
    assert 0.65 < kept.mean() < 0.85


def test_embedding_matches_reference():
    """Rows at integer ids; the weight's gradient sums the head rows."""
    ids = np.array([[1, 3, 3], [0, 9, 2]], np.float32)
    rb, pb = G.build(lambda p: p.gluon.nn.Embedding(10, 4))
    G.carry(rb, pb)
    heads = [_rnd(2, 3, 4, seed=5)]
    got = G.run(mt, pb, [ids], heads)
    want = G.run(G.ref, rb, [ids], heads)
    G.close(got[0][0], want[0][0], 0.0, "rows")
    for n in want[2]:
        G.close(got[2][n], want[2][n], RTOL, n)


def test_options_the_port_does_not_take_raise():
    """A channel-last layout raises, where the reference's layers would
    run it channel-first.  ``Embedding(sparse_grad=True)`` is taken: it
    declares a row-sparse gradient, whose buffer is dense; SPMDTrainer's
    row-sparse route (tests/test_torch_embedding.py) and gluon.Trainer's
    lazy row update (tests/test_torch_gluon_sparse_update.py) update
    the looked-up rows only."""
    emb = mt.gluon.nn.Embedding(10, 4, sparse_grad=True)
    assert emb.weight.grad_stype == "row_sparse"
    for make in (lambda: mt.gluon.nn.Conv2D(4, 3, layout="NHWC"),
                 lambda: mt.gluon.nn.Conv1DTranspose(4, 3, layout="NWC"),
                 lambda: mt.gluon.nn.MaxPool2D(layout="NHWC"),
                 lambda: mt.gluon.nn.GlobalAvgPool3D(layout="NDHWC")):
        with pytest.raises(NotImplementedError):
            make()


def test_deconvolution_weight_layout_and_deferred_shape():
    """A transposed convolution's weight is (in, out / groups, *k), its
    in_channels taken from the first input."""
    with mt.cpu():
        layer = mt.gluon.nn.Conv2DTranspose(6, 3, groups=2)
        layer.initialize(ctx=mt.cpu())
        assert layer.weight.shape == (0, 3, 3, 3)
        layer(mt.nd.array(_rnd(1, 4, 5, 5)))
        assert layer.weight.shape == (4, 3, 3, 3)


def test_layer_reprs_match_reference():
    for make in (lambda p: p.gluon.nn.Conv1D(4, 3, padding=1,
                                             in_channels=2),
                 lambda p: p.gluon.nn.AvgPool2D(3, 2, 1),
                 lambda p: p.gluon.nn.Dropout(0.3),
                 lambda p: p.gluon.nn.Embedding(10, 4),
                 lambda p: p.gluon.nn.LeakyReLU(0.1),
                 lambda p: p.gluon.nn.GroupNorm(2)):
        rb, pb = G.build(make)
        assert repr(pb) == repr(rb)
