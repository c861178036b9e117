"""SSD (``models/ssd.py``) held against the reference's on the CPU, at the
reference tests' sizes (``tests/test_models_bert_ssd.py``: ``SSD(
num_classes=2-3, num_scales=2, base_channels=8)`` at 32x32, so N = 240
anchors).

The port's net draws the weights, the reference's takes them and runs
hybridized, and ``convert.gluon_params_from_reference`` carries the
reference's values back onto the port's with no ``prefix=`` (both nets
are built under fresh name managers).  Bounds, each max|port - ref| over
max|ref|: the forward's outputs 1e-5 (f32 convolutions and BatchNorm
summed in other orders; the anchors bitwise); ``targets`` from the same
``cls_preds`` as ``chip_smoke.DET_RTOL`` holds ``MultiBoxTarget`` (class
targets and masks bitwise; the reference's ``SSD.targets`` and
``detect`` run their op calls jitted); the loss 1e-5 and every
parameter's gradient 1e-4 from the same targets (the backward's sums
run in other orders too; a tensor's scale is floored at a tenth of the
largest gradient); ``detect`` from the same predictions, class ids
bitwise and scores and boxes 2^-20; six ``gluon.Trainer`` steps from
the same weights descend, each loss within 1e-3 of the reference's.
"""
import os
import sys

import jax
import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu.models.ssd as rssd
import mxnet_tpu.name  # noqa: F401
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.models.ssd as pssd
import mxnet_tpu_torch.name  # noqa: F401
from mxnet_tpu.ops.registry import _REGISTRY as REF_OPS
from mxnet_tpu_torch.convert import gluon_params_from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

FWD_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEP_RTOL = 1e-3


def _close(got, want, rtol, what, floor=1e-30):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    scale = max(float(np.abs(want).max(initial=0.0)), floor)
    assert err <= rtol * scale, "%s: %g > %g x %g" % (what, err, rtol,
                                                       scale)


def _labels():
    lab = np.full((2, 2, 5), -1, np.float32)
    lab[0, 0] = [0, 0.1, 0.1, 0.5, 0.5]
    lab[1, 0] = [1, 0.4, 0.4, 0.9, 0.9]
    lab[1, 1] = [0, 0.05, 0.5, 0.4, 0.95]
    return lab


def _pair(num_classes=2, seed=0):
    """The reference's SSD and the port's with the same weights, both
    shaped by one forward; the input batch.  The port draws (Xavier) and
    its deferred shapes resolve in one forward; the reference takes those
    values and runs hybridized (its first eager forward would compile
    one program per op shape); then ``gluon_params_from_reference``
    carries the reference's values back onto the port's Parameters."""
    from mxnet_tpu.gluon.block import _CachedGraph
    x = np.random.RandomState(seed).rand(2, 3, 32, 32).astype(np.float32)
    with ref.name.NameManager():
        rb = rssd.SSD(num_classes=num_classes, num_scales=2,
                      base_channels=8)
    with mt.name.NameManager():
        pb = pssd.SSD(num_classes=num_classes, num_scales=2,
                      base_channels=8)
    mt.random.seed(seed)
    with mt.cpu():
        pb.initialize(mt.init.Xavier(), ctx=mt.cpu())
        pb(mt.nd.array(x))
    drawn = {n: p.data().asnumpy() for n, p in pb.collect_params().items()}
    rb.initialize(ref.init.Xavier())
    for n, p in rb.collect_params().items():
        p.set_data(ref.nd.array(drawn[n]))
        p._finish_deferred_init()
    rb.hybridize()
    rb._cached_graph_obj = _CachedGraph(rb)
    with mt.cpu():
        for p in pb.collect_params().values():
            p.set_data(mt.nd.zeros(p.shape))
    gluon_params_from_reference(pb, {n: p.data().asnumpy() for n, p in
                                     rb.collect_params().items()})
    return rb, pb, x


@pytest.fixture(scope="module")
def nets():
    return _pair()


@jax.jit
def _ref_targets(anchors, cls_preds, labels):
    """The reference's ``SSD.targets`` (its ``MultiBoxTarget`` call),
    jitted."""
    return REF_OPS["MultiBoxTarget"].fn(
        anchors, labels, cls_preds.transpose(0, 2, 1),
        negative_mining_ratio=3.0, negative_mining_thresh=0.5)


@jax.jit
def _ref_detect(anchors, cls_preds, box_preds):
    """The reference's ``SSD.detect`` (softmax, ``MultiBoxDetection`` at
    its defaults), jitted."""
    probs = REF_OPS["softmax"].fn(cls_preds, axis=-1)
    return REF_OPS["MultiBoxDetection"].fn(
        probs.transpose(0, 2, 1), box_preds, anchors, nms_threshold=0.45,
        threshold=0.01)


def _host(*xs):
    return [x.asnumpy() for x in xs]


def test_carried_parameters_are_the_references(nets):
    rb, pb, _ = nets
    rp = sorted(rb.collect_params().items())
    pp = sorted(pb.collect_params().items())
    assert [n for n, _ in rp] == [n for n, _ in pp]
    for (n, r), (_, p) in zip(rp, pp):
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      r.data().asnumpy(), err_msg=n)


def test_ssd_512_has_the_references_parameters():
    with ref.name.NameManager():
        rn = rssd.ssd_512(num_classes=20)
    with mt.name.NameManager():
        pn = pssd.ssd_512(num_classes=20)
    names = sorted(pn.collect_params().keys())
    assert names == sorted(rn.collect_params().keys())
    trainable = [n for n in names if "running_" not in n]
    assert len(trainable) == chip_smoke.SSD_TENSORS


def test_forward_outputs(nets):
    rb, pb, x = nets
    want = [o.asnumpy() for o in rb(ref.nd.array(x))]
    with mt.cpu():
        got = [o.asnumpy() for o in pb(mt.nd.array(x))]
    assert got[0].shape == (1, 240, 4) and got[1].shape == (2, 240, 3)
    np.testing.assert_array_equal(got[0], want[0])
    for name, g, w in zip(("cls_preds", "box_preds"), got[1:], want[1:]):
        _close(g, w, FWD_RTOL, name)


def test_targets_from_the_same_cls_preds(nets):
    rb, pb, x = nets
    anchors, cls_preds, _ = _host(*rb(ref.nd.array(x)))
    lab = _labels()
    want = [np.asarray(t) for t in _ref_targets(anchors, cls_preds, lab)]
    with mt.cpu():
        got = [t.asnumpy() for t in pb.targets(
            mt.nd.array(anchors), mt.nd.array(cls_preds), mt.nd.array(lab))]
    assert (want[2] > 0).sum() >= 3 and (want[2] == 0).sum() > 0
    ratio, differing = chip_smoke.det_compare(np, "MultiBoxTarget", got,
                                              want)
    assert differing == 0 and ratio <= 1.0, (ratio, differing)


def test_loss_and_every_gradient(nets):
    rb, pb, x = nets
    lab = _labels()
    anchors, cls_preds, _ = _host(*rb(ref.nd.array(x)))
    targets = [np.asarray(t) for t in _ref_targets(anchors, cls_preds, lab)]

    def run(pkg, net):
        with pkg.autograd.record():
            _, c, b = net(pkg.nd.array(x))
            loss = pkg_loss[pkg](c, b, *[pkg.nd.array(t) for t in (
                targets[2], targets[0], targets[1])])
        loss.backward()
        return float(loss.asnumpy()), {
            n: p.grad().asnumpy() for n, p in net.collect_params().items()
            if p.grad_req != "null"}

    pkg_loss = {ref: rssd.MultiBoxLoss(), mt: pssd.MultiBoxLoss()}
    rloss, rgrads = run(ref, rb)
    with mt.cpu():
        ploss, pgrads = run(mt, pb)
    _close(ploss, rloss, LOSS_RTOL, "loss")
    assert sorted(pgrads) == sorted(rgrads) and len(pgrads) == 24
    # a convolution's bias ahead of a BatchNorm has no gradient in exact
    # arithmetic, only rounding (~1e-6 of the largest): each tensor's
    # scale is floored at a tenth of the net's largest gradient
    floor = 0.1 * max(float(np.abs(g).max()) for g in rgrads.values())
    for n in rgrads:
        _close(pgrads[n], rgrads[n], GRAD_RTOL, n, floor)


def test_detect_from_the_same_predictions(nets):
    rb, pb, x = nets
    preds = _host(*rb(ref.nd.array(x)))
    want = np.asarray(_ref_detect(*preds))
    with mt.cpu():
        got = pb.detect(*[mt.nd.array(v) for v in preds]).asnumpy()
    assert got.shape == (2, 240, 6)
    assert ((got[..., 0] >= -1) & (got[..., 0] < 2)).all()
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert (want[..., 0] >= 0).sum() > 0 and (want[..., 0] < 0).sum() > 0
    _close(got[..., 1:], want[..., 1:], 2.0 ** -20, "scores and boxes")


def test_six_trainer_steps_descend_as_the_references(nets):
    """The reference test's six steps (lr 0.1), from the fixture's weights,
    which are put back after."""
    rb, pb, x = nets
    lab = _labels()
    saved = {n: p.data().asnumpy() for n, p in rb.collect_params().items()}

    def train(pkg, net):
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        loss_fn = (rssd if pkg is ref else pssd).MultiBoxLoss()
        xs, labels = pkg.nd.array(x), pkg.nd.array(lab)
        losses = []
        for _ in range(6):
            with pkg.autograd.record():
                anchors, cls_preds, box_preds = net(xs)
                with pkg.autograd.pause():
                    if pkg is ref:
                        bt, bm, ct = (ref.nd.array(np.asarray(t)) for t in
                                      _ref_targets(*_host(anchors, cls_preds),
                                                   lab))
                    else:
                        bt, bm, ct = net.targets(anchors, cls_preds, labels)
                loss = loss_fn(cls_preds, box_preds, ct, bt, bm)
            loss.backward()
            trainer.step(2)
            losses.append(float(loss.asnumpy()))
        return losses

    try:
        want = train(ref, rb)
        with mt.cpu():
            got = train(mt, pb)
    finally:
        for n, p in rb.collect_params().items():
            p.set_data(ref.nd.array(saved[n]))
        with mt.cpu():
            for n, p in pb.collect_params().items():
                p.set_data(mt.nd.array(saved[n]))
    assert got[-1] < got[0], got
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= STEP_RTOL * abs(w), (i, got, want)


def test_sym_contrib_builds_multibox_prior():
    data = np.zeros((1, 3, 6, 5), np.float32)
    attrs = {"sizes": (0.3, 0.5), "ratios": (1.0, 2.0)}
    ps = mt.sym.contrib.MultiBoxPrior(mt.sym.var("data"), name="p", **attrs)
    rs = ref.sym.contrib.MultiBoxPrior(ref.sym.var("data"), name="p",
                                       **attrs)
    assert ps.list_arguments() == rs.list_arguments() == ["data"]
    with mt.cpu():
        got = ps.eval(ctx=mt.cpu(), data=mt.nd.array(data))[0].asnumpy()
    want = rs.eval(data=ref.nd.array(data))[0].asnumpy()
    assert got.shape == (1, 6 * 5 * 3, 4)
    np.testing.assert_array_equal(got, want)
    assert mt.sym.contrib.Proposal.__name__ == "Proposal"
    with pytest.raises(AttributeError):
        mt.sym.contrib.no_such_op
