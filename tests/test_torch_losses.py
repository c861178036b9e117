"""The Gluon losses against the reference's on the CPU: each loss built
in both packages, one forward on seeded numpy predictions and labels
(with and without a sample weight) and one backward with a seeded head
gradient; the per-example losses and the gradients of every input within
RTOL of the reference's largest magnitude (f32, the same expressions;
CTC's forward-backward recursion sums in a different order, CTC_RTOL).

``CTCLoss`` reserves the last class as the blank, as MXNet's layer does
(tokens 0..C-2, -1 pads); the reference's op keeps blank 0 whatever it
is told (ROADMAP queue 3), so the port's layer is held against the
reference's on the activations with the last class moved to the front
and the tokens shifted up by one."""
import numpy as np
import pytest

import _torch_gluon as G

RTOL = 1e-5
CTC_RTOL = 1e-4


def _rnd(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pos(*shape, seed=0):
    return np.random.RandomState(seed).uniform(0.1, 0.9, shape).astype(
        np.float32)


def _signs(*shape, seed=0):
    return np.where(np.random.RandomState(seed).rand(*shape) > 0.5, 1.0,
                    -1.0).astype(np.float32)


def _bits(*shape, seed=0):
    return (np.random.RandomState(seed).rand(*shape) > 0.5).astype(
        np.float32)


def _weights(n, seed=9):
    return np.random.RandomState(seed).uniform(0.5, 1.5, (n, 1)).astype(
        np.float32)


# (id, make(pkg), inputs)
LOSSES = [
    ("l2", lambda p: p.gluon.loss.L2Loss(), [_rnd(4, 5), _rnd(4, 5, seed=1)]),
    ("l2-weighted", lambda p: p.gluon.loss.L2Loss(weight=0.5),
     [_rnd(4, 5), _rnd(4, 5, seed=1), _weights(4)]),
    ("l1", lambda p: p.gluon.loss.L1Loss(), [_rnd(4, 5), _rnd(4, 5, seed=1)]),
    ("l1-weighted", lambda p: p.gluon.loss.L1Loss(weight=2.0),
     [_rnd(4, 5), _rnd(4, 5, seed=1), _weights(4)]),
    ("sigmoid-bce", lambda p: p.gluon.loss.SigmoidBinaryCrossEntropyLoss(),
     [_rnd(4, 5, scale=3.0), _bits(4, 5, seed=1)]),
    ("sigmoid-bce-from-sigmoid", lambda p: p.gluon.loss.SigmoidBCELoss(
        from_sigmoid=True), [_pos(4, 5), _bits(4, 5, seed=1)]),
    ("sigmoid-bce-pos-weight",
     lambda p: _PosWeighted(p, p.gluon.loss.SigmoidBCELoss()),
     [_rnd(4, 5, scale=3.0), _bits(4, 5, seed=1),
      _pos(1, 5, seed=2) * 3]),
    ("sigmoid-bce-from-sigmoid-pos-weight",
     lambda p: _PosWeighted(p, p.gluon.loss.SigmoidBCELoss(
         from_sigmoid=True)),
     [_pos(4, 5), _bits(4, 5, seed=1), _pos(1, 5, seed=2) * 3]),
    ("kldiv", lambda p: p.gluon.loss.KLDivLoss(),
     [np.log(_pos(4, 5)), _pos(4, 5, seed=1)]),
    ("kldiv-from-logits-false", lambda p: p.gluon.loss.KLDivLoss(
        from_logits=False), [_rnd(4, 5), _pos(4, 5, seed=1)]),
    ("huber", lambda p: p.gluon.loss.HuberLoss(rho=0.7),
     [_rnd(4, 5), _rnd(4, 5, seed=1)]),
    ("hinge", lambda p: p.gluon.loss.HingeLoss(margin=0.8),
     [_rnd(4, 5), _signs(4, 5, seed=1)]),
    ("squared-hinge", lambda p: p.gluon.loss.SquaredHingeLoss(),
     [_rnd(4, 5), _signs(4, 5, seed=1), _weights(4)]),
    ("logistic-signed", lambda p: p.gluon.loss.LogisticLoss(),
     [_rnd(4, 5, scale=2.0), _signs(4, 5, seed=1)]),
    ("logistic-binary", lambda p: p.gluon.loss.LogisticLoss(
        label_format="binary"), [_rnd(4, 5, scale=2.0), _bits(4, 5, seed=1)]),
    ("triplet", lambda p: p.gluon.loss.TripletLoss(margin=0.5),
     [_rnd(4, 6), _rnd(4, 6, seed=1), _rnd(4, 6, seed=2)]),
    ("poisson-nll", lambda p: p.gluon.loss.PoissonNLLLoss(),
     [_rnd(4, 5, scale=0.5), _pos(4, 5, seed=1) * 4]),
    ("poisson-nll-full", lambda p: p.gluon.loss.PoissonNLLLoss(
        from_logits=False, compute_full=True),
     [_pos(4, 5) * 3, _pos(4, 5, seed=1) * 4]),
    ("cosine-embedding", lambda p: p.gluon.loss.CosineEmbeddingLoss(
        margin=0.2), [_rnd(4, 6), _rnd(4, 6, seed=1),
                      _signs(4, seed=2)]),
    ("softmax-ce-dense", lambda p: p.gluon.loss.SoftmaxCELoss(
        sparse_label=False), [_rnd(4, 5), _pos(4, 5, seed=1)]),
]


def _PosWeighted(p, loss):
    """``loss(pred, label, None, pos_weight)`` as a Block of three
    inputs."""
    class PosWeighted(p.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.loss = loss

        def hybrid_forward(self, F, pred, label, pos_weight):
            return self.loss(pred, label, None, pos_weight)
    return PosWeighted()


@pytest.mark.parametrize("case", LOSSES, ids=[c[0] for c in LOSSES])
def test_loss_matches_reference(case):
    _, make, inputs = case
    G.check(make, inputs, RTOL)


def _ctc_inputs(layout):
    """Activations (N=3, T=6, C=5: class 4 the blank) and labels of 1-3
    classes padded with -1 (NT), with per-sequence lengths."""
    pred = _rnd(3, 6, 5, scale=2.0)
    label = np.array([[1, 2, 2], [0, 3, -1], [2, -1, -1]], np.float32)
    if layout == "TNC":
        pred = np.ascontiguousarray(pred.transpose(1, 0, 2))
    return pred, label


class _CTC:
    """``CTCLoss(layout)(pred, label, pred_lengths, label_lengths)`` as a
    Block, the lengths fixed."""

    @staticmethod
    def make(p, layout, lengths):
        class CTC(p.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                self.loss = p.gluon.loss.CTCLoss(layout=layout)

            def hybrid_forward(self, F, pred, label):
                if not lengths:
                    return self.loss(pred, label)
                return self.loss(pred, label, F.array([6, 5, 4]),
                                 F.array([3, 2, 1]))
        return CTC()


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("lengths", [False, True],
                         ids=["padded", "lengths"])
def test_ctc_loss_matches_reference(layout, lengths):
    pred, label = _ctc_inputs(layout)
    rot = np.concatenate([pred[..., -1:], pred[..., :-1]], axis=-1)
    shifted = np.where(label >= 0, label + 1, -1).astype(np.float32)
    rb, pb = G.build(lambda p: _CTC.make(p, layout, lengths))
    heads = [_pos(3, seed=3)]
    got = G.run(G.mt, pb, [pred, label], heads)
    want = G.run(G.ref, rb, [rot, shifted], heads)
    G.close(got[0][0], want[0][0], CTC_RTOL, "loss")
    g = want[1][0]
    G.close(got[1][0], np.concatenate([g[..., 1:], g[..., :1]], axis=-1),
            CTC_RTOL, "pred grad")


def test_logistic_loss_rejects_unknown_label_format():
    with pytest.raises(ValueError):
        G.mt.gluon.loss.LogisticLoss(label_format="onehot")


def test_loss_reprs_match_reference():
    for make in (lambda p: p.gluon.loss.L2Loss(),
                 lambda p: p.gluon.loss.HuberLoss(weight=0.5)):
        rb, pb = G.build(make)
        assert repr(pb) == repr(rb)
