"""Helpers of the Gluon parity tests: one Block built in both packages
from the same code under fresh name managers, the reference's drawn
weights carried onto the port's (``convert.gluon_params_from_reference``),
and one forward with gradients through each package's autograd from the
same numpy inputs and head gradient."""
import numpy as np

import mxnet_tpu as ref
import mxnet_tpu.name  # noqa: F401  (the reference loads it lazily)
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.name  # noqa: F401
from mxnet_tpu_torch.convert import gluon_params_from_reference


def build(make, seed=0, ref_make=None):
    """``(ref_block, port_block)`` of ``make(pkg)`` (the reference's of
    ``ref_make(ref)`` where given), both built under a fresh NameManager
    (so their names agree) and initialized."""
    with ref.name.NameManager():
        rb = (ref_make or make)(ref)
    with mt.name.NameManager():
        with mt.cpu():
            pb = make(mt)
    ref.random.seed(seed)
    rb.initialize(ref.init.Xavier())
    with mt.cpu():
        pb.initialize(mt.init.Xavier(), ctx=mt.cpu())
    return rb, pb


def carry(rb, pb):
    """The reference's values onto the port's Parameters (names matched
    after each net's top prefix)."""
    params = rb.collect_params()
    if not params:
        return
    gluon_params_from_reference(pb, {n: p.data().asnumpy()
                                     for n, p in params.items()})


def run(pkg, block, inputs, heads, training=True, grads=True):
    """One forward of ``block`` on numpy ``inputs``; with ``grads``, under
    ``record(train_mode=training)`` and ``backward(heads)``: ``(outputs,
    input grads, {name: param grad})`` as numpy."""
    ctx = mt.cpu() if pkg is mt else ref.cpu()
    with ctx:
        nds = [pkg.nd.array(a) for a in inputs]
        if not grads:
            with pkg.autograd.predict_mode() if not training \
                    else pkg.autograd.train_mode():
                out = block(*nds)
            outs = out if isinstance(out, (list, tuple)) else [out]
            return [o.asnumpy() for o in outs], [], {}
        for a in nds:
            a.attach_grad()
        with pkg.autograd.record(train_mode=training):
            out = block(*nds)
        outs = out if isinstance(out, (list, tuple)) else [out]
        pkg.autograd.backward(outs, [pkg.nd.array(h) for h in heads])
        # built under fresh name managers, both nets name alike
        pgrads = {n: p.grad().asnumpy()
                  for n, p in block.collect_params().items()
                  if p.grad_req != "null"}
        return ([o.asnumpy() for o in outs], [a.grad.asnumpy() for a in nds],
                pgrads)


def close(got, want, rtol, what=""):
    """max |got - want| within ``rtol`` of max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    assert err <= rtol, "%s: max |port - ref| / max |ref| = %g" % (what,
                                                                   err)


def check(make, inputs, rtol, training=True, seed=0, heads_seed=1,
          ref_make=None):
    """``make``'s Block in both packages from the reference's weights:
    outputs, input gradients and parameter gradients within ``rtol``."""
    rb, pb = build(make, seed, ref_make)
    # resolve deferred shapes, then carry the reference's values across
    run(ref, rb, inputs, None, training, grads=False)
    carry(rb, pb)
    routs, _, _ = run(ref, rb, inputs, None, training, grads=False)
    rng = np.random.RandomState(heads_seed)
    heads = [np.asarray(rng.randn(*o.shape), np.float32) for o in routs]
    got = run(mt, pb, inputs, heads, training)
    want = run(ref, rb, inputs, heads, training)
    for g, w in zip(got[0], want[0]):
        close(g, w, rtol, "output")
    for k, (g, w) in enumerate(zip(got[1], want[1])):
        close(g, w, rtol, "input %d grad" % k)
    assert set(got[2]) == set(want[2]), (sorted(got[2]), sorted(want[2]))
    for n in want[2]:
        close(got[2][n], want[2][n], rtol, n + " grad")
    return rb, pb


# ------------------------------------------------------------------ zoo
# Inference logits: f32 after tens of convolutions summed in different
# orders by XLA and PyTorch (resnet50_v1 measured 2.2e-6): 1e-4 of their
# largest magnitude.  Training mode: every BatchNorm divides by its batch
# std over a few positions at batch 2, which amplifies those differences
# layer by layer (the ResNet test's RESNET_TRAIN_RTOL): 5e-3.
ZOO_RTOL = 1e-4
ZOO_TRAIN_RTOL = 5e-3


class same_dropout_masks:
    """Both packages' ``nn.Dropout`` in training mode multiply by one
    numpy mask drawn from the input's shape (the packages' own draws
    differ), so training-mode logits can be compared."""

    def __enter__(self):
        self._saved = []
        for pkg in (ref, mt):
            cls = pkg.gluon.nn.Dropout
            self._saved.append((cls, cls.hybrid_forward))

            def forward(block, F, x, _pkg=pkg):
                if not _pkg.autograd.is_training() or block._rate <= 0:
                    return x
                keep = 1.0 - block._rate
                rng = np.random.RandomState(sum(x.shape))
                mask = (rng.rand(*x.shape) < keep) / keep
                return x * _pkg.nd.array(mask.astype(np.float32),
                                         ctx=x.context)
            cls.hybrid_forward = forward
        return self

    def __exit__(self, *exc):
        for cls, fn in self._saved:
            cls.hybrid_forward = fn


def _jit_reference(rb, values):
    """The reference's Block with ``values`` (``{name: numpy}``) as its
    parameters and hybridized straight into its jit path: its first call
    would otherwise run op by op to resolve the deferred shapes, one
    compile per op shape (about a minute for DenseNet-121 on a CPU)."""
    from mxnet_tpu.gluon.block import _CachedGraph
    for n, p in rb.collect_params().items():
        p.grad_req = "null"    # no gradient buffers: logits only
        p.set_data(ref.nd.array(values[n]))
        p._finish_deferred_init()
    rb.hybridize()
    rb._cached_graph_obj = _CachedGraph(rb)


def zoo_pair(name, shape):
    """``get_model(name)`` at its published widths (1000 classes) in both
    packages, built under fresh name managers: the port's Xavier draws
    (deferred shapes resolved by one port forward) become the
    reference's values, and the reference runs jitted.  The names,
    shapes and order of every parameter must agree."""
    def make(p):
        return p.gluon.model_zoo.vision.get_model(name, classes=1000)
    with ref.name.NameManager():
        rb = make(ref)
    with mt.name.NameManager():
        pb = make(mt)
    mt.random.seed(0)
    x = np.random.RandomState(0).uniform(size=shape).astype(np.float32)
    with mt.cpu():
        pb.initialize(mt.init.Xavier(), ctx=mt.cpu())
    run(mt, pb, [x], None, training=False, grads=False)
    rp, pp = rb.collect_params(), pb.collect_params()
    assert list(rp.keys()) == list(pp.keys())
    assert [p.grad_req for p in rp.values()] == \
        [p.grad_req for p in pp.values()]
    rb.initialize(ref.init.Xavier())
    _jit_reference(rb, {n: p.data().asnumpy() for n, p in pp.items()})
    assert [p.shape for p in rp.values()] == [p.shape for p in pp.values()]
    return rb, pb
def zoo_check(name, shape):
    """Logits in inference and in training mode (Dropout masks made
    equal) against the reference's; training mode also moves the
    BatchNorm statistics alike."""
    rb, pb = zoo_pair(name, shape)
    x = np.random.RandomState(1).uniform(size=shape).astype(np.float32)
    got = run(mt, pb, [x], None, training=False, grads=False)[0][0]
    want = run(ref, rb, [x], None, training=False, grads=False)[0][0]
    assert got.shape == (shape[0], 1000) and np.isfinite(got).all()
    close(got, want, ZOO_RTOL, name + " inference logits")
    with same_dropout_masks():
        got = run(mt, pb, [x], None, training=True, grads=False)[0][0]
        want = run(ref, rb, [x], None, training=True, grads=False)[0][0]
    close(got, want, ZOO_TRAIN_RTOL, name + " training logits")
    # the moving statistics moved alike: a running mean is held at the
    # scale of its channels' spread (its running variance), since a
    # batch mean that cancels has no digits of its own to compare
    rp, pp = rb.collect_params(), pb.collect_params()
    for n, a in rp.items():
        if n.endswith("running_var"):
            close(pp[n].data().asnumpy(), a.data().asnumpy(),
                  ZOO_TRAIN_RTOL, n)
        elif n.endswith("running_mean"):
            spread = np.sqrt(rp[n[:-len("mean")] + "var"].data().asnumpy())
            err = np.abs(pp[n].data().asnumpy() - a.data().asnumpy())
            assert float((err / spread).max()) <= ZOO_TRAIN_RTOL, n
