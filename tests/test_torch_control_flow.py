"""``mx.nd.contrib``'s control flow in the port against the reference's
(``mxnet_tpu.ops.control_flow``): ``foreach``, ``while_loop`` and
``cond`` recording (the tape's Python loop) and not (the reference's
traced path: ``while_loop``'s outputs padded to ``max_iterations``, a
dead step's row ``func`` of the frozen variables; ``cond``'s single
output unwrapped), outputs and gradients at 1e-6 (the same f32 ops in
the same order)."""
import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu.contrib as ref_cf
import mxnet_tpu_torch as mt
from mxnet_tpu import autograd as ref_ag
from mxnet_tpu_torch import autograd as mt_ag

import chip_smoke

RTOL, ATOL = 1e-6, 1e-6


@pytest.mark.parametrize("name,record", chip_smoke.CONTROL_FLOW_CASES)
def test_control_flow_matches_reference(name, record):
    got = chip_smoke.control_flow_case(mt, mt.nd.contrib, np, mt.cpu(),
                                       name, record)
    want = chip_smoke.control_flow_case(ref, ref_cf, np, ref.cpu(), name,
                                        record)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_while_loop_rows_recording_and_not():
    """Recording: one row a step taken; not recording: max_iterations
    rows, the dead ones func of the frozen variables."""
    def run(pkg, loop, record, ctx):
        with ctx:
            def cond_fn(i, s):
                return i < 3

            def body(i, s):
                return s, (i + 1, s * 2)
            args = (pkg.nd.array([0.0]), pkg.nd.array([1.0]))
            if record:
                with pkg.autograd.record():
                    outs, (i_f, s_f) = loop(cond_fn, body, args,
                                            max_iterations=8)
            else:
                outs, (i_f, s_f) = loop(cond_fn, body, args,
                                        max_iterations=8)
            return outs.asnumpy(), i_f.asnumpy(), s_f.asnumpy()
    for record in (True, False):
        got = run(mt, mt.nd.contrib.while_loop, record, mt.cpu())
        want = run(ref, ref_cf.while_loop, record, ref.cpu())
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].shape == ((3, 1) if record else (8, 1))
        # rows: s before each step, 1, 2, 4, then the frozen 8
        assert got[0][-1] == (4.0 if record else 8.0) and got[2] == 8.0


def test_cond_single_output_unwrapped_when_not_recording():
    with mt.cpu():
        out = mt.nd.contrib.cond(mt.nd.array([0.0]),
                                 lambda: [mt.nd.array([10.0])],
                                 lambda: [mt.nd.array([20.0])])
        assert isinstance(out, mt.nd.NDArray) and out.asscalar() == 20.0
        with mt_ag.record():
            out = mt.nd.contrib.cond(mt.nd.array([1.0]),
                                     lambda: [mt.nd.array([10.0])],
                                     lambda: [mt.nd.array([20.0])])
        assert isinstance(out, list) and out[0].asscalar() == 10.0
    ref_out = ref_cf.cond(ref.nd.array([0.0]),
                          lambda: [ref.nd.array([10.0])],
                          lambda: [ref.nd.array([20.0])])
    assert float(ref_out.asscalar()) == 20.0
    with ref_ag.record():
        ref_out = ref_cf.cond(ref.nd.array([1.0]),
                              lambda: [ref.nd.array([10.0])],
                              lambda: [ref.nd.array([20.0])])
    assert isinstance(ref_out, list)


def test_foreach_inside_hybridized_block():
    """The reference's hybridized-block case: eager and hybridized
    forwards equal the cumulative sum in both packages."""
    host = np.random.RandomState(2).randn(4, 2).astype(np.float32)
    outs = []
    for pkg, loop in ((mt, mt.nd.contrib.foreach),
                      (ref, ref_cf.foreach)):
        class CumNet(pkg.gluon.HybridBlock):
            def hybrid_forward(self, F, x, _pkg=pkg, _loop=loop):
                out, _ = _loop(lambda e, s: (e + s, e + s), x,
                               _pkg.nd.zeros((2,)))
                return out
        with (pkg.cpu() if pkg is mt else ref.cpu()):
            net = CumNet()
            eager = net(pkg.nd.array(host)).asnumpy()
            net.hybridize()
            hybrid = net(pkg.nd.array(host)).asnumpy()
        np.testing.assert_allclose(eager, np.cumsum(host, axis=0),
                                   rtol=1e-5)
        np.testing.assert_allclose(hybrid, eager, rtol=1e-6)
        outs.append(hybrid)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6)


def test_nd_contrib_resolves_contrib_ops_by_short_name():
    x = np.random.RandomState(3).randn(2, 8).astype(np.float32)
    with mt.cpu():
        got = mt.nd.contrib.fft(mt.nd.array(x)).asnumpy()
    want = ref.nd.contrib.fft(ref.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
