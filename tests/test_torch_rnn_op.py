"""The port's ``RNN`` op held against the reference's, on the CPU
(``mxnet_tpu_torch/ops/rnn.py`` against ``mxnet_tpu/ops/rnn.py``).

The same numpy data, blob and states go through each package's op under
its autograd, with one seeded head gradient an output; the outputs,
``h_n``, ``c_n`` and the gradients of the data, the blob and the states
are compared.  On the CPU the port runs ATen's recurrence (cuDNN's on the
card), which adds the gates in the reference's order; the products sum
in other orders (MKL against XLA).  Tolerance: max |port - ref| within
1e-5 of the tensor's largest magnitude (measured: 3e-7).
"""
import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.ops.rnn as port_rnn
from mxnet_tpu.rnn._fused_layout import fused_rnn_param_size

RTOL = 1e-5
T, B, I, H = 6, 3, 5, 8


def _close(got, want, what, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    assert err <= rtol, "%s: %g of the largest magnitude" % (what, err)


def _inputs(mode, layers, bi, seed=0, batch_state=B):
    rng = np.random.RandomState(seed)
    d = 2 if bi else 1
    n = fused_rnn_param_size(I, H, layers, mode, bi)
    arrays = [rng.randn(T, B, I).astype(np.float32),
              (rng.randn(n) * 0.3).astype(np.float32),
              rng.randn(layers * d, batch_state, H).astype(np.float32)]
    if mode == "lstm":
        arrays.append(rng.randn(layers * d, batch_state, H)
                      .astype(np.float32))
    return arrays


def _run(pkg, arrays, heads, **attrs):
    """Outputs and the gradients of every input, as numpy."""
    ctx = mt.cpu() if pkg is mt else ref.cpu()
    with ctx:
        nds = [pkg.nd.array(a) for a in arrays]
        for a in nds:
            a.attach_grad()
        with pkg.autograd.record():
            outs = pkg.nd.RNN(*nds, **attrs)
        n = 3 if attrs["mode"] == "lstm" else 2
        pkg.autograd.backward(list(outs[:n]),
                              [pkg.nd.array(h) for h in heads[:n]])
        return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in nds]


def _heads(arrays, mode, layers, bi):
    rng = np.random.RandomState(7)
    d = 2 if bi else 1
    shapes = [(T, B, d * H), (layers * d, B, H), (layers * d, B, H)]
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_matches_reference(mode, layers, bi):
    arrays = _inputs(mode, layers, bi)
    heads = _heads(arrays, mode, layers, bi)
    attrs = dict(state_size=H, num_layers=layers, bidirectional=bi,
                 mode=mode)
    got_o, got_g = _run(mt, arrays, heads, **attrs)
    want_o, want_g = _run(ref, arrays, heads, **attrs)
    for name, g, w in zip(("out", "h_n", "c_n"), got_o, want_o):
        _close(g, w, name)
    for name, g, w in zip(("data", "parameters", "state", "state_cell"),
                          got_g, want_g):
        _close(g, w, "d" + name)


def test_batch_one_state_broadcasts():
    """A batch-1 initial state serves every sequence of the batch, and
    its gradient is the sum over the batch (the reference's broadcast)."""
    arrays = _inputs("lstm", 2, False, batch_state=1)
    heads = _heads(arrays, "lstm", 2, False)
    attrs = dict(state_size=H, num_layers=2, mode="lstm")
    got_o, got_g = _run(mt, arrays, heads, **attrs)
    want_o, want_g = _run(ref, arrays, heads, **attrs)
    assert got_o[1].shape == (2, B, H)
    for g, w in zip(got_o + got_g, want_o + want_g):
        _close(g, w, "broadcast state")


def test_clip_applies_to_returned_cell_state_only():
    """``lstm_state_clip_min/max`` clips the returned ``c_n`` and no
    step's cell state (the reference's behaviour, kept): the outputs and
    ``h_n`` equal the unclipped op's, ``c_n`` is its clip."""
    arrays = _inputs("lstm", 2, True)
    heads = _heads(arrays, "lstm", 2, True)
    base = dict(state_size=H, num_layers=2, bidirectional=True, mode="lstm")
    clip = dict(base, lstm_state_clip_min=-0.25, lstm_state_clip_max=0.25)
    got_o, got_g = _run(mt, arrays, heads, **clip)
    want_o, want_g = _run(ref, arrays, heads, **clip)
    for g, w in zip(got_o + got_g, want_o + want_g):
        _close(g, w, "clipped")
    free, _ = _run(mt, arrays, heads, **base)
    np.testing.assert_array_equal(got_o[0], free[0])
    np.testing.assert_array_equal(got_o[1], free[1])
    np.testing.assert_array_equal(got_o[2], np.clip(free[2], -0.25, 0.25))
    assert np.abs(free[2]).max() > 0.25


def test_sequence_length_is_ignored():
    """``use_sequence_length``/``sequence_length`` are accepted and change
    nothing (the reference's behaviour, kept): padded steps are
    computed."""
    arrays = _inputs("gru", 1, False)
    heads = _heads(arrays, "gru", 1, False)
    attrs = dict(state_size=H, mode="gru")
    with mt.cpu():
        lengths = mt.nd.array(np.array([2, 6, 4], np.float32))
    masked, _ = _run(mt, arrays, heads, use_sequence_length=True,
                     sequence_length=lengths, **attrs)
    plain, _ = _run(mt, arrays, heads, **attrs)
    for m, p in zip(masked, plain):
        np.testing.assert_array_equal(m, p)


def test_dropout_between_layers_keeps_at_its_rate(monkeypatch):
    """Dropout ``p`` applies between layers, in training only, never
    after the last layer: layer 1 reads layer 0's output with each entry
    kept at rate 1 - p and scaled by 1 / (1 - p).  The packages' masks
    differ (their streams never agree), so the rate is tested alone:
    within 4 sigma of 1 - p over the entries."""
    seen = []

    def spy(mode, x, h0, c0, weights):
        out = real(mode, x, h0, c0, weights)
        seen.append((x.detach().numpy(), out[0].detach().numpy()))
        return out

    real = port_rnn.rnn_layer
    monkeypatch.setattr(port_rnn, "rnn_layer", spy)
    p = 0.4
    rng = np.random.RandomState(3)
    big_t, big_b = 40, 50
    n = fused_rnn_param_size(I, H, 3, "lstm", False)
    x = rng.randn(big_t, big_b, I).astype(np.float32)
    w = (rng.randn(n) * 0.3).astype(np.float32)
    s = np.zeros((3, big_b, H), np.float32)
    with mt.cpu():
        args = [mt.nd.array(a) for a in (x, w, s, s)]
        mt.nd.RNN(*args, state_size=H, num_layers=3, mode="lstm", p=p,
                  training=True)
        assert len(seen) == 3
        for (_, prev_out), (next_in, _) in zip(seen[:-1], seen[1:]):
            kept = next_in != 0
            rate = kept.mean()
            sigma = np.sqrt(p * (1 - p) / kept.size)
            assert abs(rate - (1 - p)) < 4 * sigma, rate
            np.testing.assert_allclose(next_in[kept],
                                       prev_out[kept] / np.float32(1 - p),
                                       rtol=1e-6)
        seen.clear()
        mt.nd.RNN(*args, state_size=H, num_layers=3, mode="lstm", p=p,
                  training=False)
        for (_, prev_out), (next_in, _) in zip(seen[:-1], seen[1:]):
            np.testing.assert_array_equal(next_in, prev_out)
