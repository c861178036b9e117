"""2-bit gradient compression in the port (``parallel/compression.py``,
the dist kvstore's compressed push, ``gluon.Trainer``'s
``compression_params``, SPMDTrainer's compressed DCN step) against the
reference on the CPU.

The codec's codes, residuals and wire bytes are exact functions of their
inputs, so every comparison of the codec is bitwise, odd lengths (a last
byte holding fewer than four codes) included.  The compressed step on a
one-rank ``{"dcn": 1}`` mesh is held against the reference's DCN hop
rebuilt from its own codec and gradients (tests/_torch_dcn_ref.py): with
dyadic inputs bitwise, with random ones within 1e-6.  The multi-rank
compressed step and the dist kvstore's compressed push over 2 and 3
ranks are in tests/test_torch_dist.py.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as ref
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.name  # noqa: F401
from mxnet_tpu.parallel import compression as rc
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
from mxnet_tpu_torch.parallel import compression as pc

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402
from _torch_dcn_ref import dcn_inputs, ref_dcn  # noqa: E402

LENGTHS = (1, 2, 3, 4, 5, 7, 8, 33, 1001)
RANDOM_ATOL = 1e-6


def _bits(a):
    return np.asarray(a).tobytes()


def _codec_inputs(n, thr, seed):
    rng = np.random.RandomState(seed)
    g = rng.randn(n).astype(np.float32) * thr
    r = rng.randn(n).astype(np.float32) * thr * 0.5
    # values on the thresholds themselves code to +-1
    g[::5] = thr - r[::5]
    g[1::7] = -thr - r[1::7]
    return g, r


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("thr", [0.5, 0.3])
def test_codec_bitwise(n, thr):
    g, r = _codec_inputs(n, thr, n)
    pcodes, pres = pc.two_bit_compress(torch.from_numpy(g),
                                       torch.from_numpy(r), thr)
    rcodes, rres = rc.two_bit_compress(jnp.asarray(g), jnp.asarray(r), thr)
    assert pcodes.dtype == torch.int8
    assert _bits(pcodes.numpy()) == _bits(rcodes)
    assert _bits(pres.numpy()) == _bits(rres)
    packed = pc.pack_2bit(pcodes)
    assert packed.dtype == torch.uint8 and packed.numel() == (n + 3) // 4
    assert _bits(packed.numpy()) == _bits(rc.pack_2bit(rcodes))
    back = pc.unpack_2bit(packed, n)
    assert _bits(back.numpy()) == _bits(pcodes.numpy())
    assert _bits(back.numpy()) == _bits(rc.unpack_2bit(rc.pack_2bit(rcodes),
                                                       n))
    assert _bits(pc.two_bit_decompress(pcodes, thr).numpy()) == \
        _bits(rc.two_bit_decompress(rcodes, thr))


def test_error_feedback_recursion_bitwise():
    """A sub-threshold gradient pushed repeatedly: the residual carries it
    until the code fires, in both packages alike."""
    g = np.full(6, 0.3, np.float32)
    pres, rres = torch.zeros(6), jnp.zeros(6)
    fired = 0
    for _ in range(6):
        pcodes, pres = pc.two_bit_compress(torch.from_numpy(g), pres, 0.5)
        rcodes, rres = rc.two_bit_compress(jnp.asarray(g), rres, 0.5)
        assert _bits(pcodes.numpy()) == _bits(rcodes)
        assert _bits(pres.numpy()) == _bits(rres)
        fired += int(pcodes.any())
    assert 0 < fired < 6


def test_kvstore_compression_one_worker_is_uncompressed():
    """On one worker the reference sends no codes (nothing crosses
    workers): the push stores the value itself, in both packages."""
    val = np.array([0.1, -0.7, 0.3, 0.55], np.float32)
    outs = []
    for pkg in (ref, mt):
        with pkg.cpu():
            kv = pkg.kv.create("dist_sync")
            kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
            kv.init("k", pkg.nd.zeros((4,)))
            kv.push("k", pkg.nd.array(val))
            out = pkg.nd.zeros((4,))
            kv.pull("k", out=out)
            outs.append(out.asnumpy())
    assert _bits(outs[0]) == _bits(outs[1]) == _bits(val)
    with pytest.raises(ValueError, match="compression type"):
        mt.kv.create("local").set_gradient_compression({"type": "1bit"})


def test_gluon_trainer_takes_compression_params():
    """``compression_params`` reach the kvstore; on one worker the updates
    are the uncompressed ones, as in the reference."""
    ws = []
    for params in (None, {"type": "2bit", "threshold": 0.25}):
        with mt.cpu():
            w = mt.gluon.Parameter("w", shape=(3,))
            w.initialize(mt.init.One(), ctx=mt.cpu())
            tr = mt.gluon.Trainer([w], "sgd", {"learning_rate": 0.5},
                                  compression_params=params)
            for _ in range(2):
                with mt.autograd.record():
                    y = (w.data() * mt.nd.array([0.1, 0.2, -0.3])).sum()
                y.backward()
                tr.step(1)
            assert tr._kvstore._compression_params == params
            ws.append(w.data().asnumpy())
    assert _bits(ws[0]) == _bits(ws[1])


def test_grad_compress_knob_validates():
    with pytest.raises(ValueError, match="grad_compress"):
        mt.config.set("kvstore.grad_compress", "3bit")
    assert mt.config.get("kvstore.grad_compress") == ""
    assert mt.config.get("kvstore.grad_compression_threshold") == 0.5


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "random"])
def test_compressed_dcn_step_one_rank(exact):
    """``kvstore.grad_compress=2bit`` on a ``{"dcn": 1}`` mesh: the step
    quantizes its gradient with error feedback, as the reference's does;
    residuals, losses and weights against the reference's hop, and the
    wire accounting (``kvstore.compression_ratio``: f32 bytes over packed
    bytes)."""
    inputs = dcn_inputs(1)
    want = ref_dcn(1, inputs, exact)
    pre = "dcn_exact/" if exact else "dcn_random/"
    mt.config.set("kvstore.grad_compress", "2bit")
    mt.config.set("kvstore.grad_compression_threshold", W.DCN_THRESHOLD)
    telemetry.reset()
    try:
        with mt.cpu():
            with mt.name.NameManager():
                net = W.dcn_net(mt)
            net.initialize(ctx=mt.cpu())
            mt.convert.gluon_params_from_reference(
                net, {k[len(pre + "init/"):]: v for k, v in inputs.items()
                      if k.startswith(pre + "init/")})
            tr = SPMDTrainer(net, mt.gluon.loss.L2Loss(), "sgd",
                             {"learning_rate": W.DCN_LR},
                             mesh=make_mesh({"dcn": 1}, [mt.cpu()]))
            for s in range(W.STEPS):
                loss = tr.step(inputs[pre + "x%d" % s],
                               inputs[pre + "y%d" % s]).numpy()
                for name, r in tr._dcn_residuals.items():
                    got = r.numpy()[None]
                    wr = want["res%d/%s" % (s, name.split("_", 1)[1])]
                    if exact:
                        assert _bits(got) == _bits(wr), (s, name)
                        assert _bits(loss) == _bits(want["loss%d" % s])
                    else:
                        np.testing.assert_allclose(got, wr, rtol=0,
                                                   atol=RANDOM_ATOL)
            tr.sync()
    finally:
        mt.config.unset("kvstore.grad_compress")
        mt.config.unset("kvstore.grad_compression_threshold")
    for name, p in net.collect_params().items():
        w = want["param/" + name.split("_", 1)[1]]
        if exact:
            assert _bits(p.data().asnumpy()) == _bits(w)
        else:
            np.testing.assert_allclose(p.data().asnumpy(), w, rtol=0,
                                       atol=RANDOM_ATOL)
    snap = telemetry.snapshot()
    raw = W.STEPS * 4 * (W.DCN_FEAT + 1)        # f32 bytes of w and b
    wire = W.STEPS * (1 + 1)                    # a byte each, packed
    assert snap["counters"]["kvstore.compressed_bytes"] == wire
    assert snap["counters"]["kvstore.compressed_raw_bytes"] == raw
    assert snap["gauges"]["kvstore.compression_ratio"] == raw / wire
