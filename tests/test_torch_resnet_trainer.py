"""The port's ``SPMDTrainer`` held against the reference's, on the CPU.

A small ResNet v1 — ``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 24,
32, 48], classes=10, thumbnail=True)`` — on a 4x3x32x32 batch, SGD lr
0.1, momentum 0.9, wd 1e-4, from the same weights (drawn by the port,
carried across).  Each stage's channel count differs from the last (a
v1 stage downsamples only then) and the thumbnail stem (3x3 conv, no
pooling) leaves the last stage 4x4 maps: with the 7x7/max-pool stem a
32x32 input reaches it at 1x1, every BatchNorm there normalises 4
values a channel, and the two packages' last-ulp differences grow to
1e-3 of the loss within 3 steps.
Three steps in both packages with the kernel tier on (the port's K1 plain
version, the reference's Pallas kernel in interpret mode) and off, and
one step with ``dtype="bfloat16"``.  Tolerances, stated where they are
used: the losses per step and, after the last step, the masters, the
momenta and the BatchNorm moving statistics.
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JLoss
from mxnet_tpu.gluon.model_zoo.vision.resnet import BottleneckV1 as JBlock
from mxnet_tpu.gluon.model_zoo.vision.resnet import ResNetV1 as JResNet
from mxnet_tpu.parallel import SPMDTrainer as JTrainer
from mxnet_tpu.parallel import make_mesh as jmake_mesh

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import gluon_params_to_reference
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import BottleneckV1
from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import ResNetV1
from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh

LAYERS, CHANNELS = [1, 1, 1, 1], [8, 16, 24, 32, 48]
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
STEPS = 3
# f32: the two packages' convolutions and BatchNorm reductions sum in
# different orders; SGD at lr 0.1 carries the gradients' differences into
# the weights.  Each tensor's error is max |port - reference| over its
# largest |reference|, floored at STATE_FLOOR x the largest of its kind
# (masters, momenta) in the net: a conv bias that feeds a BatchNorm has an
# exact gradient of 0, so its values are f32 noise of both packages.
# Measured over the 3 steps, tier on and off: losses 1.9e-6, masters
# 2.8e-5, momenta 8.3e-5, moving statistics 4.2e-6.
LOSS_RTOL = 1e-5
STATE_RTOL = 5e-4
STATE_FLOOR = 1e-2
# bf16 compute: both round activations and weights to bf16 (8 significant
# bits) at their own points; the first loss may differ by one bf16 ulp
# (2^-8).  Measured 6.0e-4.
BF16_LOSS_RTOL = 2.0 ** -8


def _nets(seed=0):
    mt.random.seed(seed)
    tnet = ResNetV1(BottleneckV1, LAYERS, CHANNELS, classes=10,
                    thumbnail=True)
    tnet.initialize(mt.init.Xavier(), ctx=mt.cpu())
    jnet = JResNet(JBlock, LAYERS, CHANNELS, classes=10, thumbnail=True)
    jnet.initialize(jmx.init.Zero())        # values come from the port
    x = np.zeros((1, 3, 32, 32), np.float32)
    tnet(mt.nd.array(x, ctx=mt.cpu()))      # resolve the deferred shapes
    jnet(jmx.nd.array(x))
    jp = jnet.collect_params()
    for name, val in gluon_params_to_reference(tnet, jnet.prefix).items():
        jp[name].set_data(jmx.nd.array(val))
    return tnet, jnet


def _batch():
    rng = np.random.RandomState(1)
    data = rng.uniform(size=(4, 3, 32, 32)).astype(np.float32)
    label = rng.randint(0, 10, (4,)).astype(np.float32)
    return data, label


def _trainers(tnet, jnet, dtype=None):
    tr = SPMDTrainer(tnet, SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
                     mesh=make_mesh({"dp": -1}, [mt.cpu()]), dtype=dtype)
    jr = JTrainer(jnet, JLoss(), "sgd", dict(OPT),
                  mesh=jmake_mesh({"dp": -1}, jax.devices()[:1]),
                  dtype=dtype)
    return tr, jr


def _rel(got, want, floor=1e-30):
    got = np.asarray(got.detach().float().cpu(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 floor)


def _max_err(ours, theirs, names, prefixes):
    """The largest per-tensor error over ``names`` (the reference's), each
    tensor's scale floored at STATE_FLOOR x the largest |value| among
    them."""
    tpre, jpre = prefixes
    floor = STATE_FLOOR * max(float(np.abs(np.asarray(theirs[n])).max())
                              for n in names)
    return max(_rel(ours[tpre + n[len(jpre):]], theirs[n], floor)
               for n in names)


class _Tier:
    def __init__(self, on):
        self.on = on

    def __enter__(self):
        jmx.config.set("kernels.enabled", self.on)
        mt.config.set("kernels.enabled", self.on)

    def __exit__(self, *exc):
        jmx.config.unset("kernels.enabled")
        mt.config.unset("kernels.enabled")


@pytest.mark.parametrize("tier", [True, False], ids=["tier-on", "tier-off"])
def test_three_sgd_steps_match_reference(tier):
    tnet, jnet = _nets()
    data, label = _batch()
    jtel.reset()
    tt.reset()
    with _Tier(tier):
        tr, jr = _trainers(tnet, jnet)
        losses = [(float(tr.step(data, label)), float(jr.step(data, label)))
                  for _ in range(STEPS)]
    # the fused step is noted once per built step program in both
    counts = [snap["counters"].get("kernels.fused_step", 0)
              for snap in (tt.snapshot(), jtel.snapshot())]
    assert counts == [int(tier)] * 2, counts
    errs = {"loss": max(abs(a - b) / abs(b) for a, b in losses)}
    assert losses[-1][0] < losses[0][0], losses
    pre = (tnet.prefix, jnet.prefix)
    errs["master"] = _max_err(tr.params, jr.params, jr.fn.trainable, pre)
    errs["momentum"] = _max_err(tr.opt_state, jr.opt_state, jr.fn.trainable,
                                pre)
    errs["aux"] = max(_rel(tr.params[tnet.prefix + n[len(jnet.prefix):]],
                           jr.params[n]) for n in jr.fn.aux)
    assert errs["loss"] <= LOSS_RTOL, errs
    assert max(errs["master"], errs["momentum"], errs["aux"]) \
        <= STATE_RTOL, errs


#: twenty steps: the two packages' loss trajectories from the same weights,
#: held at each step relative to that step's reference loss.  Both sum
#: convolutions and BatchNorm reductions in other orders.  Over the first
#: LONG_EARLY steps (the loss falls 2.88 -> 0.43) the gap is f32 noise: at
#: most 3e-6 of the step's loss measured with 1 to 8 CPU threads.  Once
#: the loss has collapsed on its one batch (0.25 at step 5, 8.5e-4 at step
#: 19) the trajectory amplifies any rounding difference: the port against
#: itself, run with 1 and then 3 CPU threads, differs by up to 0.115 of
#: the step's loss, and the port against the reference by 0.021 (8
#: threads) to 0.107 (2 to 6 threads).  A fault that moves the loss by its
#: own size still fails.
LONG_STEPS = 20
LONG_EARLY = 5
LONG_EARLY_RTOL = 1e-4
LONG_LATE_RTOL = 0.25


def test_twenty_sgd_steps_track_reference():
    """The port's SPMDTrainer against the reference's over LONG_STEPS SGD
    steps (lr 0.1, momentum 0.9, wd 1e-4; kernel tier on) on one batch:
    at every step |port - reference| is within LONG_EARLY_RTOL (the first
    LONG_EARLY steps) or LONG_LATE_RTOL (the rest) of that step's
    reference loss, and both fall at every step (this net does not bounce
    in either package)."""
    tnet, jnet = _nets()
    data, label = _batch()
    with _Tier(True):
        tr, jr = _trainers(tnet, jnet)
        losses = np.asarray([(float(tr.step(data, label)),
                              float(jr.step(data, label)))
                             for _ in range(LONG_STEPS)])
    ours, theirs = losses[:, 0], losses[:, 1]
    assert np.all(np.isfinite(losses)), losses
    rel = np.abs(ours - theirs) / np.abs(theirs)
    assert rel[:LONG_EARLY].max() <= LONG_EARLY_RTOL, (rel, losses)
    assert rel[LONG_EARLY:].max() <= LONG_LATE_RTOL, (rel, losses)
    assert np.all(np.diff(ours) < 0) and np.all(np.diff(theirs) < 0), losses


def test_bf16_step_matches_reference():
    """``dtype="bfloat16"``: bf16 forward and backward over f32 masters;
    the masters and momenta stay f32.  Only the loss is held against the
    reference: its bf16 gradients on the CPU are not a yardstick (after
    the step, the momentum of a conv bias that feeds a BatchNorm, whose
    exact gradient is 0, is 0.106 in the reference and -7e-5 in the
    port)."""
    tnet, jnet = _nets()
    data, label = _batch()
    tr, jr = _trainers(tnet, jnet, dtype="bfloat16")
    tl, jl = float(tr.step(data, label)), float(jr.step(data, label))
    assert abs(tl - jl) <= BF16_LOSS_RTOL * abs(jl), (tl, jl)
    assert all(v.dtype == torch.float32 for v in tr.params.values())
    assert all(v.dtype == torch.float32 for v in tr.opt_state.values())


def test_sync_writes_the_trained_weights_back():
    tnet, _ = _nets()
    data, label = _batch()
    tr = SPMDTrainer(tnet, SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
                     mesh=make_mesh({"dp": -1}, [mt.cpu()]))
    before = {n: p.data().asnumpy().copy()
              for n, p in tnet.collect_params().items()}
    tr.step(data, label)
    # the Block's own Parameters are untouched until sync()
    for n, p in tnet.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), before[n])
    tr.sync()
    for n, p in tnet.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      tr.params[n].detach().numpy())


def test_nhwc_layout_trains_with_contiguous_grads():
    """Under ``conv.internal_layout=NHWC`` the conv weights enter the
    convolution channels_last, so their gradients come back channels_last;
    the trainer hands the optimizer contiguous gradients (the fused kernel
    takes nothing else) with the native layout's values."""
    tnet, _ = _nets()
    data, label = _batch()
    grads = {}
    for layout in ("native", "NHWC"):
        mt.config.set("conv.internal_layout", layout)
        try:
            tr = SPMDTrainer(tnet, SoftmaxCrossEntropyLoss(), "sgd",
                             dict(OPT), mesh=make_mesh({"dp": -1},
                                                       [mt.cpu()]))
            tr._materialize(torch.from_numpy(data))
            train = {n: tr.params[n] for n in tr.fn.trainable}
            aux = {n: tr.params[n] for n in tr.fn.aux}
            _, _, grads[layout] = tr._loss_and_grads(
                train, aux, torch.from_numpy(data), torch.from_numpy(label))
        finally:
            mt.config.unset("conv.internal_layout")
    assert all(g.is_contiguous() for g in grads["NHWC"])
    # summation order differs between the layouts; scales floored as in
    # _max_err (a conv bias that feeds a BatchNorm has gradient 0)
    floor = STATE_FLOOR * max(float(b.abs().max()) for b in grads["native"])
    for a, b in zip(grads["NHWC"], grads["native"]):
        scale = max(float(b.abs().max()), floor)
        assert float((a - b).abs().max()) <= STATE_RTOL * scale


def test_unported_trainer_options_raise(tmp_path):
    """What the reference trainer has and the port does not: each raises
    NotImplementedError instead of being ignored."""
    tnet, _ = _nets()
    data, label = _batch()
    mesh = make_mesh({"dp": -1}, [mt.cpu()])

    def trainer(**kw):
        return SPMDTrainer(tnet, SoftmaxCrossEntropyLoss(), "sgd",
                           dict(OPT), mesh=mesh, **kw)

    # param_specs are ported (tests/test_torch_tensor_parallel.py): a
    # name that is no parameter of the block raises at the first step
    with pytest.raises(ValueError, match="param_specs"):
        trainer(param_specs={"w": ("tp",)}).step(data, label)
    # a mesh over two devices needs a process group of two ranks
    # (tests/test_torch_dist.py); pad-masked steps and 2-bit compression
    # are ported (tests/test_torch_embedding.py, test_torch_compression.py)
    with pytest.raises(RuntimeError, match="2 devices"):
        make_mesh({"dp": -1}, [mt.cpu(), mt.cpu()])
    tr = trainer()
    # numerics capture is ported (tests/test_torch_numerics.py): a
    # captured step runs and publishes its sites
    mt.config.set("numerics.capture", "step:1")
    try:
        assert np.isfinite(float(tr.step(data, label)))
        mt.numerics.poll("spmd", block=True)
        assert list(mt.numerics.latest("spmd")[1])[:2] == ["out", "loss"]
    finally:
        mt.config.unset("numerics.capture")
        mt.numerics.reset()
    mt.config.set("conv.weights_layout", "HWIO")
    try:
        with pytest.raises(NotImplementedError, match="not ported"):
            tr.step(data, label)
    finally:
        mt.config.unset("conv.weights_layout")
    # the nanguard is ported (tests/test_torch_resilience.py): a guarded
    # finite step runs
    mt.config.set("resilience.nanguard", "skip")
    try:
        assert np.isfinite(float(tr.step(data, label)))
    finally:
        mt.config.unset("resilience.nanguard")
    mt.config.set("conv.weights_layout", "HWIO")
    try:
        with pytest.raises(NotImplementedError, match="HWIO"):
            trainer()
    finally:
        mt.config.unset("conv.weights_layout")
    # single-file checkpoints are ported (tests/test_torch_persistence.py),
    # and so are the manager and the sharded files
    # (tests/test_torch_resilience.py, tests/test_torch_elastic.py)
    from mxnet_tpu_torch.resilience import CheckpointManager
    assert tr.attach_checkpoint_manager(
        CheckpointManager(str(tmp_path / "mgr"))) is None
    tr.save_checkpoint_sharded(str(tmp_path / "sharded"))
    assert tr.load_checkpoint_sharded(str(tmp_path / "sharded")) \
        == tr._step_num
    tr.step(data, label)   # nothing above left the trainer broken


#: the full-size comparison: ResNet-50 v1 (224x224, 1000 classes) through
#: both packages' SPMDTrainer at SGD lr 0.1, momentum 0.9, wd 1e-4, bf16
#: over f32 masters, from the same Xavier weights, on one seeded batch of
#: R50_BATCH images.  R50_BATCH is 32, not the card run's 128: three
#: trainers at 128 take four times the activation memory.
R50_BATCH = 32
R50_STEPS = 20
# the first step's loss: both read the same weights and batch; bf16
# (2^-8 a rounding) compounds over 53 conv/BN layers (the card's own bf16
# vs f32 bound, chip_smoke.py RESNET_BF16_LOSS_RTOL)
R50_FIRST_LOSS_RTOL = 2.0 ** -6


@pytest.mark.slow
def test_resnet50_bounce_belongs_to_the_configuration():
    """The loss bounce of the card's ResNet-50 run (7.73, 5.33, ...,
    10.49, 5.61) at full width, in both packages.  Three trainers from the
    same weights: the port, the reference, and the port again with one
    weight moved by one bf16 ulp (the first entry of the first conv
    weight; a smaller move vanishes in the bf16 forward).  The first
    losses agree; the loss rises again after its first fall in both
    packages; and the port against its one-ulp twin parts as far as the
    port against the reference does (to a tenth of the loss or more
    within R50_STEPS steps): this configuration (lr 0.1 with momentum 0.9
    from initialisation on one batch) amplifies any rounding difference,
    so the gap between the packages after the first steps says nothing
    of a fault.  Several minutes on the CPU (the reference's bf16 step
    is the slow part)."""
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.convert import gluon_params_from_reference
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

    def port_net():
        net = tvision.get_model("resnet50_v1", classes=1000)
        net.initialize(mt.init.Xavier(), ctx=mt.cpu())
        net(mt.nd.array(x, ctx=mt.cpu()))
        return net

    x = np.zeros((1, 3, 224, 224), np.float32)
    mt.random.seed(0)
    tnet = port_net()
    twin = port_net()
    weights = gluon_params_to_reference(tnet, "")
    conv = next(n for n in sorted(weights) if "conv" in n
                and n.endswith("weight"))
    w = weights[conv].reshape(-1)
    w0 = float(torch.tensor(float(w[0])).bfloat16())
    w[0] = w0 + 2.0 ** (np.floor(np.log2(abs(w0))) - 7)
    gluon_params_from_reference(twin, weights, prefix="")
    jnet = jvision.get_model("resnet50_v1", classes=1000)
    jnet.initialize(jmx.init.Zero())
    jnet(jmx.nd.array(x))
    jp = jnet.collect_params()
    for name, val in gluon_params_to_reference(tnet, jnet.prefix).items():
        jp[name].set_data(jmx.nd.array(val))
    rng = np.random.RandomState(0)
    data = rng.uniform(size=(R50_BATCH, 3, 224, 224)).astype(np.float32)
    label = rng.randint(0, 1000, (R50_BATCH,)).astype(np.float32)
    with _Tier(True):
        tr, jr = _trainers(tnet, jnet, dtype="bfloat16")
        tw = SPMDTrainer(twin, SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
                         mesh=make_mesh({"dp": -1}, [mt.cpu()]),
                         dtype="bfloat16")
        losses = np.asarray([(float(tr.step(data, label)),
                              float(jr.step(data, label)),
                              float(tw.step(data, label)))
                             for _ in range(R50_STEPS)])
    ours, theirs, twins = losses.T
    assert np.all(np.isfinite(losses)), losses
    assert abs(ours[0] - theirs[0]) <= R50_FIRST_LOSS_RTOL * theirs[0]
    for curve in (ours, theirs):
        assert curve[1] < curve[0] and curve[2:6].max() > curve[1], losses
    to_ref = np.abs(ours - theirs) / theirs
    to_twin = np.abs(ours - twins) / twins
    print("losses (port, reference, port with one bf16 ulp moved):\n%s\n"
          "gap to the reference %s\ngap to the twin %s"
          % (losses, to_ref, to_twin))
    assert to_twin.max() >= 0.1, (to_twin, losses)
