"""The model zoo's families in the port against the reference's on the
CPU, at their published widths (1000 classes) and the smallest input
each accepts, batch 1 or 2: the same parameter names, shapes and order
(the port's Xavier draws become the reference's values), and the logits
in inference and in training mode within ``_torch_gluon.ZOO_RTOL`` /
``ZOO_TRAIN_RTOL``.  The reference runs jitted (``_torch_gluon
._jit_reference``).  This file holds AlexNet,
VGG and SqueezeNet and every ``get_model`` name; Inception v3, DenseNet
and MobileNet have files of their own, so that ``--dist loadfile``
spreads them.

SqueezeNet runs at 227x227: the reference's ``Pooling`` ignores
``pooling_convention='full'`` (the ``ceil_mode`` of its pools), so at
224 its last feature map is 12x12 and ``AvgPool2D(13)`` has no window
(ROADMAP queue 3)."""
import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu_torch as mt

import _torch_gluon as G


@pytest.mark.parametrize("name,shape", [
    ("alexnet", (2, 3, 67, 67)),
    ("vgg11", (2, 3, 32, 32)),
    ("vgg16_bn", (2, 3, 32, 32)),
    ("squeezenet1.0", (1, 3, 227, 227)),
    ("squeezenet1.1", (2, 3, 227, 227)),
])
def test_zoo_family_matches_reference(name, shape):
    G.zoo_check(name, shape)


def test_every_zoo_name_builds_with_the_reference_names():
    """All 34 ``get_model`` names: the same parameter names in the same
    order, before any shape is known."""
    names = sorted(ref.gluon.model_zoo.vision.get_model.__code__.co_consts
                   and mt.gluon.model_zoo.vision._MODELS)
    assert len(names) == 34
    for name in names:
        with ref.name.NameManager():
            rb = ref.gluon.model_zoo.vision.get_model(name, classes=7)
        with mt.name.NameManager():
            pb = mt.gluon.model_zoo.vision.get_model(name, classes=7)
        assert list(rb.collect_params().keys()) == \
            list(pb.collect_params().keys()), name
    with pytest.raises(ValueError):
        mt.gluon.model_zoo.vision.get_model("resnet7_v1")


def test_vgg_depths_have_the_published_layer_counts():
    counts = {}
    for name in ("vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
                 "vgg19_bn"):
        with mt.name.NameManager():
            net = mt.gluon.model_zoo.vision.get_model(name)
        counts[name] = sum(1 for n in net.collect_params()
                           if n.endswith("weight"))
    # convolutions + 3 dense layers; a BatchNorm's gamma is not a weight
    assert counts == {"vgg11": 11, "vgg13": 13, "vgg16": 16, "vgg19": 19,
                      "vgg11_bn": 11, "vgg19_bn": 19}
    np.testing.assert_equal(len(counts), 6)


# ------------------------------------------- VGG-16's divergence at lr 0.1
VGG_BATCH = 8
VGG_STEPS = 11
VGG_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# the first step's loss: the same weights and batch; bf16 (2^-8 a
# rounding) over 16 layers (chip_smoke.py RESNET_BF16_LOSS_RTOL)
VGG_FIRST_LOSS_RTOL = 2.0 ** -6
# diverged: non-finite, or a hundred times the first loss
VGG_BLOWUP = 100.0


def _blowup_step(losses):
    """The first step whose loss is non-finite or VGG_BLOWUP x the
    first, else None."""
    for k, v in enumerate(losses):
        if not np.isfinite(v) or v > VGG_BLOWUP * losses[0]:
            return k
    return None


@pytest.mark.slow
def test_vgg16_divergence_belongs_to_the_configuration():
    """The card's VGG-16 run of ``examples/train_imagenet.py --benchmark
    1`` (BS 128, bf16, SGD lr 0.1, momentum 0.9, wd 1e-4) loses its loss
    to inf and NaN within 10 steps (PERF.md).  The same configuration at
    BS 8 on the CPU, from the same Xavier weights and a seeded batch, in
    both packages: the first losses agree, and both blow up within
    VGG_STEPS steps, so the divergence is the configuration's (VGG-16
    has no BatchNorm; its paper trains at lr 0.01), not the port's.
    Minutes on the CPU."""
    import jax
    from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JLoss
    from mxnet_tpu.parallel import SPMDTrainer as JTrainer
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    x = np.zeros((1, 3, 224, 224), np.float32)
    mt.random.seed(0)
    with mt.name.NameManager():
        tnet = mt.gluon.model_zoo.vision.get_model("vgg16", classes=1000)
    tnet.initialize(mt.init.Xavier(), ctx=mt.cpu())
    with mt.cpu():
        tnet(mt.nd.array(x))
    with ref.name.NameManager():
        jnet = ref.gluon.model_zoo.vision.get_model("vgg16", classes=1000)
    jnet.initialize(ref.init.Zero())
    jnet(ref.nd.array(x))
    jp = jnet.collect_params()
    for name, p in tnet.collect_params().items():
        jp[name].set_data(ref.nd.array(p.data().asnumpy()))
    rng = np.random.RandomState(0)
    data = rng.uniform(size=(VGG_BATCH, 3, 224, 224)).astype(np.float32)
    label = rng.randint(0, 1000, (VGG_BATCH,)).astype(np.float32)
    tr = SPMDTrainer(tnet, SoftmaxCrossEntropyLoss(), "sgd", dict(VGG_OPT),
                     mesh=make_mesh({"dp": -1}, [mt.cpu()]),
                     dtype="bfloat16")
    jr = JTrainer(jnet, JLoss(), "sgd", dict(VGG_OPT),
                  mesh=jmake_mesh({"dp": -1}, jax.devices()[:1]),
                  dtype="bfloat16")
    ours = [float(tr.step(data, label)) for _ in range(VGG_STEPS)]
    theirs = [float(jr.step(data, label)) for _ in range(VGG_STEPS)]
    print("losses (port, reference):\n%s" % np.asarray([ours, theirs]).T)
    assert abs(ours[0] - theirs[0]) <= VGG_FIRST_LOSS_RTOL * theirs[0]
    assert _blowup_step(ours) is not None, ours
    assert _blowup_step(theirs) is not None, theirs
