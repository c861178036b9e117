"""Vision model zoo (counterpart of
``mxnet_tpu.gluon.model_zoo.vision``).  Ported: ResNet v1 and v2 at every
depth.  The reference's other families (VGG, AlexNet, DenseNet,
SqueezeNet, Inception, MobileNet) are not ported yet: ``get_model``
raises ``NotImplementedError`` for their names."""
from .resnet import *  # noqa: F401,F403
from .resnet import (resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
                     resnet101_v2, resnet152_v2)

_MODELS = {"resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
           "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
           "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
           "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
           "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2}
# the reference's zoo names whose models are not ported yet
_NOT_PORTED = ("vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
               "vgg16_bn", "vgg19_bn", "alexnet", "densenet121",
               "densenet161", "densenet169", "densenet201", "squeezenet1.0",
               "squeezenet1.1", "inceptionv3", "mobilenet1.0",
               "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
               "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
               "mobilenetv2_0.25")


def get_model(name, **kwargs):
    """A model of the zoo by name (reference ``vision/__init__.py:89``)."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise NotImplementedError("model %s is not ported yet" % name)
    if name not in _MODELS:
        raise ValueError("Model %s is not supported. Available options are"
                         "\n\t%s" % (name, "\n\t".join(sorted(_MODELS))))
    return _MODELS[name](**kwargs)
