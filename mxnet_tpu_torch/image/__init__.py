"""``mx.image`` (counterpart of ``mxnet_tpu.image``): decoding,
augmentation, ``ImageIter`` and the detection augmenters
(``image/detection.py``)."""
from .image import *  # noqa: F401,F403
from .image import __all__ as _image_all
from .detection import *  # noqa: F401,F403
from .detection import __all__ as _det_all

__all__ = list(_image_all) + list(_det_all)
