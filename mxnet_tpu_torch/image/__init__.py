"""``mx.image`` (counterpart of ``mxnet_tpu.image``): decoding,
augmentation and ``ImageIter``.  The detection augmenters and
``ImageDetIter`` (``image/detection.py``) are not ported yet."""
from .image import *  # noqa: F401,F403
from .image import __all__  # noqa: F401
