"""``gluon.data`` (counterpart of ``mxnet_tpu.gluon.data``; reference
``python/mxnet/gluon/data/``): datasets, samplers, ``DataLoader`` and the
vision datasets and transforms."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision  # noqa: F401
from .vision import transforms  # noqa: F401
