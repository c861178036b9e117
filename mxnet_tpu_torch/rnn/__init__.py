"""``mx.rnn``: legacy symbolic RNN cells, checkpoints, and bucketing IO
(counterpart of ``mxnet_tpu.rnn``; reference:
python/mxnet/rnn/__init__.py).  The pre-Gluon recurrent API:
cells build unrolled Symbol graphs for Module/BucketingModule; Gluon
code should use ``mx.gluon.rnn`` instead."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
