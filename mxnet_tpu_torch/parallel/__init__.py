"""Parallel training (counterpart of ``mxnet_tpu.parallel``), on one
device: ``functionalize``, ``make_mesh`` / ``data_parallel_mesh``,
``SPMDTrainer``, and the plain attention lowering
(``ring_attention.attention``).  Ring attention over a sequence axis and
the multi-device meshes come with later slices."""
from .functional import functionalize, BlockFunction  # noqa: F401
from .mesh import Mesh, make_mesh, data_parallel_mesh  # noqa: F401
from .trainer import SPMDTrainer  # noqa: F401
