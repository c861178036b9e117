"""Parallel training (counterpart of ``mxnet_tpu.parallel``) over
``torch.distributed``, one process a device: the rendezvous
(``initialize``, ``ensure_initialized``) and host collectives
(``host_allreduce``, ``host_allgather``, ``barrier``) of
:mod:`.dist`; meshes over ranks (:mod:`.mesh`); ``functionalize``;
``SPMDTrainer`` with its data-parallel, row-sparse embedding and 2-bit
compressed steps; the sharded embedding primitives (:mod:`.embedding`);
and the plain attention lowering (``ring_attention.attention``).  Ring
attention over a sequence axis, pipeline and expert parallelism come
with a later slice."""
from .dist import (initialize, ensure_initialized, barrier,  # noqa: F401
                   host_allreduce, host_allgather)
from .mesh import (AXES, Mesh, make_mesh, data_parallel_mesh,  # noqa: F401
                   sharding, shard_batch, replicated, local_mesh_devices,
                   NamedSharding, PartitionSpec)
from .functional import functionalize, BlockFunction  # noqa: F401
from .ring_attention import attention  # noqa: F401
from .trainer import SPMDTrainer, build_train_step  # noqa: F401
from .embedding import (ShardedEmbedding, dedup_ids,  # noqa: F401
                        lookup_unique, update_unique)

__all__ = ["AXES", "make_mesh", "data_parallel_mesh", "sharding",
           "shard_batch", "replicated", "Mesh", "NamedSharding",
           "PartitionSpec", "attention", "functionalize", "BlockFunction",
           "SPMDTrainer", "build_train_step", "host_allreduce",
           "host_allgather", "initialize", "ensure_initialized", "barrier",
           "ShardedEmbedding", "dedup_ids", "lookup_unique",
           "update_unique", "local_mesh_devices"]
