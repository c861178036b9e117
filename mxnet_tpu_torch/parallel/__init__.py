"""Parallel training (counterpart of ``mxnet_tpu.parallel``) over
``torch.distributed``, one process a device: the rendezvous
(``initialize``, ``ensure_initialized``) and host collectives
(``host_allreduce``, ``host_allgather``, ``barrier``) of
:mod:`.dist`; meshes over ranks (:mod:`.mesh`) and the differentiable
collectives over their axes (:mod:`.collectives`); ``functionalize``;
``SPMDTrainer`` with its data-parallel, row-sparse embedding, 2-bit
compressed and ``param_specs`` steps; the sharded embedding primitives
(:mod:`.embedding`); attention and ring attention over a sequence axis
(:mod:`.ring_attention`); pipeline parallelism (:mod:`.pipeline`) and
expert parallelism (:mod:`.moe`)."""
from .dist import (initialize, ensure_initialized, barrier,  # noqa: F401
                   host_allreduce, host_allgather)
from .mesh import (AXES, Mesh, make_mesh, data_parallel_mesh,  # noqa: F401
                   sharding, shard_batch, replicated, local_mesh_devices,
                   NamedSharding, PartitionSpec)
from .functional import functionalize, BlockFunction  # noqa: F401
from .ring_attention import (attention, ring_attention,  # noqa: F401
                             ring_self_attention_sharded)
from .trainer import SPMDTrainer, build_train_step  # noqa: F401
from .pipeline import (pipeline_apply, pipeline_sharded,  # noqa: F401
                       microbatch, unmicrobatch)
from .moe import moe_ffn, moe_ffn_sharded, top_k_routing  # noqa: F401
from .embedding import (ShardedEmbedding, dedup_ids,  # noqa: F401
                        lookup_unique, update_unique)

__all__ = ["AXES", "make_mesh", "data_parallel_mesh", "sharding",
           "shard_batch", "replicated", "Mesh", "NamedSharding",
           "PartitionSpec", "ring_attention", "attention",
           "ring_self_attention_sharded", "functionalize", "BlockFunction",
           "SPMDTrainer", "build_train_step", "host_allreduce",
           "host_allgather", "initialize", "ensure_initialized", "barrier",
           "pipeline_apply", "pipeline_sharded", "microbatch",
           "unmicrobatch", "moe_ffn", "moe_ffn_sharded", "top_k_routing",
           "ShardedEmbedding", "dedup_ids", "lookup_unique",
           "update_unique", "local_mesh_devices"]
