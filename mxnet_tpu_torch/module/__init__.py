"""``mx.mod`` — the Module training API over the symbolic Executor
(counterpart of ``mxnet_tpu.module``; reference ``python/mxnet/module/``).
``BucketingModule``, ``SequentialModule`` and ``PythonModule`` are not
ported yet."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
