"""``mx.mod`` — the Module training API over the symbolic Executor
(counterpart of ``mxnet_tpu.module``; reference ``python/mxnet/module/``):
``Module``, ``BucketingModule``, ``SequentialModule``, ``PythonModule``
and ``PythonLossModule``."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule"]
