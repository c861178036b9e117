"""``mx.executor`` (reference ``python/mxnet/executor.py``): the Executor
lives with the symbol layer; this module keeps the import path."""
from .symbol.symbol import Executor  # noqa: F401

__all__ = ["Executor"]
