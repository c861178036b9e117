"""Ops of the port: the kernel tier (``cuda_kernels``), the op registry and
the registered ops (``nn``, ``tensor``, ``kernel_ops``), which register on
import."""
from . import registry, nn, tensor, kernel_ops  # noqa: F401
