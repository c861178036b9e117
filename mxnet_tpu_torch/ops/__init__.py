"""Ops of the port: the kernel tier (``cuda_kernels``), the op registry and
the registered ops (``tensor``, ``nn``, ``linalg``, ``random_ops``,
``optim_ops``, ``misc`` and ``kernel_ops``), which register on import;
``misc`` adds the reference's legacy aliases, so it comes after the ops
they name."""
from . import registry, tensor, nn, linalg, random_ops, optim_ops  # noqa
from . import misc, kernel_ops  # noqa: F401
