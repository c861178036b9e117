"""Ops of the port: the kernel tier (``cuda_kernels``), the op registry,
the registered ops (``tensor``, ``nn``, ``linalg``, ``random_ops``,
``optim_ops``, ``spatial``, ``signal``, ``misc`` and ``kernel_ops``),
which register on import, and ``control_flow`` (``mx.nd.contrib``'s
loops); ``misc`` adds the reference's legacy aliases, so it comes after
the ops they name."""
from . import registry, tensor, nn, linalg, random_ops, optim_ops  # noqa
from . import spatial, signal, control_flow  # noqa: F401
from . import misc, kernel_ops  # noqa: F401
