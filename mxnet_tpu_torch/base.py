"""Error types and dtype names of the PyTorch/CUDA port (counterpart of
``mxnet_tpu.base``)."""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["MXNetError", "MXNetErrorNoDevice", "KernelUnsupportedError",
           "torch_dtype"]


class MXNetError(RuntimeError):
    """Framework-level error (parity with the reference's dmlc::Error)."""


class MXNetErrorNoDevice(MXNetError):
    """The entry point needs a CUDA device and none is visible.  Raised
    instead of silently running on the CPU: a caller that wants the CPU
    asks for it (``device="cpu"`` or ``mx.cpu()``)."""


class KernelUnsupportedError(MXNetError):
    """A hand-written kernel was handed CUDA tensors it cannot take (dtype,
    head dim, shape).  Raised instead of running the plain version on the
    card; ``kernels.enabled=False`` is the explicit way to run the plain
    version there."""


def torch_dtype(dtype):
    """A user-given dtype (``None``, a name such as ``"float32"`` or
    ``"bfloat16"``, a numpy dtype or type, a ``torch.dtype``) as a
    ``torch.dtype``; ``None`` is float32, as the reference's ``dtype_np``."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) in ("bfloat16", "bf16"):
        return torch.bfloat16
    return getattr(torch, _np.dtype(dtype).name)
