"""Error types, dtype names and the atomic file write of the PyTorch/CUDA
port (counterpart of ``mxnet_tpu.base``; ``atomic_write`` is the one
piece of ``mxnet_tpu.resilience`` the checkpoint files need)."""
from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as _np
import torch

__all__ = ["MXNetError", "MXNetErrorNoDevice", "KernelUnsupportedError",
           "torch_dtype", "atomic_write"]


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


@contextlib.contextmanager
def atomic_write(path, mode="wb"):
    """Write ``path`` atomically: the bytes go to a temporary file in the
    same directory, are flushed and fsynced, and only then renamed over
    ``path``.  A crash at any point leaves the previous file whole."""
    if mode not in ("wb", "w"):
        raise ValueError("atomic_write takes mode 'wb' or 'w', got %r"
                         % (mode,))
    path = os.fspath(path)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.",
                               dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
