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
           "torch_dtype", "canonical_dtype", "numpy_dtype", "bfloat16_numpy",
           "atomic_write", "string_types", "numeric_types"]

string_types = (str,)
numeric_types = (float, int, _np.generic)


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


_NARROW_64 = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.uint64: torch.uint32}


def canonical_dtype(dtype):
    """``torch_dtype(dtype)`` under the reference's 64-bit posture
    (``dtype_np``): with ``numpy.enable_x64`` off (the default) float64,
    int64 and uint64 become their 32-bit twins."""
    from . import config
    dt = torch_dtype(dtype)
    if not config.get("numpy.enable_x64"):
        dt = _NARROW_64.get(dt, dt)
    return dt


def bfloat16_numpy():
    """numpy's bfloat16 dtype from ``ml_dtypes`` (the reference's), or
    None when that package does not import."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return _np.dtype(ml_dtypes.bfloat16)


def numpy_dtype(dtype):
    """A ``torch.dtype`` as the numpy dtype the reference reports:
    bfloat16 is ``ml_dtypes.bfloat16``; without ``ml_dtypes`` numpy has no
    bfloat16, and ``torch.bfloat16`` stands in."""
    if dtype == torch.bfloat16:
        bf16 = bfloat16_numpy()
        return dtype if bf16 is None else bf16
    return torch.empty((), dtype=dtype).numpy().dtype


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
