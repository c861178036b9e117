"""Devices (counterpart of ``mxnet_tpu.context``).

``mx.gpu(i)`` / ``mx.cpu()`` name a ``torch.device``.  The default device
is ``cuda:0``; when no CUDA device is visible, resolving the default (or
any ``gpu`` context) raises :class:`MXNetErrorNoDevice` rather than
falling back to the CPU.  ``with mx.cpu():`` makes a context the default
for the code inside, as in the reference.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetErrorNoDevice

__all__ = ["Context", "cpu", "gpu", "num_gpus", "resolve_device",
           "current_context"]

_DEFAULT = threading.local()  # .stack: contexts entered with ``with``


class Context:
    """A device context; compares by (device_type, device_id)."""

    def __init__(self, device_type, device_id=0):
        if device_type not in ("cpu", "gpu"):
            raise ValueError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self):
        if self.device_type == "cpu":
            return torch.device("cpu")
        n = num_gpus()
        if n == 0:
            raise MXNetErrorNoDevice(
                "%r needs a CUDA device and none is visible; pass "
                "device='cpu' (or mx.cpu()) to run on the CPU" % (self,))
        if self.device_id >= n:
            raise MXNetErrorNoDevice("%r out of range: %d CUDA device(s)"
                                     % (self, n))
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        _DEFAULT.__dict__.setdefault("stack", []).append(self)
        return self

    def __exit__(self, *exc):
        _DEFAULT.stack.pop()

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The innermost context entered with ``with``, else ``gpu(0)``."""
    stack = getattr(_DEFAULT, "stack", None)
    return stack[-1] if stack else gpu(0)


def resolve_device(device=None):
    """``None`` -> the current context (``cuda:0`` unless a ``with ctx:``
    says otherwise; raises without a GPU); a :class:`Context`, a
    ``torch.device`` or a device string -> ``torch.device``."""
    if device is None:
        return current_context().torch_device
    if isinstance(device, Context):
        return device.torch_device
    dev = torch.device(device)
    if dev.type == "cuda":
        return gpu(dev.index or 0).torch_device
    return dev
