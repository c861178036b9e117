"""Per-row int8 quantisation of KV pages (counterpart of
``mxnet_tpu.quantization`` ``quantize_rows`` / ``dequantize_rows``).

Both packages divide in f32 and round half to even (``jnp.round`` and
``torch.round``), so the port's int8 rows and scales are bitwise the
reference's for the same input.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_rows", "dequantize_rows"]


def quantize_rows(x):
    """Symmetric per-row int8 over the last axis: returns
    ``(q int8, scale f32 without the last axis)`` with
    ``q.float() * scale[..., None] ~= x``.  Scale is ``amax / 127`` so the
    dequantisation inside the paged kernel is a single multiply."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_rows`: ``q int8 * scale -> dtype``."""
    return (q.float() * scale[..., None]).to(dtype)
