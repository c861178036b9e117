"""2-bit gradient compression with an error-feedback residual
(counterpart of ``mxnet_tpu.parallel.compression``).

Each gradient element becomes a code in {-1, 0, +1} (``codes *
threshold`` is the decompressed gradient), the quantization error carries
into a residual added back at the next step, and the wire carries four
codes a byte: 1/16 of the f32 bytes.  Codes and residuals are exact
functions of their inputs, so each function here is bitwise the
reference's.
"""
from __future__ import annotations

import torch

from .. import telemetry as _telemetry

__all__ = ["two_bit_compress", "two_bit_decompress", "pack_2bit",
           "unpack_2bit", "note_wire"]


def two_bit_compress(grad, residual, threshold):
    """``(grad, residual) -> (codes int8 in {-1, 0, +1}, new_residual)``:
    ``g = grad + residual`` is coded +1 at or above ``threshold``, -1 at
    or below ``-threshold``, else 0, and ``g - codes * threshold`` is the
    new residual."""
    g = grad + residual
    codes = ((g >= threshold).to(torch.int8)
             - (g <= -threshold).to(torch.int8))
    return codes, g - codes.to(g.dtype) * threshold


def two_bit_decompress(codes, threshold, dtype=torch.float32):
    return codes.to(dtype) * threshold


def pack_2bit(codes):
    """int8 codes {-1, 0, 1} (any shape) -> uint8 ``[ceil(n/4)]``, four
    codes a byte, the first in the low bits; -1 is written as 2."""
    flat = codes.reshape(-1)
    n = flat.numel()
    u = torch.where(flat < 0, 2, flat.to(torch.int16)).to(torch.uint8)
    q = torch.zeros(((n + 3) // 4) * 4, dtype=torch.uint8,
                    device=flat.device)
    q[:n] = u
    q = q.reshape(-1, 4)
    return q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)


def unpack_2bit(packed, n):
    """uint8 wire bytes -> int8 codes ``[n]``."""
    p = packed.to(torch.uint8)
    parts = torch.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3],
                        dim=1).reshape(-1)[:n]
    return torch.where(parts == 2, -1, parts.to(torch.int8)).to(torch.int8)


def note_wire(packed_bytes, raw_bytes):
    """Count one compressed hop: ``kvstore.compressed_bytes`` (the packed
    codes sent), ``kvstore.compressed_raw_bytes`` (their f32 bytes) and
    the running ``kvstore.compression_ratio``."""
    comp = _telemetry.counter("kvstore.compressed_bytes")
    raw = _telemetry.counter("kvstore.compressed_raw_bytes")
    comp.inc(packed_bytes)
    raw.inc(raw_bytes)
    if comp.value:
        _telemetry.gauge("kvstore.compression_ratio").set(
            raw.value / comp.value)
