"""Plain softmax attention (counterpart of
``mxnet_tpu.parallel.ring_attention`` ``_block_attn`` / ``attention``).

This is the lowering every attention call takes with the kernel tier off.
Ring attention over a sequence-parallel mesh axis is ported in a later
slice.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention"]

_NEG = -1e30


def _block_attn(q, k, v, scale, mask):
    """One q-block x kv-block partial attention: returns
    ``(o_partial, m, l)`` — un-normalised output, row max, row sum.
    Masked scores pin to ``-1e30``, so with a real row max their ``exp``
    underflows to an exact 0."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(v.dtype), v)
    return o, m, l


def attention(q, k, v, causal=False, scale=None):
    """Single-device softmax attention, q/k/v ``[..., S, D]``; f32 scores
    and statistics."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    mask = None
    if causal:
        sq, sk = q.shape[-2], k.shape[-2]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
    o, m, l = _block_attn(q, k, v, scale, mask)
    return (o / l.to(o.dtype)).to(q.dtype)
