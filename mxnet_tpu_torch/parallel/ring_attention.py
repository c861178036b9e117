"""Attention: the plain lowering, and ring attention over a sequence
axis (counterpart of ``mxnet_tpu.parallel.ring_attention``).

:func:`attention` is the lowering every attention call takes with the
kernel tier off.  :func:`ring_attention` is sequence parallelism: each
rank of the ``sp`` axis holds one contiguous block of the sequence, and
the key/value blocks travel around the ring, one :func:`ppermute` of K
and V together a hop, while each rank accumulates the online softmax of
its query block (the reference's order and guards: ``_NEG`` scores, the
``corr`` / ``corr_b`` combine, ``max(l, 1e-30)``).  The causal mask is
built from global positions.  The reference's ring is plain XLA (no
Pallas kernel), so this one is PyTorch ops and collectives.

The reference calls :func:`ring_attention` inside ``shard_map``; here the
mesh's groups take its place, so it takes the ``mesh``.
:func:`ring_self_attention_sharded` takes and returns whole ``[B, H, S,
D]`` arrays on every rank (batch over ``dp``, heads over ``tp``,
sequence over ``sp``, in ``mesh.shard_batch``'s block convention).
"""
from __future__ import annotations

import math

import torch

from . import collectives as _coll

__all__ = ["attention", "ring_attention", "ring_self_attention_sharded"]

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


def ring_attention(q, k, v, axis_name="sp", causal=False, scale=None, *,
                   mesh):
    """Ring attention over ``axis_name`` of ``mesh``: q/k/v are this
    rank's sequence blocks ``[B, H, S_loc, D]`` (block ``i`` of the
    sequence on the rank at index ``i``); the result is full attention
    over the whole sequence, at this rank's query rows."""
    d = q.shape[-1]
    s_loc = q.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n = mesh.shape[axis_name]
    my = mesh.axis_index(axis_name)
    o = torch.zeros(q.shape[:-1] + (d,), dtype=torch.float32,
                    device=q.device)
    m = torch.full(q.shape[:-1] + (1,), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    kv = torch.stack([k, v])
    rows = torch.arange(s_loc, device=q.device)
    for step in range(n):
        src = (my - step) % n
        mask = None
        if causal:
            mask = (src * s_loc + rows)[None, :] <= (my * s_loc + rows)[:, None]
        ob, mb, lb = _block_attn(q, kv[0], kv[1], scale, mask)
        m_new = torch.maximum(m, mb)
        corr = torch.exp(m - m_new)
        corr_b = torch.exp(mb - m_new)
        o = o * corr + ob.float() * corr_b
        l = l * corr + lb * corr_b
        m = m_new
        if step + 1 < n:
            # one hop around the ring; the last hop's blocks would go
            # unread, so it is not taken
            kv = _coll.ppermute(kv, mesh, axis_name, 1)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def ring_self_attention_sharded(mesh, q, k, v, causal=False,
                                batch_axis="dp", head_axis="tp",
                                seq_axis="sp"):
    """Ring attention over whole ``[B, H, S, D]`` arrays whose axes are
    split batch over ``batch_axis``, heads over ``head_axis`` and sequence
    over ``seq_axis``: every rank passes the whole arrays and gets the
    whole result (its gradient flows back whole to every rank)."""
    spec = tuple(a if a in mesh.axis_names else None
                 for a in (batch_axis, head_axis, seq_axis)) + (None,)
    q, k, v = (_coll.shard(t, mesh, spec) for t in (q, k, v))
    if spec[2] is None:
        out = attention(q, k, v, causal=causal)
    else:
        out = ring_attention(q, k, v, axis_name=seq_axis, causal=causal,
                             mesh=mesh)
    return _coll.unshard(out, mesh, spec)
