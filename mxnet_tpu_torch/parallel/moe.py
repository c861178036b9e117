"""Mixture-of-Experts with expert parallelism over a mesh axis
(counterpart of ``mxnet_tpu.parallel.moe``).

The experts are split over the ``ep`` axis and tokens travel to their
expert's rank through one pair of :func:`collectives.all_to_all` calls
(dispatch and return), in the Switch/GShard layout: static shapes, with
capacity slots in place of dynamic gathers.  Routing is top-k softmax
gating with a per-expert capacity; a token past its expert's capacity is
dropped (its combine weight is 0).  The op order is the reference's:
the f32 softmax, ``argmax`` taking the first maximum, one-hot ``cumsum``
slots, capacity ``max(1, int(capacity_factor * k * t / e))``, and the
same reshapes and transposes around the two ``all_to_all``s.  The
default activation is the tanh approximation of GELU, as ``jax.nn.gelu``
defaults to.

The reference calls :func:`moe_ffn` inside ``shard_map``; here the
mesh's groups take its place, so it takes the ``mesh``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import collectives as _coll

__all__ = ["moe_ffn", "moe_ffn_sharded", "top_k_routing"]

_gelu = functools.partial(F.gelu, approximate="tanh")


def _one_hot(idx, n):
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row (``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k_routing(logits, k, capacity):
    """Static-shape top-k routing: ``logits [T, E]`` -> ``(dispatch [T, E,
    C]`` one-hot slots, ``combine [T, E, C]`` gate weights, ``aux`` the
    Switch load-balancing loss)."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    dispatch = torch.zeros((t, e, capacity), device=logits.device)
    combine = torch.zeros_like(dispatch)
    # the slots each expert has given out, over the k passes, so a later
    # choice never takes a slot an earlier one holds
    base = torch.zeros((e,), dtype=torch.int32, device=logits.device)
    masked = probs
    for _ in range(k):
        choice = torch.argmax(masked, dim=-1)
        onehot = _one_hot(choice, e)
        pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot
        pos = pos + base[None, :] * onehot
        keep = (pos < capacity) * onehot
        slot = _one_hot(pos.to(torch.int32), capacity) * keep[..., None]
        gate = torch.sum(probs * onehot, dim=-1, keepdim=True)
        dispatch = dispatch + slot
        combine = combine + slot * gate[..., None]
        base = base + torch.sum(keep, dim=0).to(torch.int32)
        masked = masked * (1.0 - onehot)
    frac = torch.mean(_one_hot(torch.argmax(probs, dim=-1), e), dim=0)
    aux = e * torch.sum(frac * torch.mean(probs, dim=0))
    return dispatch, combine, aux


def moe_ffn(gate_w, w1, b1, w2, b2, x, axis_name="ep", k=2,
            capacity_factor=2.0, activation=_gelu, *, mesh):
    """Expert-parallel MoE feed-forward over ``axis_name`` of ``mesh``:
    ``x [T, d]`` this rank's tokens, ``gate_w [d, E]`` (every rank's),
    ``w1 [E_loc, d, h]``, ``b1 [E_loc, h]``, ``w2 [E_loc, h, d]``, ``b2
    [E_loc, d]`` this rank's experts (``E = E_loc * n_ep``).  Returns
    ``(y [T, d], aux)``."""
    n_ep = mesh.shape[axis_name]
    e_loc = w1.shape[0]
    e = e_loc * n_ep
    t, d = x.shape
    capacity = max(1, int(capacity_factor * k * t / e))

    logits = torch.matmul(x.float(), gate_w.float())
    dispatch, combine, aux = top_k_routing(logits, k, capacity)
    # every expert's capacity buffer [E, C, d], as (n_ep groups of E_loc)
    buf = torch.einsum("tec,td->ecd", dispatch, x.float())
    buf = buf.reshape(n_ep, e_loc, capacity, d)
    # after the exchange this rank holds its experts' slots from every rank
    buf = _coll.all_to_all(buf, mesh, axis_name)
    buf = buf.transpose(0, 1).reshape(e_loc, n_ep * capacity, d)

    h = activation(torch.einsum("ecd,edh->ech", buf, w1.float())
                   + b1[:, None, :].float())
    y = torch.einsum("ech,ehd->ecd", h, w2.float()) + b2[:, None, :].float()

    # the return trip: the inverse reshuffle and exchange
    y = y.reshape(e_loc, n_ep, capacity, d).transpose(0, 1)
    y = _coll.all_to_all(y, mesh, axis_name)
    y = y.reshape(e, capacity, d)
    out = torch.einsum("tec,ecd->td", combine, y)
    return out.to(x.dtype), aux


def moe_ffn_sharded(mesh, gate_w, w1, b1, w2, b2, x, axis_name="ep",
                    batch_axis="dp", k=2, capacity_factor=2.0,
                    activation=_gelu):
    """Whole-array wrapper: the tokens ``x [T, d]`` split over the data
    and expert axes together (every rank routes its own block, so the
    exchanges move distinct data), the expert weights ``[E, ...]`` over
    ``axis_name``, ``gate_w`` on every rank.  Returns the whole ``y [T,
    d]`` and the aux loss averaged over the mesh, on every rank; the
    gradients of the inputs come back whole on every rank."""
    tok_axes = tuple(a for a in (batch_axis, axis_name)
                     if a in mesh.axis_names)
    xs = _coll.shard(x, mesh, (tok_axes,))
    gw = _coll.shard(gate_w, mesh, (), sum_axes=tok_axes)
    experts = [_coll.shard(w, mesh, (axis_name,), sum_axes=tok_axes)
               for w in (w1, b1, w2, b2)]
    y, aux = moe_ffn(gw, *experts, xs, axis_name=axis_name, k=k,
                     capacity_factor=capacity_factor, activation=activation,
                     mesh=mesh)
    return (_coll.unshard(y, mesh, (tok_axes,)),
            _coll.pmean(aux, mesh, mesh.axis_names))
