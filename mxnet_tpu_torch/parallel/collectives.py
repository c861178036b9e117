"""Differentiable collectives over mesh axes (what ``lax.psum``,
``lax.ppermute`` and ``lax.all_to_all`` do inside the reference's
``shard_map``; ``Mesh.axis_index`` and ``Mesh.axis_size`` stand for
``lax.axis_index`` and ``lax.psum(1, axis)``).

One process a rank: a collective over axes ``a`` runs in the process
group of the ranks that differ from this one only along ``a``
(``Mesh.group``); over axes of one rank in all it is the identity and
calls nothing.  Every rank of a group must call the same collectives in
the same order, forward and backward; the functions here are
``torch.autograd.Function``s whose backward is the transpose the
reference's autodiff takes:

- :func:`psum` sums over the axes; its result is the same on every rank
  of the group and each rank differentiates its own copy, so the
  backward is the identity (Megatron's "g", and a loss's mean over the
  batch ranks).  :func:`copy_to` is its conjugate: the identity forward
  and a sum of the cotangents backward (Megatron's "f", before a
  column-split matmul).
- :func:`psum_summed` sums forward and backward: the sum over the axes
  feeds every rank's share of one loss (BatchNorm's batch statistics
  over the batch ranks), so each rank's cotangent is partial and the
  ranks' cotangents are summed.
- :func:`ppermute` rotates along one axis (rank ``i`` sends to ``i +
  shift``); its backward is the reverse rotation.
- :func:`all_to_all` exchanges the blocks of the first dimension (the
  reference's ``tiled=False``, ``split_axis=concat_axis=0``); it is its
  own transpose.
- :func:`broadcast_last` is the pipeline's masked ``psum``: the last
  rank's value on every rank; the backward routes the cotangent to the
  last rank only.
- :func:`shard` takes this rank's block of a whole tensor by a
  PartitionSpec; its backward sums the cotangent over ``sum_axes`` (the
  axes whose ranks computed on other data) and gathers the blocks whole
  again.  :func:`unshard` gathers the blocks whole; its backward takes
  this rank's block of the cotangent, summed over the spec's axes first
  with ``summed=True`` (each rank's use of the whole is its share of one
  loss).

Routes.  NCCL takes every collective where the tensor lies.  gloo runs
``all_reduce``, ``all_gather``, ``broadcast`` and ``all_to_all_single``
of CUDA tensors itself, and refuses send and receive of them (on the
H100 with PyTorch 2.11, ``batch_isend_irecv`` of a CUDA tensor fails
with ``writev ... Bad address``: ``chip_smoke.py --phase mesh`` (a)
probes each op).  So :func:`ppermute` of a CUDA tensor under gloo copies
it through pinned host memory: the backend and the tensor's device
choose the route (:func:`route`), never a caught failure, and each call
counts in the telemetry counter ``collectives.<op>.<route>``
(``native`` or ``host``).
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from .. import telemetry as _telemetry
from . import dist as _dist
from .mesh import _spec_axes

__all__ = ["route", "psum", "psum_summed", "pmean", "copy_to", "ppermute", "all_to_all",
           "broadcast_last", "shard", "unshard", "local_block",
           "GLOO_CUDA_NATIVE"]

#: the collectives gloo runs on CUDA tensors itself
GLOO_CUDA_NATIVE = frozenset({"all_reduce", "all_gather", "broadcast",
                              "all_to_all"})


def route(op, t):
    """``"host"`` when ``op`` of tensor ``t`` goes through pinned host
    memory (gloo and a CUDA tensor, and an op gloo does not run on CUDA
    tensors), else ``"native"``."""
    if t.device.type == "cuda" and _dist.backend() == "gloo" \
            and op not in GLOO_CUDA_NATIVE:
        return "host"
    return "native"


def _note(op, t):
    r = route(op, t)
    _telemetry.counter("collectives.%s.%s" % (op, r)).inc()
    return r


def _pinned_copy(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


# ------------------------------------------------------------ raw ops
def _all_reduce(x, mesh, axes):
    out = x.contiguous().clone()
    _note("all_reduce", out)
    _dist.all_reduce_(out, group=mesh.group(axes))
    return out


def _all_gather(x, mesh, axes):
    """``[n, *x.shape]``: every member's ``x`` in block order along
    ``axes`` (``Mesh.block_index``)."""
    _note("all_gather", x)
    parts = _dist.all_gather(x.contiguous(), group=mesh.group(axes))
    order = [mesh.block_index(_spec_axes(axes), r)
             for r in mesh.members(axes)]
    if order == sorted(order):
        return parts
    return parts[torch.as_tensor(sorted(range(len(order)),
                                        key=order.__getitem__),
                                 device=parts.device)]


def _ppermute(x, mesh, axis, shift):
    n = mesh.shape[axis]
    c = mesh.coords()
    dst = mesh.rank_of({**c, axis: (c[axis] + shift) % n})
    src = mesh.rank_of({**c, axis: (c[axis] - shift) % n})
    send = x.contiguous()
    staged = _note("ppermute", send) == "host"
    if staged:
        send = _pinned_copy(send)
    recv = torch.empty_like(send)
    group = mesh.group((axis,))
    ops = [tdist.P2POp(tdist.isend, send, dst, group),
           tdist.P2POp(tdist.irecv, recv, src, group)]
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device) if staged else recv


def _all_to_all(x, mesh, axis):
    src = x.contiguous()
    _note("all_to_all", src)
    out = torch.empty_like(src)
    tdist.all_to_all_single(out, src, group=mesh.group((axis,)))
    return out


def local_block(x, mesh, spec):
    """This rank's block of ``x`` by ``spec`` (one entry a dimension: None,
    an axis or a tuple of axes; the blocks are contiguous, in
    ``Mesh.block_index`` order)."""
    for d, part in enumerate(spec):
        axes = _spec_axes(part)
        n = mesh.axis_size(axes)
        if n == 1:
            continue
        size = x.shape[d]
        if size % n:
            raise ValueError("dimension %d (%d) does not split over %s (%d "
                             "blocks)" % (d, size, axes, n))
        b = size // n
        x = x.narrow(d, mesh.block_index(axes) * b, b)
    return x


def _gather_blocks(x, mesh, spec):
    for d, part in enumerate(spec):
        axes = _spec_axes(part)
        if mesh.axis_size(axes) == 1:
            continue
        parts = _all_gather(x, mesh, axes)
        x = torch.cat(list(parts.unbind(0)), dim=d)
    return x


def _live(mesh, axes):
    """``axes`` of more than one rank, in the mesh's order."""
    axes = _spec_axes(axes)
    return tuple(a for a in mesh.axis_names if a in axes
                 and mesh.shape[a] > 1)


# ------------------------------------------------------ autograd ops
class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _ppermute(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh, ctx.axis), None, None


class _BroadcastLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, axis):
        ctx.last = mesh.axis_index(axis) == mesh.shape[axis] - 1
        return _all_reduce(y if ctx.last else torch.zeros_like(y), mesh,
                           (axis,))

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec, sum_axes):
        ctx.mesh, ctx.spec, ctx.sum_axes = mesh, spec, sum_axes
        out = local_block(x, mesh, spec)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_axes:
            g = _all_reduce(g, ctx.mesh, ctx.sum_axes)
        return _gather_blocks(g, ctx.mesh, ctx.spec), None, None, None


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec, sums):
        ctx.mesh, ctx.spec, ctx.sums = mesh, spec, sums
        return _gather_blocks(x, mesh, spec)

    @staticmethod
    def backward(ctx, g):
        if ctx.sums:
            g = _all_reduce(g, ctx.mesh, ctx.sums)
        return local_block(g, ctx.mesh, ctx.spec).contiguous(), None, None, \
            None


# ------------------------------------------------------------ the API
def psum(x, mesh, axes):
    """The sum of ``x`` over the ranks along ``axes``, on each of them;
    backward the identity (module doc)."""
    axes = _live(mesh, axes)
    return _Psum.apply(x, mesh, axes) if axes else x


def psum_summed(x, mesh, axes):
    """The sum of ``x`` over the ranks along ``axes``, on each of them;
    backward the sum of the cotangents over the same ranks (module
    doc)."""
    axes = _live(mesh, axes)
    return _PsumSummed.apply(x, mesh, axes) if axes else x


def pmean(x, mesh, axes):
    """:func:`psum` divided by the number of ranks along ``axes``."""
    n = mesh.axis_size(axes)
    return psum(x, mesh, axes) / n if n > 1 else x


def copy_to(x, mesh, axes):
    """``x`` itself; backward the sum of the cotangents over ``axes``."""
    axes = _live(mesh, axes)
    return _CopyTo.apply(x, mesh, axes) if axes else x


def ppermute(x, mesh, axis, shift=1):
    """Rank ``i`` along ``axis`` receives rank ``i - shift``'s ``x`` (the
    reference's ``perm=[(i, (i + shift) % n)]``)."""
    if mesh.shape[axis] == 1:
        return x
    return _PPermute.apply(x, mesh, axis, int(shift))


def all_to_all(x, mesh, axis):
    """``x [n, ...]`` (``n`` ranks along ``axis``): block ``j`` goes to
    rank ``j`` and the result's block ``j`` is rank ``j``'s block ``i``
    (``lax.all_to_all(x, axis, 0, 0, tiled=False)``)."""
    n = mesh.shape[axis]
    if x.shape[0] != n:
        raise ValueError("all_to_all over %r: the first dimension (%d) must "
                         "be the axis size %d" % (axis, x.shape[0], n))
    return _AllToAll.apply(x, mesh, axis) if n > 1 else x


def broadcast_last(y, mesh, axis):
    """The last rank's ``y`` along ``axis`` on every rank of it: the
    reference's ``psum(where(idx == n - 1, y, 0))``; backward the
    cotangent on the last rank only."""
    if mesh.shape[axis] == 1:
        return y
    return _BroadcastLast.apply(y, mesh, axis)


def shard(x, mesh, spec, sum_axes=()):
    """This rank's block of the whole ``x`` by ``spec``; backward the
    cotangent summed over ``sum_axes`` (those not in ``spec``) and
    gathered whole."""
    used = {a for part in spec for a in _spec_axes(part)}
    sums = tuple(a for a in _live(mesh, sum_axes) if a not in used)
    if not sums and not _live(mesh, tuple(used)):
        return x
    return _Shard.apply(x, mesh, tuple(spec), sums)


def unshard(x, mesh, spec, summed=False):
    """The whole tensor from every rank's block ``x`` by ``spec``;
    backward this rank's block of the cotangent (of the cotangent summed
    over the spec's axes with ``summed``)."""
    live = _live(mesh, tuple(a for part in spec for a in _spec_axes(part)))
    if not live:
        return x
    return _Unshard.apply(x, mesh, tuple(spec), live if summed else ())
