"""Tensor ops (counterpart of ``mxnet_tpu.ops.tensor``), the subset the
ported layers, losses, NDArray methods, autograd and the symbolic path
call: broadcast arithmetic (``%`` as ``broadcast_mod``) and comparisons,
unary math, reductions with MXNet's ``exclude`` semantics, shape ops,
``concat`` and ``split``, ``batch_dot_auto`` (``@``), ``cast``, ``pick``,
indexing (negative steps included), ``BlockGrad`` and the device copy.  Each
is one PyTorch expression; names and aliases are the reference's."""
from __future__ import annotations

import operator

import numpy as _np
import torch

from ..base import torch_dtype
from .registry import register


def _bin(name, fn, aliases=()):
    register(name, aliases=aliases)(lambda a, b, **_: fn(a, b))


# Python's operators take a scalar on either side (``2 - x``)
_bin("broadcast_add", operator.add, aliases=("elemwise_add", "_plus",
                                             "add"))
_bin("broadcast_sub", operator.sub, aliases=("elemwise_sub", "_minus",
                                             "subtract"))
_bin("broadcast_mul", operator.mul, aliases=("elemwise_mul", "multiply"))
_bin("broadcast_div", operator.truediv, aliases=("elemwise_div",
                                                 "divide"))
_bin("broadcast_power", operator.pow, aliases=("power", "_power"))
# Python's % (torch.remainder): the sign follows the divisor, as jnp.mod
_bin("broadcast_mod", operator.mod, aliases=("mod",))


def _cmp(name, fn, aliases=()):
    """A comparison: 1.0 where it holds, else 0.0, in f32 (the
    reference's); no gradient."""
    register(name, differentiable=False, aliases=aliases)(
        lambda a, b, **_: fn(torch.as_tensor(a), b).to(torch.float32))


_cmp("broadcast_equal", torch.eq, aliases=("_equal",))
_cmp("broadcast_not_equal", torch.ne, aliases=("_not_equal",))
_cmp("broadcast_greater", torch.gt, aliases=("_greater",))
_cmp("broadcast_greater_equal", torch.ge, aliases=("_greater_equal",))
_cmp("broadcast_lesser", torch.lt, aliases=("_lesser",))
_cmp("broadcast_lesser_equal", torch.le, aliases=("_lesser_equal",))


def _un(name, fn, aliases=()):
    register(name, aliases=aliases)(lambda a, **_: fn(a))


_un("negative", torch.neg)
_un("abs", torch.abs)
_un("exp", torch.exp)
_un("log", torch.log)
_un("sin", torch.sin)
_un("sigmoid", torch.sigmoid)
_un("relu", torch.relu)


@register("BlockGrad", aliases=("stop_gradient", "block_grad"))
def _block_grad(data, **_):
    """The input's values with no gradient through them."""
    return data.detach()


@register("_copy_to_device")
def _copy_to_device(a, device=None, **_):
    """Differentiable copy to ``device`` (the reference's CopyTo node)."""
    return a.to(device)


@register("cast", aliases=("Cast",))
def _cast(a, dtype="float32", **_):
    return a.to(torch_dtype(dtype))


# ---------------------------------------------------------------- reductions
def _red_axes(a, axis, exclude):
    """MXNet reduce axes: int, tuple or None (all); ``exclude=True``
    reduces over every axis NOT listed."""
    if exclude:
        listed = (axis,) if isinstance(axis, int) else tuple(axis or ())
        listed = {ax % a.dim() for ax in listed}
        return tuple(i for i in range(a.dim()) if i not in listed)
    if axis is None:
        return tuple(range(a.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _red(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def _op(a, axis=None, keepdims=False, exclude=False, _fn=fn, **_):
        axes = _red_axes(a, axis, exclude)
        if not axes:
            return a
        return _fn(a, axes, keepdims)


_red("sum", lambda a, ax, k: torch.sum(a, dim=ax, keepdim=k),
     aliases=("sum_axis",))
_red("mean", lambda a, ax, k: torch.mean(a, dim=ax, keepdim=k))


# ---------------------------------------------------------------- shape ops
@register("reshape", aliases=("Reshape",))
def _reshape(a, shape=None, **_):
    return torch.reshape(a, tuple(shape))


@register("transpose")
def _transpose(a, axes=None, **_):
    return a.permute(*axes) if axes else a.permute(*range(a.dim() - 1, -1,
                                                           -1))


@register("flatten", aliases=("Flatten",))
def _flatten(a, **_):
    return torch.reshape(a, (a.shape[0], -1))


@register("expand_dims")
def _expand_dims(a, axis=0, **_):
    return torch.unsqueeze(a, axis)


@register("squeeze")
def _squeeze(a, axis=None, **_):
    return torch.squeeze(a) if axis is None else torch.squeeze(a, axis)


@register("concat", aliases=("Concat",))
def _concat(*args, dim=1, **_):
    return torch.cat(args, dim=dim)


@register("split", aliases=("SliceChannel",), num_outputs=-1)
def _split(a, num_outputs=1, axis=1, squeeze_axis=False, **_):
    """``num_outputs`` equal parts along ``axis`` (a tuple when more than
    one)."""
    parts = torch.chunk(a, num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register("batch_dot_auto")
def _batch_dot_auto(a, b, **_):
    """``a @ b`` (the reference's NDArray ``__matmul__``)."""
    return torch.matmul(a, b)


# ---------------------------------------------------------------- indexing
_BASIC = (int, _np.integer, slice, type(None), type(Ellipsis))


def positive_steps(key, shape):
    """``(key', flips)``: ``key`` with every negative-step slice replaced by
    the slice of the same elements in increasing order (PyTorch takes no
    negative step), and the axes of ``a[key']`` to flip so that
    ``a[key'].flip(flips)`` equals numpy's ``a[key]``.  A negative step
    combines with ints, slices, ``None`` and ``Ellipsis`` only."""
    items = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in items):
        return key, ()
    if not all(isinstance(k, _BASIC) for k in items):
        raise IndexError("a negative-step slice combines only with ints, "
                         "slices, None and Ellipsis")
    consumed = sum(k is not None and k is not Ellipsis for k in items)
    out, flips, dim, rdim = [], [], 0, 0
    for k in items:
        if k is Ellipsis:
            span = len(shape) - consumed
            dim, rdim = dim + span, rdim + span
        elif k is None:
            rdim += 1
        elif isinstance(k, slice):
            if k.step is not None and k.step < 0:
                start, stop, step = k.indices(shape[dim])
                n = len(range(start, stop, step))
                last = start + step * (n - 1)
                k = slice(last, start + 1, -step) if n else slice(0, 0)
                flips.append(rdim)
            dim, rdim = dim + 1, rdim + 1
        else:
            dim += 1   # an int index drops its axis
        out.append(k)
    return tuple(out), tuple(flips)


@register("_slice_index")
def _slice_index(a, key=None, **_):
    key, flips = positive_steps(key, a.shape)
    out = a[key]
    return out.flip(flips) if flips else out


@register("pick")
def _pick(data, index, axis=-1, keepdims=False, mode="clip", **_):
    """``data`` at ``index`` along ``axis``; float indices (MXNet labels
    are float32) are cast, and clipped to the axis as ``mode="clip"``."""
    idx = index.to(torch.int64).clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)
