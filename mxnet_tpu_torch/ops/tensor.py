"""Tensor ops (counterpart of ``mxnet_tpu.ops.tensor``), the subset the
ported layers, losses, NDArray methods, autograd and the symbolic path
call: broadcast arithmetic and comparisons, unary math, reductions with
MXNet's ``exclude`` semantics, shape ops, ``concat`` and ``split``,
``cast``, ``pick``, indexing, ``BlockGrad`` and the device copy.  Each
is one PyTorch expression; names and aliases are the reference's."""
from __future__ import annotations

import operator

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


# ---------------------------------------------------------------- indexing
@register("_slice_index")
def _slice_index(a, key=None, **_):
    return a[key]


@register("pick")
def _pick(data, index, axis=-1, keepdims=False, mode="clip", **_):
    """``data`` at ``index`` along ``axis``; float indices (MXNet labels
    are float32) are cast, and clipped to the axis as ``mode="clip"``."""
    idx = index.to(torch.int64).clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)
