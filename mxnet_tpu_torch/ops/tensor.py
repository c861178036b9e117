"""Tensor ops (counterpart of ``mxnet_tpu.ops.tensor``): broadcast
arithmetic, comparisons and logic, the unary math table, reductions with
MXNet's ``exclude`` semantics, shape ops, indexing, ordering, products and
the triangular solvers, sequences, cumulative ops and the creation ops.

The reference left these to XLA (``ops/tensor.py:3-6``), so each is one
or a few PyTorch expressions arranged to the reference's numerics: names
and aliases are the reference's, argmax/argmin/argsort/topk indices come
back as float32, index outputs as int32 (int64 under
``mx.config.enable_x64()``), and a Python scalar meeting a float16 or
bfloat16 tensor is first rounded to that dtype (:func:`weak`), as JAX's
weakly typed scalars are.  No op reaches the host to compute; the
creation ops and samplers draw on the current context's device.
"""
from __future__ import annotations

import operator

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import canonical_dtype
from .registry import register

_LOW = (torch.float16, torch.bfloat16)


# ---------------------------------------------------------------- helpers
def weak(s, t):
    """The Python scalar ``s`` as JAX takes it against tensor ``t``: a
    float16 or bfloat16 tensor's scalar is rounded to its dtype first (a
    weakly typed constant); otherwise ``s`` as it is."""
    if isinstance(s, float) and t.dtype in _LOW:
        return float(torch.tensor(s, dtype=t.dtype))
    return s


def index_dtype():
    """The reference's index dtype: int32, or int64 under x64."""
    return canonical_dtype(torch.int64)


def as_index(t):
    """Indices (float labels included) as int64 for PyTorch's indexing,
    truncated toward zero as the reference's ``astype(int32)``."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t)
    return t.to(torch.int64)


def _tensor(a, like):
    """``a`` as a tensor next to ``like``: a Python scalar becomes a full
    tensor of ``like``'s shape, dtype and device (no host copy)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.full_like(like, weak(a, like))


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def device_of(ctx=None):
    """The device a creation op or a sampler without an array input
    writes to: ``ctx``, the current context by default."""
    from ..context import resolve_device
    return resolve_device(ctx)


# ---------------------------------------------------------------- arithmetic
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


def _bin_t(name, fn, aliases=()):
    """A binary op PyTorch takes on two tensors: a scalar side becomes a
    full tensor like the other."""
    @register(name, aliases=aliases)
    def _op(a, b, _fn=fn, **_):
        if not isinstance(a, torch.Tensor):
            a = _tensor(a, b)
        return _fn(a, _tensor(b, a))


_bin_t("broadcast_maximum", torch.maximum, aliases=("maximum",))
_bin_t("broadcast_minimum", torch.minimum, aliases=("minimum",))
_bin_t("broadcast_hypot", torch.hypot, aliases=("hypot",))
_bin_t("arctan2", torch.atan2, aliases=("broadcast_arctan2",))


def _cmp(name, fn, aliases=()):
    """A comparison or logical op: 1.0 where it holds, else 0.0, in f32
    (the reference's); no gradient.  A scalar side is a 0-d CPU tensor,
    which PyTorch takes beside a CUDA one."""
    register(name, differentiable=False, aliases=aliases)(
        lambda a, b, **_: fn(torch.as_tensor(a), torch.as_tensor(b))
        .to(torch.float32))


_cmp("broadcast_equal", torch.eq, aliases=("_equal",))
_cmp("broadcast_not_equal", torch.ne, aliases=("_not_equal",))
_cmp("broadcast_greater", torch.gt, aliases=("_greater",))
_cmp("broadcast_greater_equal", torch.ge, aliases=("_greater_equal",))
_cmp("broadcast_lesser", torch.lt, aliases=("_lesser",))
_cmp("broadcast_lesser_equal", torch.le, aliases=("_lesser_equal",))
_cmp("broadcast_logical_and", torch.logical_and, aliases=("logical_and",))
_cmp("broadcast_logical_or", torch.logical_or, aliases=("logical_or",))
_cmp("broadcast_logical_xor", torch.logical_xor, aliases=("logical_xor",))


# ---------------------------------------------------------------- unary math
def _un(name, fn, aliases=(), differentiable=True):
    register(name, aliases=aliases, differentiable=differentiable)(
        lambda a, _fn=fn, **_: _fn(a))


def _cbrt(a):
    return torch.sign(a) * torch.abs(a) ** (1.0 / 3.0)


def _as_f32(fn):
    return lambda a: fn(a).to(torch.float32)


_un("negative", torch.neg)
_un("abs", torch.abs)
_un("sign", torch.sign)
# round and rint round half to even, as jnp.round
for _n, _f in (("rint", torch.round), ("ceil", torch.ceil),
               ("floor", torch.floor), ("trunc", torch.trunc),
               ("round", torch.round)):
    _un(_n, _f, differentiable=False)
_un("exp", torch.exp)
_un("expm1", torch.expm1)
_un("log", torch.log)
_un("log10", torch.log10)
_un("log2", torch.log2)
_un("log1p", torch.log1p)
_un("sqrt", torch.sqrt)
_un("rsqrt", torch.rsqrt)
_un("cbrt", _cbrt)
_un("rcbrt", lambda a: 1.0 / _cbrt(a))
_un("square", torch.square)
_un("reciprocal", torch.reciprocal)
_un("sin", torch.sin)
_un("cos", torch.cos)
_un("tan", torch.tan)
_un("arcsin", torch.asin)
_un("arccos", torch.acos)
_un("arctan", torch.atan)
_un("sinh", torch.sinh)
_un("cosh", torch.cosh)
_un("tanh", torch.tanh)
_un("arcsinh", torch.asinh)
_un("arccosh", torch.acosh)
_un("arctanh", torch.atanh)
_un("degrees", torch.rad2deg)
_un("radians", torch.deg2rad)
_un("sigmoid", torch.sigmoid)
_un("softsign", F.softsign)
_un("relu", torch.relu)
_un("erf", torch.erf)
_un("erfinv", torch.erfinv)
_un("gamma", lambda a: torch.exp(torch.lgamma(a)))
_un("gammaln", torch.lgamma)
_un("digamma", torch.digamma)
_un("logical_not", _as_f32(torch.logical_not), differentiable=False)
_un("isnan", _as_f32(torch.isnan), differentiable=False)
_un("isinf", _as_f32(torch.isinf), differentiable=False)
_un("isfinite", _as_f32(torch.isfinite), differentiable=False)


@register("clip")
def _clip(a, a_min=None, a_max=None, **_):
    if a_min is None and a_max is None:
        return a
    return torch.clamp(a, weak(a_min, a) if a_min is not None else None,
                       weak(a_max, a) if a_max is not None else None)


@register("cast", aliases=("Cast",))
def _cast(a, dtype="float32", **_):
    return a.to(canonical_dtype(dtype))


@register("smooth_l1")
def _smooth_l1(a, scalar=1.0, **_):
    s2 = scalar * scalar
    return torch.where(torch.abs(a) < 1.0 / s2, 0.5 * s2 * a * a,
                       torch.abs(a) - 0.5 / s2)


@register("BlockGrad", aliases=("stop_gradient", "block_grad"))
def _block_grad(data, **_):
    """The input's values with no gradient through them."""
    return data.detach()


@register("_copy_to_device")
def _copy_to_device(a, device=None, **_):
    """Differentiable copy to ``device`` (the reference's CopyTo node)."""
    return a.to(device)


# ---------------------------------------------------------------- reductions
def _red_axes(a, axis, exclude=False):
    """MXNet reduce axes: int, tuple or None (all); ``exclude=True``
    reduces over every axis NOT listed."""
    if exclude:
        listed = (axis,) if isinstance(axis, int) else tuple(axis or ())
        listed = {ax % a.dim() for ax in listed}
        return tuple(i for i in range(a.dim()) if i not in listed)
    if axis is None:
        return tuple(range(a.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _over_last(a, axes, keepdims, fn):
    """``fn(x, dim=-1)`` over ``axes`` of ``a`` for a PyTorch reduction
    that takes one dim: the axes move last and flatten into one."""
    axes = sorted(ax % a.dim() for ax in axes)
    rest = [i for i in range(a.dim()) if i not in axes]
    x = a.permute(*rest, *axes).reshape([a.shape[i] for i in rest] + [-1])
    out = fn(x, dim=-1)
    if keepdims:
        out = out.reshape([1 if i in axes else a.shape[i]
                           for i in range(a.dim())])
    return out


def _nanprod(x, dim):
    return torch.prod(torch.where(torch.isnan(x), torch.ones_like(x), x),
                      dim=dim)


def _red(name, fn, aliases=(), differentiable=True):
    @register(name, aliases=aliases, differentiable=differentiable)
    def _op(a, axis=None, keepdims=False, exclude=False, _fn=fn, **_):
        axes = _red_axes(a, axis, exclude)
        if not axes:
            return a
        return _fn(a, axes, keepdims)


_red("sum", lambda a, ax, k: torch.sum(a, dim=ax, keepdim=k),
     aliases=("sum_axis",))
_red("mean", lambda a, ax, k: torch.mean(a, dim=ax, keepdim=k))
_red("prod", lambda a, ax, k: _over_last(a, ax, k, torch.prod))
_red("nansum", lambda a, ax, k: torch.nansum(a, dim=ax, keepdim=k))
_red("nanprod", lambda a, ax, k: _over_last(a, ax, k, _nanprod))
_red("max", lambda a, ax, k: torch.amax(a, dim=ax, keepdim=k),
     aliases=("max_axis",))
_red("min", lambda a, ax, k: torch.amin(a, dim=ax, keepdim=k),
     aliases=("min_axis",))


@register("norm")
def _norm(a, axis=None, keepdims=False, ord=2, **_):
    axes = _red_axes(a, axis)
    if ord == 1:
        return torch.sum(torch.abs(a), dim=axes, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(a), dim=axes,
                                keepdim=keepdims))


def _arg(fn):
    def op(a, axis=None, keepdims=False, **_):
        if axis is None:
            return fn(a.reshape(-1), dim=0).to(torch.float32)
        return fn(a, dim=axis, keepdim=keepdims).to(torch.float32)
    return op


register("argmax", differentiable=False)(_arg(torch.argmax))
register("argmin", differentiable=False)(_arg(torch.argmin))


@register("argmax_channel", differentiable=False)
def _argmax_channel(data, **_):
    return torch.argmax(data, dim=1).to(torch.float32)


@register("logsumexp")
def _logsumexp(a, axis=None, keepdims=False, **_):
    return torch.logsumexp(a, dim=_red_axes(a, axis), keepdim=keepdims)


@register("moments", num_outputs=2)
def _moments(data, axes=None, keepdims=False, **_):
    """(mean, variance) over ``axes``, the variance two-pass as
    ``jnp.var``."""
    ax = _red_axes(data, axes)
    centred = data - torch.mean(data, dim=ax, keepdim=True)
    return (torch.mean(data, dim=ax, keepdim=keepdims),
            torch.mean(torch.square(centred), dim=ax, keepdim=keepdims))


# ---------------------------------------------------------------- shape ops
@register("reshape", aliases=("Reshape",))
def _reshape(a, shape=None, **_):
    return torch.reshape(a, tuple(shape))


@register("reshape_like")
def _reshape_like(lhs, rhs, **_):
    return torch.reshape(lhs, rhs.shape)


@register("transpose")
def _transpose(a, axes=None, **_):
    return a.permute(*axes) if axes else a.permute(*range(a.dim() - 1, -1,
                                                           -1))


@register("swapaxes", aliases=("SwapAxis",))
def _swapaxes(a, dim1=0, dim2=0, **_):
    return torch.swapaxes(a, dim1, dim2)


@register("flatten", aliases=("Flatten",))
def _flatten(a, **_):
    return torch.reshape(a, (a.shape[0], -1))


@register("expand_dims")
def _expand_dims(a, axis=0, **_):
    return torch.unsqueeze(a, axis)


@register("squeeze")
def _squeeze(a, axis=None, **_):
    return torch.squeeze(a) if axis is None else torch.squeeze(a, axis)


@register("broadcast_to")
def _broadcast_to(a, shape=None, **_):
    """A 0 in ``shape`` keeps the input's size (MXNet)."""
    return torch.broadcast_to(a, tuple(s if s != 0 else a.shape[i]
                                       for i, s in enumerate(shape)))


@register("broadcast_axis")
def _broadcast_axis(a, axis=(), size=(), **_):
    tgt = list(a.shape)
    for ax, s in zip(_shape(axis), _shape(size)):
        tgt[ax] = s
    return torch.broadcast_to(a, tuple(tgt))


@register("broadcast_like")
def _broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None, **_):
    if lhs_axes is None:
        return torch.broadcast_to(lhs, rhs.shape)
    shape = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        shape[la] = rhs.shape[ra]
    return torch.broadcast_to(lhs, tuple(shape))


@register("tile")
def _tile(a, reps=(), **_):
    return torch.tile(a, _shape(reps))


@register("repeat")
def _repeat(a, repeats=1, axis=None, **_):
    """``jnp.repeat``: without ``axis`` the input is flattened first."""
    return torch.repeat_interleave(a, repeats, dim=axis)


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


@register("pad", aliases=("Pad",))
def _pad(a, pad_width=None, mode="constant", constant_value=0.0, **_):
    """``pad_width`` as the flat 2N tuple (mshadow's) or N pairs; modes
    ``constant``, ``edge`` and ``reflect`` (PyTorch's edge and reflect
    pads take the trailing axes of a 3-5-D input, as MXNet's op does)."""
    pw = list(pad_width)
    if pw and not isinstance(pw[0], (tuple, list)):
        pw = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    while pw and tuple(pw[0]) == (0, 0) and len(pw) > 1 \
            and mode != "constant":
        pw = pw[1:]   # leading unpadded axes: F.pad counts from the last
    flat = [p for lo_hi in reversed(pw) for p in lo_hi]
    if mode == "constant":
        return F.pad(a, flat, mode="constant", value=constant_value)
    return F.pad(a, flat, mode=_PAD_MODES[mode])


@register("concat", aliases=("Concat",))
def _concat(*args, dim=1, **_):
    return torch.cat(args, dim=dim)


@register("stack")
def _stack(*args, axis=0, **_):
    return torch.stack(args, dim=axis)


@register("split", aliases=("SliceChannel",), num_outputs=-1)
def _split(a, num_outputs=1, axis=1, squeeze_axis=False, **_):
    """``num_outputs`` equal parts along ``axis`` (a tuple when more than
    one)."""
    parts = torch.chunk(a, num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register("slice_axis")
def _slice_axis(a, axis=0, begin=0, end=None, **_):
    n = a.shape[axis]
    end = n if end is None else end
    begin, end = begin + n if begin < 0 else begin, \
        end + n if end < 0 else end
    return torch.narrow(a, axis, begin, max(end - begin, 0))


@register("slice", aliases=("crop",))
def _slice(a, begin=(), end=(), step=None, **_):
    step = step or [None] * len(begin)
    key = tuple(slice(b, e, s) for b, e, s in zip(begin, end, step))
    return _slice_index(a, key=key)


@register("slice_like")
def _slice_like(a, b, axes=(), **_):
    idx = [slice(None)] * a.dim()
    for ax in (axes or range(a.dim())):
        idx[ax] = slice(0, b.shape[ax])
    return a[tuple(idx)]


@register("reverse", aliases=("flip",))
def _reverse(a, axis=0, **_):
    return torch.flip(a, _shape(axis))


@register("where")
def _where(cond, x, y, **_):
    return torch.where(cond.bool(), x, y)


@register("diag")
def _diag(a, k=0, **_):
    return torch.diag(a, k) if a.dim() <= 2 else torch.diagonal(a, k, -2,
                                                                 -1)


@register("zeros_like")
def _zeros_like(a, **_):
    return torch.zeros_like(a)


@register("ones_like")
def _ones_like(a, **_):
    return torch.ones_like(a)


@register("full_like")
def _full_like(a, fill_value=0.0, **_):
    return torch.full_like(a, fill_value)


@register("shape_array", differentiable=False)
def _shape_array(a, **_):
    return torch.tensor(a.shape, dtype=index_dtype(), device=a.device)


@register("size_array", differentiable=False)
def _size_array(a, **_):
    return torch.tensor([a.numel()], dtype=index_dtype(), device=a.device)


@register("depth_to_space")
def _depth_to_space(data, block_size=1, **_):
    """(N, C*b*b, H, W) -> (N, C, H*b, W*b)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def _space_to_depth(data, block_size=1, **_):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("cumsum", aliases=("_np_cumsum",))
def _cumsum(a, axis=None, dtype=None, **_):
    return _cumulative(torch.cumsum, a, axis, dtype)


@register("cumprod")
def _cumprod(a, axis=None, dtype=None, **_):
    return _cumulative(torch.cumprod, a, axis, dtype)


def _cumulative(fn, a, axis, dtype):
    """``jnp.cumsum``/``cumprod``: the input flattened without ``axis``;
    an integer or bool input accumulates in the canonical int."""
    if axis is None:
        a, axis = a.reshape(-1), 0
    if dtype is not None:
        dt = canonical_dtype(dtype)
    elif a.dtype.is_floating_point:
        dt = a.dtype
    else:
        dt = canonical_dtype(torch.int64)
    return fn(a, dim=axis, dtype=dt)


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


@register("take")
def _take(a, indices, axis=0, mode="clip", **_):
    """``a`` at ``indices`` along ``axis``; out-of-range indices clip to
    the axis, or wrap with ``mode="wrap"``."""
    n = a.shape[axis]
    idx = as_index(indices)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("Embedding", aliases=("embedding",))
def _embedding(data, weight, input_dim=None, output_dim=None,
               sparse_grad=False, **_):
    """Rows of ``weight`` at the ids in ``data``; the weight's gradient is
    dense (a row-sparse one comes with the sparse storage)."""
    return F.embedding(as_index(data), weight)


@register("one_hot", differentiable=False)
def _one_hot(a, depth=1, on_value=1.0, off_value=0.0, dtype="float32", **_):
    """An index outside ``[0, depth)`` gives a row of ``off_value``, as
    ``jax.nn.one_hot``."""
    hot = (as_index(a).unsqueeze(-1)
           == torch.arange(depth, device=a.device)).to(torch.float32)
    return (hot * (on_value - off_value) + off_value).to(
        canonical_dtype(dtype))


@register("pick")
def _pick(data, index, axis=-1, keepdims=False, mode="clip", **_):
    """``data`` at ``index`` along ``axis``; float indices (MXNet labels
    are float32) are cast, and clipped to the axis as ``mode="clip"``."""
    idx = as_index(index).clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


@register("gather_nd")
def _gather_nd(data, indices, **_):
    """``indices`` of shape (M, ...) index the first M axes of ``data``."""
    idx = as_index(indices)
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("scatter_nd")
def _scatter_nd(data, indices, shape=None, **_):
    """``data`` added into zeros of ``shape`` at ``indices`` (duplicates
    accumulate)."""
    idx = as_index(indices)
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data,
                         accumulate=True)


@register("take_along_axis")
def _take_along_axis(a, indices, axis=0, **_):
    idx = as_index(indices)
    idx = torch.where(idx < 0, idx + a.shape[axis], idx)
    return torch.take_along_dim(a, idx, dim=axis)


@register("boolean_mask", differentiable=False)
def _boolean_mask(data, index, axis=0, **_):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero;
    the output's length depends on the data, so it syncs once to learn
    it."""
    keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return torch.index_select(data, axis, keep)


@register("batch_take")
def _batch_take(a, indices, **_):
    """``out[i] = a[i, indices[i]]``."""
    return torch.gather(a, 1, as_index(indices).reshape(-1, 1))[:, 0]


# ---------------------------------------------------------------- ordering
@register("sort")
def _sort(a, axis=-1, is_ascend=True, **_):
    out = torch.sort(a, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort", differentiable=False)
def _argsort(a, axis=-1, is_ascend=True, dtype="float32", **_):
    """Stable ascending order (reversed whole for ``is_ascend=False``, as
    the reference's), as float32."""
    out = torch.argsort(a, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch.float32)


@register("topk", differentiable=False)
def _topk(a, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32", **_):
    """The ``k`` largest (smallest with ``is_ascend``) along ``axis``, in
    order; ``ret_typ`` ``indices`` (float32), ``value`` or ``both``."""
    vals, idxs = torch.topk(a, k, dim=axis, largest=not is_ascend,
                            sorted=True)
    idxs = idxs.to(torch.float32)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idxs
    return idxs


@register("shuffle", differentiable=False)
def _shuffle(a, **_):
    """A random permutation along axis 0, drawn on ``a``'s device."""
    from ..random import generator
    perm = torch.randperm(a.shape[0], generator=generator(a.device),
                          device=a.device)
    return a[perm]


# ---------------------------------------------------------------- products
def _t(a):
    return torch.swapaxes(a, -1, -2)


@register("dot")
def _dot(a, b, transpose_a=False, transpose_b=False, **_):
    """``jnp.dot``: the last axis of ``a`` against the second to last of
    ``b`` (the only one of a vector)."""
    if transpose_a and a.dim() > 1:
        a = _t(a)
    if transpose_b and b.dim() > 1:
        b = _t(b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1],
                                       [max(b.dim() - 2, 0)]))


@register("batch_dot")
def _batch_dot(a, b, transpose_a=False, transpose_b=False, **_):
    return torch.matmul(_t(a) if transpose_a else a,
                        _t(b) if transpose_b else b)


@register("batch_dot_auto")
def _batch_dot_auto(a, b, **_):
    """``a @ b`` (the reference's NDArray ``__matmul__``)."""
    return torch.matmul(a, b)


@register("linalg_gemm2")
def _linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0,
                  **_):
    return alpha * _batch_dot(a, b, transpose_a, transpose_b)


@register("linalg_potrf")
def _linalg_potrf(a, **_):
    """The lower Cholesky factor (cuSOLVER on the card)."""
    return torch.linalg.cholesky(a)


@register("linalg_syrk")
def _linalg_syrk(a, transpose=False, alpha=1.0, **_):
    return alpha * (torch.matmul(_t(a), a) if transpose
                    else torch.matmul(a, _t(a)))


@register("linalg_trsm")
def _linalg_trsm(a, b, transpose=False, rightside=False, lower=True,
                 alpha=1.0, **_):
    """``alpha * op(A)^-1 B`` (``B op(A)^-1`` with ``rightside``), reading
    only the ``lower`` (or upper) triangle of ``A``; ``transpose`` takes
    ``A^T`` and so the other triangle."""
    if transpose:
        a, lower = _t(a), not lower
    return alpha * torch.linalg.solve_triangular(
        a, b, upper=not lower, left=not rightside)


@register("L2Normalization")
def _l2norm(a, eps=1e-10, mode="instance", **_):
    """``a`` over the root of its sum of squares (+ eps): per instance
    (every axis but the first), or per ``channel`` (axis 1).  Any other
    mode normalises per instance, as the reference's."""
    axes = (1,) if mode == "channel" else tuple(range(1, a.dim()))
    return a / torch.sqrt(torch.sum(torch.square(a), dim=axes,
                                    keepdim=True) + eps)


# ---------------------------------------------------------------- sequences
def _steps_mask(data, sequence_length, axis):
    """True where the step along ``axis`` is inside its sequence; the
    batch axis is the other of the first two."""
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    steps = torch.arange(data.shape[axis], device=data.device).reshape(shape)
    bshape = [1] * data.dim()
    bshape[1 - axis] = sequence_length.shape[0]
    return steps < sequence_length.reshape(bshape)


@register("SequenceMask", aliases=("sequence_mask",))
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0, **_):
    if not use_sequence_length or sequence_length is None:
        return data
    mask = _steps_mask(data, sequence_length, axis)
    return torch.where(mask, data, torch.full_like(data, weak(value, data)))


@register("SequenceLast", aliases=("sequence_last",))
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0, **_):
    if not use_sequence_length or sequence_length is None:
        return torch.select(data, axis, -1)
    last = as_index(sequence_length) - 1
    mv = torch.movedim(data, axis, 0)
    idx = last.reshape((1, -1) + (1,) * (mv.dim() - 2)).expand(
        (1,) + mv.shape[1:])
    return torch.gather(mv, 0, idx)[0]


@register("SequenceReverse", aliases=("sequence_reverse",))
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0, **_):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    mv = torch.movedim(data, axis, 0)
    seq = as_index(sequence_length)
    t = torch.arange(mv.shape[0], device=data.device)[:, None]
    src = torch.where(t < seq[None, :], seq[None, :] - 1 - t, t)   # (T, B)
    idx = src.reshape(src.shape + (1,) * (mv.dim() - 2)).expand(mv.shape)
    return torch.movedim(torch.gather(mv, 0, idx), 0, axis)


@register("ravel_multi_index", differentiable=False)
def _ravel_multi_index(data, shape=None, **_):
    """Flat indices of the coordinate rows of ``data``, as float32."""
    coords = as_index(data)
    mult, acc = [], 1
    for s in reversed(tuple(shape)):
        mult.append(acc)
        acc *= s
    mult = torch.tensor(mult[::-1], device=data.device).reshape(
        (-1,) + (1,) * (coords.dim() - 1))
    return torch.sum(coords * mult, dim=0).to(torch.float32)


# ------------------------------------------------------------- creation ops
# no array input: they take ``ctx`` and follow ``mx.current_context()``
@register("_zeros", differentiable=False, aliases=("zeros",))
def _zeros_op(shape=None, dtype="float32", ctx=None, **_):
    return torch.zeros(_shape(shape), dtype=canonical_dtype(dtype),
                       device=device_of(ctx))


@register("_ones", differentiable=False, aliases=("ones",))
def _ones_op(shape=None, dtype="float32", ctx=None, **_):
    return torch.ones(_shape(shape), dtype=canonical_dtype(dtype),
                      device=device_of(ctx))


@register("_full", differentiable=False, aliases=("full",))
def _full_op(shape=None, value=0.0, dtype="float32", ctx=None, **_):
    return torch.full(_shape(shape), value, dtype=canonical_dtype(dtype),
                      device=device_of(ctx))


@register("_arange", differentiable=False, aliases=("arange",))
def _arange_op(start=0, stop=None, step=1.0, repeat=1, dtype="float32",
               ctx=None, **_):
    """``start + step * i`` for ``i`` in ``range(ceil((stop - start) /
    step))`` (``range(start)`` from 0 without ``stop``), each product and
    sum one IEEE operation in ``dtype``, so every device gives the same
    values."""
    if stop is None:
        start, stop = 0, start
    n = max(int(_np.ceil((stop - start) / step)), 0)
    dt = canonical_dtype(dtype)
    out = torch.arange(n, device=device_of(ctx)).to(dt) * step + start
    out = out.to(dt)
    return torch.repeat_interleave(out, repeat) if repeat > 1 else out


@register("_linspace", differentiable=False, aliases=("linspace",))
def _linspace_op(start=0, stop=None, num=50, endpoint=True,
                 dtype="float32", ctx=None, **_):
    """``jnp.linspace``: ``start * (1 - t) + stop * t`` for ``t = i /
    div`` in ``dtype``, ``stop`` itself last with ``endpoint``."""
    return linspace_values(start, stop, num, endpoint,
                           canonical_dtype(dtype), device_of(ctx))


def linspace_values(start, stop, num, endpoint, dtype, device):
    """The values of :func:`_linspace_op`; ``start`` and ``stop`` may be
    0-d tensors on ``device``."""
    div = (num - 1) if endpoint else num
    if num <= 0:
        return torch.zeros(0, dtype=dtype, device=device)
    if div <= 0:
        return torch.zeros(1, dtype=dtype, device=device) + start
    n = div if endpoint else num
    t = torch.arange(n, device=device).to(dtype) / div
    out = start * (1 - t) + stop * t
    if endpoint:
        out = torch.cat([out, torch.zeros(1, dtype=dtype, device=device)
                         + stop])
    return out.to(dtype)


@register("_eye", differentiable=False, aliases=("eye",))
def _eye_op(N=0, M=0, k=0, dtype="float32", ctx=None, **_):
    dev = device_of(ctx)
    M = int(M) if M else int(N)
    rows = torch.arange(int(N), device=dev)[:, None] + int(k)
    return (rows == torch.arange(M, device=dev)[None, :]).to(
        canonical_dtype(dtype))
