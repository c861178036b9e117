"""Legacy-name parity ops (counterpart of ``mxnet_tpu.ops.misc``): the
``_*_scalar`` family and its CamelCase names, the reference's legacy
aliases, and the long tail (``add_n``, AMP casts, ``_histogram``,
``_split_v2``, slice assignment, the image ops, the straight-through and
gradient-shaping ops, ...), each a PyTorch expression on the op's own
device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import canonical_dtype
from .registry import _REGISTRY, get, register
from .tensor import (as_index, device_of, index_dtype, linspace_values,
                     positive_steps, weak)


# --------------------------------------------------------------- scalar ops
def _full(a, s):
    return torch.full_like(a, weak(s, a))


def _flag(fn):
    """A comparison or logical scalar op: 1 or 0 in the input's dtype."""
    return lambda a, s: fn(a, s).to(a.dtype)


_SCALAR = {
    "_plus_scalar": (lambda a, s: a + weak(s, a), "_PlusScalar"),
    "_minus_scalar": (lambda a, s: a - weak(s, a), "_MinusScalar"),
    "_rminus_scalar": (lambda a, s: weak(s, a) - a, "_RMinusScalar"),
    "_mul_scalar": (lambda a, s: a * weak(s, a), "_MulScalar"),
    "_div_scalar": (lambda a, s: a / weak(s, a), "_DivScalar"),
    "_rdiv_scalar": (lambda a, s: weak(s, a) / a, "_RDivScalar"),
    "_mod_scalar": (lambda a, s: torch.remainder(a, weak(s, a)),
                    "_ModScalar"),
    "_rmod_scalar": (lambda a, s: torch.remainder(_full(a, s), a),
                     "_RModScalar"),
    "_power_scalar": (lambda a, s: torch.pow(a, weak(s, a)),
                      "_PowerScalar"),
    "_rpower_scalar": (lambda a, s: torch.pow(_full(a, s), a),
                       "_RPowerScalar"),
    "_maximum_scalar": (lambda a, s: torch.maximum(a, _full(a, s)),
                        "_MaximumScalar"),
    "_minimum_scalar": (lambda a, s: torch.minimum(a, _full(a, s)),
                        "_MinimumScalar"),
    "_hypot_scalar": (lambda a, s: torch.hypot(a, _full(a, s)),
                      "_HypotScalar"),
    "_scatter_plus_scalar": (lambda a, s: a + weak(s, a), None),
    "_scatter_minus_scalar": (lambda a, s: a - weak(s, a), None),
}
_SCALAR_FLAGS = {
    "_equal_scalar": (lambda a, s: a == weak(s, a), "_EqualScalar"),
    "_not_equal_scalar": (lambda a, s: a != weak(s, a), "_NotEqualScalar"),
    "_greater_scalar": (lambda a, s: a > weak(s, a), "_GreaterScalar"),
    "_greater_equal_scalar": (lambda a, s: a >= weak(s, a),
                              "_GreaterEqualScalar"),
    "_lesser_scalar": (lambda a, s: a < weak(s, a), "_LesserScalar"),
    "_lesser_equal_scalar": (lambda a, s: a <= weak(s, a),
                             "_LesserEqualScalar"),
    "_logical_and_scalar": (lambda a, s: (a != 0) & bool(s),
                            "_LogicalAndScalar"),
    "_logical_or_scalar": (lambda a, s: (a != 0) | bool(s),
                           "_LogicalOrScalar"),
    "_logical_xor_scalar": (lambda a, s: (a != 0) ^ bool(s),
                            "_LogicalXorScalar"),
}


def _register_scalar(name, fn, camel, differentiable):
    register(name, differentiable=differentiable,
             aliases=(camel,) if camel else ())(
        lambda data, scalar=0.0, _fn=fn, **_: _fn(data, scalar))


for _name, (_fn, _camel) in _SCALAR.items():
    _register_scalar(_name, _fn, _camel, True)
for _name, (_fn, _camel) in _SCALAR_FLAGS.items():
    _register_scalar(_name, _flag(_fn), _camel, False)


# ------------------------------------------------------------- legacy alias
# the v0.x CamelCase names and other names the reference keeps
# (``misc.py`` ``_LEGACY_ALIASES``)
_LEGACY_ALIASES = {
    "_Plus": "broadcast_add", "_add": "broadcast_add",
    "_plus": "broadcast_add", "_grad_add": "broadcast_add",
    "broadcast_plus": "broadcast_add",
    "_Minus": "broadcast_sub", "_sub": "broadcast_sub",
    "_minus": "broadcast_sub", "broadcast_minus": "broadcast_sub",
    "_Mul": "broadcast_mul", "_mul": "broadcast_mul",
    "_Div": "broadcast_div", "_div": "broadcast_div",
    "_Mod": "broadcast_mod", "_mod": "broadcast_mod",
    "_Power": "broadcast_power",
    "_Maximum": "broadcast_maximum", "_maximum": "broadcast_maximum",
    "_Minimum": "broadcast_minimum", "_minimum": "broadcast_minimum",
    "_Hypot": "broadcast_hypot", "_hypot": "broadcast_hypot",
    "_Equal": "broadcast_equal", "equal": "broadcast_equal",
    "_Not_Equal": "broadcast_not_equal", "not_equal": "broadcast_not_equal",
    "_Greater": "broadcast_greater", "greater": "broadcast_greater",
    "_Greater_Equal": "broadcast_greater_equal",
    "greater_equal": "broadcast_greater_equal",
    "_Lesser": "broadcast_lesser", "less": "broadcast_lesser",
    "_Lesser_Equal": "broadcast_lesser_equal",
    "less_equal": "broadcast_lesser_equal",
    "_Logical_And": "broadcast_logical_and",
    "_logical_and": "broadcast_logical_and",
    "_Logical_Or": "broadcast_logical_or",
    "_logical_or": "broadcast_logical_or",
    "_Logical_Xor": "broadcast_logical_xor",
    "_logical_xor": "broadcast_logical_xor",
    "broadcast_axes": "broadcast_axis",
    "choose_element_0index": "pick",
    "_shuffle": "shuffle",
    "_ravel_multi_index": "ravel_multi_index",
    "_linalg_gemm2": "linalg_gemm2", "_linalg_potrf": "linalg_potrf",
    "_linalg_syrk": "linalg_syrk", "_linalg_trsm": "linalg_trsm",
    "SliceChannel": "split",
    "Softmax": "softmax",
    "BatchNorm_v1": "BatchNorm",
    "Convolution_v1": "Convolution",
    "Pooling_v1": "Pooling",
    # the reference's contrib module names these ported ops too
    # (``contrib_extra.py`` ``_CONTRIB_ALIASES``)
    "_contrib_ctc_loss": "CTCLoss", "_contrib_CTCLoss": "CTCLoss",
    "_contrib_boolean_mask": "boolean_mask",
    "_contrib_SparseEmbedding": "Embedding",
    "_contrib_SyncBatchNorm": "BatchNorm", "SyncBatchNorm": "BatchNorm",
}


def _register_legacy_aliases():
    for alias, target in _LEGACY_ALIASES.items():
        if alias not in _REGISTRY:
            _REGISTRY[alias] = get(target)


# ---------------------------------------------------------------- real ops
@register("add_n", aliases=("ElementWiseSum",))
def _add_n(*arrays, num_args=None, **_):
    """The sum of N tensors, added left to right."""
    n = num_args if num_args is not None else len(arrays)
    out = arrays[0]
    for a in arrays[1:n]:
        out = out + a
    return out


@register("amp_cast")
def _amp_cast(data, dtype="float32", **_):
    return data.to(canonical_dtype(dtype))


@register("amp_multicast", num_outputs=-1)
def _amp_multicast(*arrays, num_outputs=None, cast_narrow=False, **_):
    """N tensors cast to a common dtype: the widest float (the narrowest
    with ``cast_narrow``; a non-float counts as width 0), the first of
    equal widths."""
    n = num_outputs if num_outputs is not None else len(arrays)
    arrs = arrays[:n]

    def width(d):
        bits = torch.finfo(d).bits if d.is_floating_point else 0
        return -bits if cast_narrow else bits

    target = max((a.dtype for a in arrs), key=width)
    return tuple(a.to(target) for a in arrs)


@register("cast_storage")
def _cast_storage(data, stype="default", **_):
    """Dense storage only: sparse storage comes with slice 16."""
    if stype not in ("default", None):
        raise NotImplementedError(
            "cast_storage to %r: sparse storage is not ported yet "
            "(slice 16)" % (stype,))
    return data.clone()


@register("_histogram", aliases=("histogram",), differentiable=False,
          num_outputs=2)
def _histogram(data, bins=None, bin_cnt=10, range=None, **_):
    """``(counts, edges)`` as ``jnp.histogram``: explicit ``bins`` edges,
    or ``bin_cnt`` equal bins over ``range`` (the data's min and max by
    default); a value lands in the bin whose left edge it reaches, the
    last edge closing the last bin.  Counts come in the data's dtype, as
    the reference's, and nothing syncs: the output sizes do not depend on
    the data."""
    d = data.reshape(-1)
    if bins is not None and bins.dim() > 0:
        edges = bins
    else:
        lo, hi = (range if range is not None
                  else (torch.amin(d), torch.amax(d)))
        edges = linspace_values(lo, hi, int(bin_cnt) + 1, True, d.dtype,
                                d.device)
    n = edges.shape[0]
    idx = torch.searchsorted(edges, d, right=True)
    idx = torch.where(d == edges[-1], n - 1, idx)
    counts = torch.zeros(n + 1, dtype=d.dtype, device=d.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=counts.dtype))
    return counts[1:n], edges


@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs, **_):
    return lhs.clone()


@register("_zeros_without_dtype", differentiable=False)
def _zeros_without_dtype(shape=(), ctx=None, **_):
    return torch.zeros(tuple(shape), dtype=torch.float32,
                       device=device_of(ctx))


@register("_rnn_param_concat")
def _rnn_param_concat(*arrays, dim=0, num_args=None, **_):
    n = num_args if num_args is not None else len(arrays)
    return torch.cat(arrays[:n], dim=dim)


@register("_split_v2", aliases=("split_v2",), num_outputs=-1)
def _split_v2(data, indices=(), axis=0, squeeze_axis=False, sections=0,
              **_):
    """Split into ``sections`` equal parts, or at ``indices``."""
    if sections and sections > 0:
        parts = torch.tensor_split(data, sections, dim=axis)
    else:
        parts = torch.tensor_split(data, list(indices), dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("_square_sum", aliases=("square_sum",))
def _square_sum(data, axis=None, keepdims=False, **_):
    from .tensor import _red_axes
    return torch.sum(data * data, dim=_red_axes(data, axis),
                     keepdim=keepdims)


@register("_sparse_retain", aliases=("sparse_retain",))
def _sparse_retain(data, indices, **_):
    """The rows of ``data`` listed in ``indices``; every other row zero."""
    keep = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    keep = keep.index_fill(0, as_index(indices).reshape(-1), True)
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       torch.zeros_like(data))


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, rhs, indices, shape=None, **_):
    """``lhs`` with ``rhs`` written at ``indices`` (overwrite)."""
    idx = as_index(indices)
    return lhs.index_put(tuple(idx[i] for i in range(idx.shape[0])), rhs)


@register("_scatter_elemwise_div")
def _scatter_elemwise_div(lhs, rhs, **_):
    return lhs / rhs


def _slices(begin, end, step):
    step = step or (None,) * len(begin)
    return tuple(slice(b, e, (step[i] if i < len(step) else None) or None)
                 for i, (b, e) in enumerate(zip(begin, end)))


def _assign(data, key, value):
    """``data`` with ``value`` written at ``key`` (a new tensor)."""
    pos, flips = positive_steps(key, data.shape)
    out = data.clone()
    if isinstance(value, torch.Tensor):
        value = value.flip(flips) if flips else value
        out[pos] = value.to(data.dtype)
    else:
        out[pos] = value
    return out


@register("_slice_assign", aliases=("_crop_assign",))
def _slice_assign(lhs, rhs, begin=(), end=(), step=(), **_):
    return _assign(lhs, _slices(begin, end, step), rhs)


@register("_slice_assign_scalar", aliases=("_crop_assign_scalar",))
def _slice_assign_scalar(data, begin=(), end=(), step=(), scalar=0.0, **_):
    return _assign(data, _slices(begin, end, step), scalar)


@register("fix")
def _fix(data, **_):
    """Round toward zero."""
    return torch.trunc(data)


@register("_unravel_index", aliases=("unravel_index",),
          differentiable=False)
def _unravel_index(data, shape=None, **_):
    """The coordinates of flat indices in ``shape``, stacked on a new
    first axis (int32)."""
    idx = as_index(data)
    coords = []
    for s in reversed(tuple(shape)):
        coords.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return torch.stack(coords[::-1]).to(index_dtype())


@register("_sample_unique_zipfian", differentiable=False, num_outputs=2)
def _sample_unique_zipfian(range_max=None, shape=None, ctx=None, **_):
    """``prod(shape)`` distinct classes from the log-uniform (Zipfian)
    distribution over ``[0, range_max)``, sorted, and each one's expected
    count ``log1p(1 / (c + 1)) / log(range_max) * trials``.  As the
    reference, the draws come in rounds of ``2 n`` and ``trials`` counts
    the in-range draws of every round up to the one that completes the
    set.  The rounds are drawn on the device; learning where the set
    completes syncs once (again only if a batch of rounds falls short)."""
    from ..random import generator
    shape = tuple(shape) if shape else (1,)
    n = math.prod(shape)
    dev = device_of(ctx)
    gen = generator(dev)
    log_rm = math.log(range_max)
    rounds = 8
    draws = torch.zeros(0, dtype=torch.int64, device=dev)
    while True:
        u = torch.rand(rounds * 2 * n, generator=gen, device=dev,
                       dtype=torch.float64)
        draws = torch.cat([draws, torch.exp(u * log_rm).to(torch.int64)])
        m = draws.shape[0]
        valid = draws < range_max
        vals = torch.where(valid, draws, range_max)
        pos = torch.arange(m, device=dev)
        # each value's first draw: sort by (value, position)
        order = torch.sort(vals * m + pos).indices
        svals = vals[order]
        lead = torch.ones(m, dtype=torch.bool, device=dev)
        lead[1:] = svals[1:] != svals[:-1]
        first = torch.zeros_like(lead).scatter(0, order, lead) & valid
        seen = torch.cumsum(first, 0)
        if int(seen[-1]) >= n:   # the one sync
            break
        rounds *= 2
    done = torch.searchsorted(seen, torch.tensor([n], device=dev))
    chosen = first & (pos <= done)
    samples = torch.sort(torch.where(chosen, vals, range_max)).values[:n]
    per_round = 2 * n
    last_round = torch.div(done, per_round, rounding_mode="floor")
    trials = (valid & (pos < (last_round + 1) * per_round)).sum()
    probs = torch.log1p(1.0 / (samples.to(torch.float64) + 1)) / log_rm
    counts = (probs * trials).to(torch.float32)
    return samples.to(index_dtype()).reshape(shape), counts.reshape(shape)


@register("Crop", num_outputs=1)
def _crop_legacy(*args, offset=(0, 0), h_w=(0, 0), center_crop=False, **_):
    """The v0.x Crop layer: ``args[0]`` cropped to ``h_w`` (or to
    ``args[1]``'s spatial size) at ``offset``, or centred."""
    d = args[0]
    th, tw = (args[1].shape[2], args[1].shape[3]) if len(args) > 1 else h_w
    if center_crop:
        y0, x0 = (d.shape[2] - th) // 2, (d.shape[3] - tw) // 2
    else:
        y0, x0 = offset
    return d[:, :, y0:y0 + th, x0:x0 + tw]


@register("IdentityAttachKLSparseReg")
def _identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                   penalty=0.001, momentum=0.9, **_):
    """Identity, with the reference's gradient (the penalty is a term a
    user adds to the loss)."""
    return data.clone()


# ------------------------------------------------------------- image block
@register("_image_to_tensor", aliases=("image_to_tensor",))
def _image_to_tensor(data, **_):
    """HWC (or NHWC) [0, 255] -> CHW (NCHW) float32 [0, 1]."""
    d = data.to(torch.float32) / 255.0
    return d.permute(2, 0, 1) if d.dim() == 3 else d.permute(0, 3, 1, 2)


@register("_image_normalize", aliases=("image_normalize",))
def _image_normalize(data, mean=(0.0,), std=(1.0,), **_):
    m = torch.tensor(mean, dtype=data.dtype).reshape(-1, 1, 1)
    s = torch.tensor(std, dtype=data.dtype).reshape(-1, 1, 1)
    return (data - m.to(data.device)) / s.to(data.device)


@register("_image_resize", aliases=("image_resize",))
def _image_resize(data, size=(), keep_ratio=False, interp=1, **_):
    """HWC or NHWC images resized to ``size`` ``(w, h)``: bilinear with
    ``interp=1`` (antialiased when shrinking, as ``jax.image.resize``),
    half-pixel nearest otherwise."""
    if isinstance(size, int):
        size = (size, size)
    elif len(size) == 1:
        size = (size[0], size[0])
    w, h = size
    x = data.unsqueeze(0) if data.dim() == 3 else data
    x = x.permute(0, 3, 1, 2)
    if interp == 1:
        x = F.interpolate(x, size=(h, w), mode="bilinear",
                          align_corners=False, antialias=True)
    else:
        x = F.interpolate(x, size=(h, w), mode="nearest-exact")
    x = x.permute(0, 2, 3, 1)
    return x[0] if data.dim() == 3 else x


@register("_image_crop", aliases=("image_crop",))
def _image_crop(data, x=0, y=0, width=1, height=1, **_):
    if data.dim() == 3:
        return data[y:y + height, x:x + width, :]
    return data[:, y:y + height, x:x + width, :]


# ------------------------------------------------- STE / gradient-shaping
class _StraightThrough(torch.autograd.Function):
    """``fn(x)`` forward, the cotangent itself backward."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


@register("_contrib_round_ste", aliases=("round_ste",))
def _round_ste(data, **_):
    """Round (half to even) with the straight-through gradient."""
    return _StraightThrough.apply(data, torch.round)


@register("_contrib_sign_ste", aliases=("sign_ste",))
def _sign_ste(data, **_):
    return _StraightThrough.apply(data, torch.sign)


class _GradMultiplier(torch.autograd.Function):
    """Identity forward; the cotangent times ``scalar`` backward."""

    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * weak(ctx.scalar, g), None


@register("_contrib_gradientmultiplier", aliases=("gradientmultiplier",))
def _gradientmultiplier(data, scalar=1.0, **_):
    return _GradMultiplier.apply(data, scalar)


@register("_contrib_div_sqrt_dim", aliases=("div_sqrt_dim",))
def _div_sqrt_dim(data, **_):
    """``x / sqrt(last dim)``, the root taken in the data's dtype."""
    root = torch.sqrt(torch.tensor(float(data.shape[-1]), dtype=data.dtype))
    return data / float(root)


_register_legacy_aliases()
