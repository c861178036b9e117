"""Neural-network ops (counterpart of ``mxnet_tpu.ops.nn``), the subset
the ported layers and symbolic graphs call: ``FullyConnected``,
``Convolution``, ``Pooling``, ``BatchNorm``, ``Activation``,
``softmax``, ``log_softmax``, and the output heads ``SoftmaxOutput`` and
the ``*RegressionOutput`` ops, whose gradients are their own.

The reference left these to XLA, so here each is PyTorch's own op
(``F.conv2d`` runs cuDNN on the card) arranged to the reference's
numerics: NCHW at the op boundary with OIHW weights, a convolution's
output in its input dtype with the bias added after, pooling windows
padded with -inf, and BatchNorm as ``_batch_norm`` writes it (f32
statistics, single-pass shifted moments, one folded scale and bias per
channel).  No hand-written kernel is on this path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config as _config
from .registry import register


# ------------------------------------------------------------------ dense
@register("FullyConnected", aliases=("fully_connected",))
def _fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                     flatten=True, **_):
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


# ------------------------------------------------------------------ conv
def _tup(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    return t if len(t) == n else t + (t[-1],) * (n - len(t))


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", aliases=("convolution",))
def _convolution(data, weight, bias=None, kernel=None, stride=None,
                 dilate=None, pad=None, num_filter=None, num_group=1,
                 no_bias=False, layout=None, **_):
    """NCHW data, OIHW weight.  Under ``conv.internal_layout=NHWC`` a 2-D
    convolution's input and weight go ``channels_last`` in memory (the
    logical layout stays NCHW, as in the reference).  f32 inputs
    accumulate in f32 (TF32 is the caller's switch:
    ``torch.backends.cudnn.allow_tf32``)."""
    ndim = data.dim() - 2
    x, w = data, weight
    if ndim == 2 and _config.get("conv.internal_layout") == "NHWC":
        x = x.contiguous(memory_format=torch.channels_last)
        w = w.contiguous(memory_format=torch.channels_last)
    out = _CONV[ndim](x, w, stride=_tup(stride, ndim),
                      padding=_tup(pad if pad is not None else 0, ndim),
                      dilation=_tup(dilate, ndim), groups=num_group)
    out = out.to(data.dtype)
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * ndim)
    return out


# ------------------------------------------------------------------ pooling
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling", aliases=("pooling",))
def _pooling(data, kernel=None, pool_type="max", global_pool=False,
             stride=None, pad=None, pooling_convention="valid",
             count_include_pad=True, **_):
    """Max, avg, sum or lp (p = 2: the root of the windowed sum of
    ``|x|^2``) pooling; a max window pads with -inf, the others with 0.
    The window is placed as the reference places it, which is the
    ``valid`` convention whatever ``pooling_convention`` says (it accepts
    ``full`` and ignores it, and so does this op).  A global pool is the
    max or, for every other type, the mean, as the reference's."""
    ndim = data.dim() - 2
    if global_pool:
        axes = tuple(range(2, data.dim()))
        if pool_type == "max":
            return torch.amax(data, dim=axes, keepdim=True)
        return torch.mean(data, dim=axes, keepdim=True)
    kernel = _tup(kernel, ndim)
    stride = _tup(stride if stride is not None else kernel, ndim)
    pad = _tup(pad if pad is not None else 0, ndim)
    if pool_type == "max":
        return _MAX_POOL[ndim](data, kernel, stride, pad)
    if pool_type == "avg":
        return _AVG_POOL[ndim](data, kernel, stride, pad,
                               count_include_pad=bool(count_include_pad))
    if pool_type == "sum":
        return _sum_pool(data, kernel, stride, pad)
    if pool_type == "lp":
        return torch.sqrt(_sum_pool(data.abs() ** 2, kernel, stride, pad))
    raise ValueError("unknown pool_type %r" % pool_type)


def _sum_pool(x, kernel, stride, pad):
    """The windowed sum, zero-padded: an avg pool that divides by 1 (a
    1-D pool as a 2-D one over a unit axis)."""
    if len(kernel) == 1:
        return _sum_pool(x.unsqueeze(-1), kernel + (1,), stride + (1,),
                         pad + (0,)).squeeze(-1)
    return _AVG_POOL[len(kernel)](x, kernel, stride, pad,
                                  count_include_pad=True, divisor_override=1)


# ------------------------------------------------------------------ norms
@register("BatchNorm", aliases=("batch_norm",), num_outputs=3)
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                axis=1, training=False, **_):
    """Returns ``(out, batch_mean, batch_var)``; the caller (the Gluon
    layer) updates the moving statistics.

    The statistics and the normalisation run in f32 for bf16 activations
    too.  In training the moments are single-pass and shifted by the
    moving mean: ``d = x - moving_mean``, ``var = max(E[d^2] - E[d]^2,
    0)``, ``mean = E[d] + moving_mean`` (``bn_two_pass_stats`` selects the
    exact two-pass variance).  The normalisation is folded into one scale
    and one bias per channel, and the output goes back to the input's
    dtype.  ``F.batch_norm`` is not used: it updates the running variance
    with the unbiased batch variance, where the reference keeps the
    biased one."""
    xf = data.float()
    red = tuple(i for i in range(data.dim()) if i != axis)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    if training and not use_global_stats:
        if _config.get("bn_two_pass_stats"):
            mean = torch.mean(xf, dim=red)
            var = torch.var(xf, dim=red, correction=0)
        else:
            shift = moving_mean.float().reshape(shape)
            d = xf - shift
            dm = torch.mean(d, dim=red)
            d2 = torch.mean(torch.square(d), dim=red)
            var = torch.clamp(d2 - torch.square(dm), min=0.0)
            mean = dm + shift.reshape(-1)
    else:
        mean = moving_mean.float()
        var = moving_var.float()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    scale = (torch.rsqrt(var + eps) * g.float()).reshape(shape)
    bias = beta.float().reshape(shape) - mean.reshape(shape) * scale
    out = xf * scale + bias
    return out.to(data.dtype), mean, var


# ------------------------------------------------------------------ softmax
@register("softmax")
def _softmax(data, axis=-1, temperature=None, **_):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.softmax(data, dim=axis)


@register("log_softmax")
def _log_softmax(data, axis=-1, temperature=None, **_):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


# ------------------------------------------------------------ output heads
class _SoftmaxOutput(torch.autograd.Function):
    """Softmax over the last axis whose gradient is the reference's own
    (``src/operator/softmax_output-inl.h``): ``(p - onehot(label)) /
    batch`` for the data, whatever the incoming cotangent, and zero for
    the label.  The op defines its loss."""

    @staticmethod
    def forward(ctx, data, label):
        p = torch.softmax(data, dim=-1)
        ctx.save_for_backward(p, label)
        return p

    @staticmethod
    def backward(ctx, _):
        p, label = ctx.saved_tensors
        onehot = F.one_hot(label.to(torch.int64), p.shape[-1]).to(p.dtype)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return (p - onehot) / p.shape[0], dlabel


@register("SoftmaxOutput", aliases=("softmax_output",))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    use_ignore=False, multi_output=False,
                    normalization="batch", **_):
    """The reference's ``SoftmaxOutput``: like it, the options other than
    the data and label are accepted and do not change the result."""
    return _SoftmaxOutput.apply(data, label)


class _RegressionOutput(torch.autograd.Function):
    """The *RegressionOutput heads (reference
    ``src/operator/regression_output.cc``): the forward transforms the
    data; the backward ignores the cotangent and gives
    ``grad(out, label) / batch`` for the data and zero for the label."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.grad = grad
        return out

    @staticmethod
    def backward(ctx, _):
        out, label = ctx.saved_tensors
        g = ctx.grad(out, label.reshape(out.shape)) / out.shape[0]
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return g, dlabel, None, None


def _snake(name):
    """The reference's snake-case alias of an op name
    (``MAERegressionOutput`` -> ``maeregression_output``)."""
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i and not name[i - 1].isupper():
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def _regression_output(name, fwd, grad):
    @register(name, aliases=(_snake(name),))
    def _op(data, label, grad_scale=1.0, **_):
        return _RegressionOutput.apply(data, label.to(data.dtype), fwd,
                                       grad)


_regression_output("LinearRegressionOutput", lambda x: x,
                   lambda out, label: out - label)
_regression_output("LogisticRegressionOutput", torch.sigmoid,
                   lambda out, label: out - label)
_regression_output("MAERegressionOutput", lambda x: x,
                   lambda out, label: torch.sign(out - label))


# ------------------------------------------------------------------ act
_ACT = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
        "softrelu": F.softplus, "softsign": F.softsign}


@register("Activation", aliases=("activation",))
def _activation(data, act_type="relu", **_):
    if act_type not in _ACT:
        raise ValueError("unknown act_type %r" % act_type)
    return _ACT[act_type](data)
