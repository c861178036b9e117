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

import threading

import torch
import torch.nn.functional as F

from .. import config as _config
from .registry import register
from .tensor import weak


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
# SPMDTrainer's batch axes for the forward of a multi-rank step, installed
# by set_batch_stats_context: BatchNorm's training statistics are then the
# global batch's.  Thread-local, so a step on one thread never sees
# another's
_BATCH_STATS = threading.local()


def set_batch_stats_context(ctx):
    """Install ``ctx`` (``(mesh, axes)``: the batch axes of the running
    step, or None) as this thread's BatchNorm statistics group; returns
    the previous one, for the caller to restore."""
    prev = getattr(_BATCH_STATS, "ctx", None)
    _BATCH_STATS.ctx = ctx
    return prev


def _global_sums(parts, mesh, axes):
    """Per-channel sums (and the element count, last) over the batch
    ranks, in one collective whose backward sums the cotangents too:
    every rank's share of the loss depends on the global statistics."""
    from ..parallel.collectives import psum_summed
    sizes = [p.numel() for p in parts]
    total = psum_summed(torch.cat([p.reshape(-1) for p in parts]), mesh,
                        axes)
    return torch.split(total, sizes)


def _synced_moments(xf, axis, shape, moving_mean, two_pass, mesh, axes):
    """``(mean, var)`` of the global batch: this rank's sums over every
    axis but ``axis``, summed over the batch ranks, in the op order of the one-rank moments
    (the reference's ``jnp.mean`` / ``jnp.var`` over a batch-sharded
    array: the sums are XLA's cross-replica ones)."""
    red = tuple(i for i in range(xf.dim()) if i != axis)
    count = torch.full((1,), float(xf.numel() // xf.shape[axis]),
                       dtype=torch.float32, device=xf.device)
    if two_pass:
        s, n = _global_sums((torch.sum(xf, dim=red), count), mesh, axes)
        mean = s / n
        (s2,) = _global_sums((torch.sum(torch.square(
            xf - mean.reshape(shape)), dim=red),), mesh, axes)
        return mean, s2 / n
    shift = moving_mean.float().reshape(shape)
    d = xf - shift
    sd, sd2, n = _global_sums((torch.sum(d, dim=red),
                               torch.sum(torch.square(d), dim=red), count),
                              mesh, axes)
    dm = sd / n
    var = torch.clamp(sd2 / n - torch.square(dm), min=0.0)
    return dm + shift.reshape(-1), var


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
    biased one.

    Inside a multi-rank ``SPMDTrainer`` step (:func:`set_batch_stats_context`)
    the training statistics are the global batch's: the sums over this
    rank's rows are summed over the step's batch axes in one collective
    (two with ``bn_two_pass_stats``) whose backward sums the cotangents,
    as the reference's batch-sharded program does."""
    xf = data.float()
    red = tuple(i for i in range(data.dim()) if i != axis)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    sync = getattr(_BATCH_STATS, "ctx", None)
    if training and not use_global_stats and sync is not None:
        mean, var = _synced_moments(xf, axis, shape, moving_mean,
                                    _config.get("bn_two_pass_stats"), *sync)
    elif training and not use_global_stats:
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
def _softmax(data, axis=-1, temperature=None, length=None, **_):
    """Softmax over ``axis``; with ``length`` only the first ``length``
    positions of each row count (the rest give 0)."""
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    if length is not None:
        shape = [1] * data.dim()
        shape[axis] = data.shape[axis]
        steps = torch.arange(data.shape[axis],
                             device=data.device).reshape(shape)
        mask = steps < torch.unsqueeze(length, axis)
        data = torch.where(mask, data, float("-inf"))
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


@register("LeakyReLU", aliases=("leaky_relu",))
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, **_):
    """Every ``act_type`` of the reference's: ``leaky`` (``x >= 0`` keeps
    x), ``prelu`` (per-channel ``gamma`` on axis 1), ``elu`` (alpha
    ``slope``), ``selu``, ``gelu`` (the erf form) and ``rrelu`` (the
    inference slope, the bounds' mean)."""
    if act_type in ("leaky", "rrelu"):
        s = slope if act_type == "leaky" else (lower_bound
                                               + upper_bound) / 2.0
        return torch.where(data >= 0, data, weak(s, data) * data)
    if act_type == "prelu":
        shape = (1, -1) + (1,) * (data.dim() - 2) if data.dim() > 1 \
            else (-1,)
        return torch.where(data >= 0, data, gamma.reshape(shape) * data)
    if act_type == "elu":
        return F.elu(data, slope)
    if act_type == "selu":
        return F.selu(data)
    if act_type == "gelu":
        return F.gelu(data)
    raise ValueError("unknown act_type %r" % act_type)


@register("softmin")
def _softmin(data, axis=-1, **_):
    return torch.softmax(-data, dim=axis)


@register("SoftmaxActivation", aliases=("softmax_activation",))
def _softmax_activation(data, mode="instance", **_):
    """Softmax over axis 1 (``channel``) or over each flattened instance."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


@register("hard_sigmoid")
def _hard_sigmoid(data, alpha=0.2, beta=0.5, **_):
    return torch.clamp(weak(alpha, data) * data + weak(beta, data), 0.0,
                       1.0)


# ------------------------------------------------------------------ norms
def _moments(x, axes):
    """Two-pass (mean, var) in f32, keepdims (the reference's
    ``nn._moments``: Layer/Group/InstanceNorm)."""
    xf = x.float()
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=axes, keepdim=True)
    return mean, var


def _affine(xn, gamma, beta, shape, dtype):
    return (xn * gamma.reshape(shape) + beta.reshape(shape)).to(dtype)


@register("LayerNorm", aliases=("layer_norm",))
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, **_):
    """Normalised over ``axis`` with f32 statistics; the output in the
    input's dtype."""
    mean, var = _moments(data, (axis % data.dim(),))
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    xn = (data.float() - mean) * torch.rsqrt(var + eps)
    return _affine(xn, gamma, beta, shape, data.dtype)


@register("GroupNorm", aliases=("group_norm",))
def _group_norm(data, gamma, beta, num_groups=1, eps=1e-5, **_):
    n, c = data.shape[0], data.shape[1]
    xg = data.reshape((n, num_groups, c // num_groups) + data.shape[2:])
    mean, var = _moments(xg, tuple(range(2, xg.dim())))
    xn = ((xg.float() - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    return _affine(xn, gamma, beta, (1, c) + (1,) * (data.dim() - 2),
                   data.dtype)


@register("InstanceNorm", aliases=("instance_norm",))
def _instance_norm(data, gamma, beta, eps=1e-3, **_):
    mean, var = _moments(data, tuple(range(2, data.dim())))
    xn = (data.float() - mean) * torch.rsqrt(var + eps)
    return _affine(xn, gamma, beta,
                   (1, data.shape[1]) + (1,) * (data.dim() - 2), data.dtype)


@register("LRN", aliases=("lrn",), num_outputs=2)
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **_):
    """Local response normalisation across channels, MXNet's scaling
    ``knorm + alpha / nsize * sum(x^2 over the window)``; returns
    ``(out, scale)``."""
    half = nsize // 2
    pad = F.pad(torch.square(data), (0, 0, 0, 0, half, half))
    c = data.shape[1]
    windows = sum(pad[:, i:i + c] for i in range(nsize))
    scale = knorm + (alpha / nsize) * windows
    return data / torch.pow(scale, beta), scale


# ------------------------------------------------------------------ conv
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution", aliases=("deconvolution",))
def _deconvolution(data, weight, bias=None, kernel=None, stride=None,
                   dilate=None, pad=None, adj=None, target_shape=None,
                   num_filter=None, num_group=1, no_bias=True, **_):
    """Transposed convolution, weight ``(C_in, C_out / groups, *k)``
    (MXNet's and PyTorch's layout).  ``adj`` pads the output's far side;
    a nonempty ``target_shape`` sets the spatial output size, with the
    padding and ``adj`` derived from it as MXNet does (the reference
    ignores ``target_shape`` and ``dilate``)."""
    ndim = data.dim() - 2
    stride = _tup(stride, ndim)
    dilate = _tup(dilate, ndim)
    k = weight.shape[2:]
    if target_shape is not None and any(target_shape):
        tgt = _tup(target_shape, ndim)
        total = [s * (i - 1) + d * (kk - 1) + 1 - t for s, i, d, kk, t in zip(
            stride, data.shape[2:], dilate, k, tgt)]
        adj = tuple(t % 2 for t in total)
        pad = tuple((t + 1) // 2 for t in total)
    pad = _tup(pad if pad is not None else 0, ndim)
    adj = _tup(adj if adj is not None else 0, ndim)
    out = _DECONV[ndim](data, weight, stride=stride, padding=pad,
                        output_padding=adj, groups=num_group,
                        dilation=dilate)
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * ndim)
    return out


@register("UpSampling", aliases=("upsampling",))
def _upsampling(data, *weight, scale=2, sample_type="nearest",
                num_filter=None, **_):
    """``nearest``: each pixel repeated ``scale`` times along H and W.
    ``bilinear`` (MXNet's): a grouped deconvolution by the given weight
    ``(C, 1, 2s - s % 2, 2s - s % 2)``, stride ``s``, pad ``ceil((s - 1)
    / 2)`` (the reference has nearest only)."""
    if sample_type == "bilinear":
        k = 2 * scale - scale % 2
        return _deconvolution(data, weight[0], kernel=(k, k),
                              stride=(scale, scale),
                              pad=(scale // 2,) * 2,
                              num_group=data.shape[1])
    return torch.repeat_interleave(
        torch.repeat_interleave(data, scale, dim=-2), scale, dim=-1)


# ------------------------------------------------------------------ misc
@register("identity", aliases=("_copy",))
def _identity(data, **_):
    return data.clone()


@register("make_loss", aliases=("MakeLoss",))
def _make_loss(data, grad_scale=1.0, **_):
    """The data as a loss head; its gradient is the head gradient (the
    reference's)."""
    return data * 1.0


@register("Dropout", aliases=("dropout",))
def _dropout(data, p=0.5, mode="training", axes=(), training=False, **_):
    """In training (or ``mode="always"``): ``where(mask, x / keep, 0)`` in
    the input's dtype, ``keep = 1 - p``, the mask drawn on the input's
    device (one value per position, shared along ``axes``)."""
    if (not training and mode != "always") or p <= 0.0:
        return data
    from ..random import generator
    shape = list(data.shape)
    for ax in axes:
        shape[ax] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=torch.bool, device=data.device)
    mask.bernoulli_(keep, generator=generator(data.device))
    return dropout_apply(data, mask, keep)


def dropout_apply(data, mask, keep):
    """Dropout's deterministic part: ``where(mask, data / keep, 0)`` with
    ``keep`` rounded to the data's dtype, as the reference computes it."""
    return torch.where(mask, data / weak(keep, data), 0.0).to(data.dtype)


# ------------------------------------------------------------------ losses
class _SoftmaxCE(torch.autograd.Function):
    """Total cross entropy of the logits' rows against integer labels;
    the data's gradient ``g * (softmax - onehot)``, none for the label."""

    @staticmethod
    def forward(ctx, data, label):
        lab = label.to(torch.int64).reshape(-1)
        logp = torch.log_softmax(data, dim=-1)
        ctx.save_for_backward(logp, lab)
        ctx.label = (label.shape, label.dtype)
        return -torch.sum(torch.gather(logp, -1, lab[:, None]))

    @staticmethod
    def backward(ctx, g):
        logp, lab = ctx.saved_tensors
        onehot = F.one_hot(lab, logp.shape[-1]).to(logp.dtype)
        dlabel = torch.zeros(ctx.label[0], dtype=ctx.label[1],
                             device=lab.device) \
            if ctx.needs_input_grad[1] else None
        return g * (torch.exp(logp) - onehot), dlabel


@register("softmax_cross_entropy")
def _softmax_cross_entropy(data, label, **_):
    return _SoftmaxCE.apply(data, label)


class _SVMOutput(torch.autograd.Function):
    """Identity forward; the backward ignores the cotangent and gives the
    hinge loss's gradient (L2, or L1 with ``use_linear``) scaled by
    ``regularization_coefficient`` (reference ``nn.py:571``)."""

    @staticmethod
    def forward(ctx, data, label, margin, coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.args = (margin, coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, _):
        d, label = ctx.saved_tensors
        margin, coef, use_linear = ctx.args
        onehot = F.one_hot(label.to(torch.int64), d.shape[-1]) > 0
        signed = torch.where(onehot, d, -d)
        viol = (margin - signed) > 0
        sgn = torch.where(onehot, -1.0, 1.0).to(d.dtype)
        gd = sgn if use_linear else 2.0 * (margin - signed) * sgn
        gd = torch.where(viol, gd, torch.zeros_like(gd))
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return coef * gd.to(d.dtype), dlabel, None, None, None


@register("SVMOutput", aliases=("svm_output",))
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False, **_):
    return _SVMOutput.apply(data, label, margin, regularization_coefficient,
                            use_linear)


@register("CTCLoss", aliases=("ctc_loss",))
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first", **_):
    """Per-sequence CTC loss of ``data`` ``(T, B, V)`` activations (a log
    softmax is taken here) against ``label`` ``(B, L)``.  MXNet's
    conventions: ``blank_label="first"`` reserves class 0 (tokens 1..V-1,
    a label <= 0 pads), ``"last"`` reserves class V-1 (tokens 0..V-2, a
    negative label pads); ``use_*_lengths`` take the lengths as given."""
    t, b, v = data.shape
    lab = label.to(torch.int64)
    blank = 0 if blank_label == "first" else v - 1
    if use_label_lengths and label_lengths is not None:
        tgt_len = label_lengths.to(torch.int64)
    else:
        pad = lab <= 0 if blank_label == "first" else lab < 0
        tgt_len = (~pad).sum(dim=1)
    if use_data_lengths and data_lengths is not None:
        in_len = data_lengths.to(torch.int64)
    else:
        in_len = torch.full((b,), t, dtype=torch.int64, device=data.device)
    logp = torch.log_softmax(data.float(), dim=-1)
    loss = F.ctc_loss(logp, lab.clamp_min(0), in_len, tgt_len, blank=blank,
                      reduction="none")
    return loss.to(data.dtype)
