"""Optimizer update ops (counterpart of ``mxnet_tpu.ops.optim_ops``): the
``*_update`` ops a custom loop calls as ``mx.nd.sgd_mom_update(w, g, m,
out=[w, m], ...)``.

As the reference's they are functional: each returns the new weight
first, then the new states, and writes nothing; the state reaches the
caller through ``out=``, which ``mx.nd`` honours.  The order of
operations is the reference's (the gradient rescaled, then clipped), so
the CPU results meet the reference's closely.  The ``mp_*`` ops keep an
f32 master and return the low-precision weight as the cast of the new
master.  These are plain PyTorch expressions, one tensor at a time; the
fused K1/K3 kernels stay on the optimizers' own routes.
"""
from __future__ import annotations

import torch

from .registry import register
from .tensor import weak


def _prep(grad, rescale_grad, clip_gradient):
    """The gradient rescaled, then clipped to ``[-c, c]`` for ``c >= 0``."""
    g = grad * weak(rescale_grad, grad) \
        if not isinstance(rescale_grad, torch.Tensor) \
        else grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        c = weak(float(clip_gradient), g)
        g = torch.clamp(g, -c, c)
    return g


@register("sgd_update")
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=False, **_):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


@register("sgd_mom_update", num_outputs=2)
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=False,
                    **_):
    """``(w + m, m)`` with ``m = momentum * mom - lr * (g + wd * w)``."""
    g = _prep(grad, rescale_grad, clip_gradient)
    m = momentum * mom - lr * (g + wd * weight)
    return weight + m, m


@register("mp_sgd_update", num_outputs=2)
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, **_):
    g = _prep(grad, rescale_grad, clip_gradient).float()
    new32 = weight32 - lr * (g + wd * weight32)
    return new32.to(weight.dtype), new32


@register("mp_sgd_mom_update", num_outputs=3)
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, **_):
    g = _prep(grad, rescale_grad, clip_gradient).float()
    m = momentum * mom - lr * (g + wd * weight32)
    new32 = weight32 + m
    return new32.to(weight.dtype), m, new32


@register("nag_mom_update", num_outputs=2)
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, **_):
    """Nesterov momentum."""
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    m = momentum * mom + g
    return weight - lr * (g + momentum * m), m


@register("mp_nag_mom_update", num_outputs=3)
def _mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, **_):
    g = _prep(grad, rescale_grad, clip_gradient).float() + wd * weight32
    m = momentum * mom + g
    new32 = weight32 - lr * (g + momentum * m)
    return new32.to(weight.dtype), m, new32


@register("adam_update", num_outputs=3)
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=False, **_):
    """Adam without bias correction: the caller folds it into ``lr``."""
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * g * g
    return weight - lr * m / (torch.sqrt(v) + epsilon), m, v


@register("ftml_update", num_outputs=4)
def _ftml_update(weight, grad, d, v, z, lr=0.001, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                 clip_grad=-1.0, **_):
    g = _prep(grad, rescale_grad, clip_grad) + wd * weight
    v_new = beta2 * v + (1 - beta2) * g * g
    d_new = (1 - beta1 ** t) / lr * \
        (torch.sqrt(v_new / (1 - beta2 ** t)) + epsilon)
    sigma = d_new - beta1 * d
    z_new = beta1 * z + (1 - beta1) * g - sigma * weight
    return -z_new / d_new, d_new, v_new, z_new


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        return torch.clamp(w, -clip_weights, clip_weights)
    return w


@register("rmsprop_update", num_outputs=2)
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0, **_):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    n_new = gamma1 * n + (1 - gamma1) * g * g
    new_w = weight - lr * g / (torch.sqrt(n_new) + epsilon)
    return _clip_weights(new_w, clip_weights), n_new


@register("rmspropalex_update", num_outputs=4)
def _rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0, **_):
    """RMSProp, Graves' centred variant."""
    gr = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    n_new = gamma1 * n + (1 - gamma1) * gr * gr
    g_new = gamma1 * g + (1 - gamma1) * gr
    delta_new = gamma2 * delta - \
        lr * gr / torch.sqrt(n_new - g_new * g_new + epsilon)
    return (_clip_weights(weight + delta_new, clip_weights), n_new, g_new,
            delta_new)


@register("ftrl_update", num_outputs=3)
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0, **_):
    """FTRL-proximal."""
    g = _prep(grad, rescale_grad, clip_gradient)
    n_new = n + g * g
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z_new = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(z_new) <= lamda1, torch.zeros_like(weight),
        -(z_new - torch.sign(z_new) * lamda1)
        / ((beta + torch.sqrt(n_new)) / lr + wd))
    return new_w, z_new, n_new


@register("signsgd_update")
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, **_):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * torch.sign(g + wd * weight)


@register("signum_update", num_outputs=2)
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, **_):
    g = _prep(grad, rescale_grad, clip_gradient)
    m = momentum * mom - (1 - momentum) * (g + wd * weight)
    return (1 - lr * wd_lh) * weight + lr * torch.sign(m), m


# ------------------------------------------------------------- multi-tensor
@register("multi_sum_sq", differentiable=False,
          aliases=("_contrib_multi_sum_sq",))
def _multi_sum_sq(*arrays, num_arrays=None, **_):
    """Each array's sum of squares, stacked."""
    n = num_arrays if num_arrays is not None else len(arrays)
    return torch.stack([torch.sum(torch.square(a)) for a in arrays[:n]])


@register("multi_lars", differentiable=False,
          aliases=("_contrib_multi_lars",))
def _multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001,
                eps=1e-8, rescale_grad=1.0, **_):
    """Layer-wise adaptive learning rates: ``lr * eta * |w| / (|g| + wd
    |w| + eps)`` where both norms are nonzero, else ``lr``."""
    wn = torch.sqrt(weights_sum_sq)
    gn = torch.sqrt(grads_sum_sq) * rescale_grad
    trust = eta * wn / (gn + wds * wn + eps)
    return torch.where((wn > 0) & (gn > 0), lrs * trust, lrs)


def _groups(tensors, per):
    return [tensors[i * per:(i + 1) * per]
            for i in range(len(tensors) // per)]


def _multi(step, per, names):
    """A ``multi_*`` op from its one-tensor ``step``: ``per`` inputs a
    tensor, per-tensor ``lrs``/``wds``; the outputs grouped by kind
    (all weights, then each state's)."""
    def op(*args, lrs=(), wds=(), num_weights=None, **attrs):
        outs = [step(*grp, lr=lrs[i], wd=wds[i], **attrs)
                for i, grp in enumerate(_groups(args, per))]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        return tuple(o[k] for k in range(len(outs[0])) for o in outs)
    for name in names:
        register(name, num_outputs=-1)(op)
    return op


_multi(_sgd_update, 2, ("multi_sgd_update",))
_multi(_sgd_mom_update, 3, ("multi_sgd_mom_update",))
_multi(_mp_sgd_update, 3, ("multi_mp_sgd_update",))
_multi(_mp_sgd_mom_update, 4, ("multi_mp_sgd_mom_update",))


def _preloaded(step, per, name):
    """A ``preloaded_multi_*`` op: ``lrs`` and ``wds`` are its last two
    inputs, tensors on the device (a schedule needs no host value)."""
    @register(name, num_outputs=-1)
    def op(*args, num_weights=None, **attrs):
        lrs, wds = args[-2].reshape(-1), args[-1].reshape(-1)
        outs = [step(*grp, lr=lrs[i], wd=wds[i], **attrs)
                for i, grp in enumerate(_groups(args[:-2], per))]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        return tuple(o[k] for k in range(len(outs[0])) for o in outs)


_preloaded(_sgd_update, 2, "preloaded_multi_sgd_update")
_preloaded(_sgd_mom_update, 3, "preloaded_multi_sgd_mom_update")
_preloaded(_mp_sgd_update, 3, "preloaded_multi_mp_sgd_update")
_preloaded(_mp_sgd_mom_update, 4, "preloaded_multi_mp_sgd_mom_update")


# ------------------------------------------------------------ adamw / lamb
def _adamw_core(w32, g, m, v, lr, beta1, beta2, epsilon, wd, eta,
                clip_gradient):
    if clip_gradient is not None and clip_gradient >= 0:
        c = weak(float(clip_gradient), g)
        g = torch.clamp(g, -c, c)
    nm = beta1 * m + (1 - beta1) * g
    nv = beta2 * v + (1 - beta2) * g * g
    nw = w32 - eta * (lr * nm / (torch.sqrt(nv) + epsilon) + wd * w32)
    return nw, nm, nv


@register("_adamw_update", aliases=("adamw_update",), num_outputs=3)
def _adamw_update(weight, grad, mean, var, rescale_grad, lr=0.001, beta1=0.9,
                  beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                  clip_gradient=-1.0, **_):
    """AdamW, decoupled weight decay; ``rescale_grad`` is a tensor (the
    dynamic loss scale)."""
    return _adamw_core(weight, grad * rescale_grad, mean, var, lr, beta1,
                       beta2, epsilon, wd, eta, clip_gradient)


@register("_mp_adamw_update", aliases=("mp_adamw_update",), num_outputs=4)
def _mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad,
                     lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                     eta=1.0, clip_gradient=-1.0, **_):
    n32, nm, nv = _adamw_core(weight32, (grad * rescale_grad).float(), mean,
                              var, lr, beta1, beta2, epsilon, wd, eta,
                              clip_gradient)
    return n32.to(weight.dtype), nm, nv, n32


@register("lamb_update_phase1", num_outputs=3)
def _lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                        epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0, **_):
    """LAMB's raw direction ``m^ / (sqrt(v^) + eps) + wd * w`` and the new
    moments."""
    g = _prep(grad, rescale_grad, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * g * g
    mh, vh = (m / (1 - beta1 ** t), v / (1 - beta2 ** t)) \
        if bias_correction else (m, v)
    return mh / (torch.sqrt(vh) + epsilon) + wd * weight, m, v


@register("lamb_update_phase2")
def _lamb_update_phase2(weight, g, r1, r2, lr=0.001, lower_bound=-1.0,
                        upper_bound=-1.0, **_):
    """LAMB's step: ``w - lr * (r1 / r2) * g``, the trust ratio 1 where a
    norm is 0."""
    if lower_bound is not None and lower_bound >= 0:
        r1 = torch.clamp_min(r1, lower_bound)
    if upper_bound is not None and upper_bound >= 0:
        r1 = torch.clamp_max(r1, upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    return weight - lr * ratio * g


def _multi_adamw(per, mp):
    """The fused AdamW over N groups and one trailing ``rescale_grad``
    tensor: a NaN, infinite or zero scale leaves every tensor as it was
    (the dynamic loss scale's contract), decided on the device."""
    def op(*args, lrs=(), wds=(), etas=(), beta1=0.9, beta2=0.999,
           epsilon=1e-8, clip_gradient=-1.0, num_weights=None, **_):
        scale = args[-1].reshape(())
        ok = torch.isfinite(scale) & (scale != 0)
        safe = torch.where(ok, scale, torch.ones_like(scale))
        outs = []
        for i, grp in enumerate(_groups(args[:-1], per)):
            w, g, m, v = grp[:4]
            w32 = grp[4] if mp else w
            gs = (g * safe).float() if mp else g * safe
            nw, nm, nv = _adamw_core(w32, gs, m, v, lrs[i], beta1, beta2,
                                     epsilon, wds[i], etas[i], clip_gradient)
            nw = torch.where(ok, nw, w32)
            new = (nw.to(w.dtype), torch.where(ok, nm, m),
                   torch.where(ok, nv, v))
            outs.append(new + ((nw,) if mp else ()))
        return tuple(o[k] for k in range(len(outs[0])) for o in outs)
    return op


register("_multi_adamw_update", aliases=("multi_adamw_update",),
         num_outputs=-1)(_multi_adamw(4, False))
register("_multi_mp_adamw_update", aliases=("multi_mp_adamw_update",),
         num_outputs=-1)(_multi_adamw(5, True))


# --------------------------------------------------------- adagrad / sparse
@register("_sparse_adagrad_update", num_outputs=2)
def _sparse_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-5,
                           rescale_grad=1.0, clip_gradient=-1.0, **_):
    """AdaGrad on dense inputs: ``history += g * g`` per element."""
    g = _prep(grad, rescale_grad, clip_gradient)
    h = history + g * g
    return weight - lr * g / (torch.sqrt(h) + epsilon), h


@register("_contrib_group_adagrad_update",
          aliases=("group_adagrad_update",), num_outputs=2)
def _group_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-5,
                          rescale_grad=1.0, clip_gradient=-1.0, **_):
    """Group AdaGrad: one accumulator a row, ``history += mean(g * g)``
    over the row."""
    g = _prep(grad, rescale_grad, clip_gradient)
    if g.dim() > 1:
        h = history + torch.mean(g * g, dim=tuple(range(1, g.dim())),
                                 keepdim=True)
    else:
        h = history + g * g
    return weight - lr * g / (torch.sqrt(h) + epsilon), h


# ------------------------------------------------------- loss-scale helpers
@register("all_finite", differentiable=False)
def _all_finite(data, init_output=True, **_):
    """``[1.0]`` when every element is finite, else ``[0.0]``."""
    return torch.all(torch.isfinite(data)).to(torch.float32).reshape(1)


@register("multi_all_finite", differentiable=False)
def _multi_all_finite(*arrays, num_arrays=None, init_output=True, **_):
    n = num_arrays if num_arrays is not None else len(arrays)
    ok = torch.stack([torch.all(torch.isfinite(a)) for a in arrays[:n]])
    return torch.all(ok).to(torch.float32).reshape(1)


@register("reset_arrays", differentiable=False, num_outputs=-1)
def _reset_arrays(*arrays, num_arrays=None, **_):
    """Zeros like each of N arrays."""
    n = num_arrays if num_arrays is not None else len(arrays)
    return tuple(torch.zeros_like(a) for a in arrays[:n])
