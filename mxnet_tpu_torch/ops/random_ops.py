"""Sampling ops (counterpart of ``mxnet_tpu.ops.random_ops``): the
``_random_*`` samplers and their ``_like`` twins, the per-element
``sample_*`` ops and ``sample_multinomial``.

Every draw runs on the op's device (``ctx``, the current context by
default, or the ``_like`` input's / the parameters' device) with a
generator of that device seeded from ``mx.random``'s stream
(``random.generator``), so a CUDA draw copies nothing from the host.
Negative binomials are Poisson draws at Gamma-distributed rates, as in
the reference.  No sampler has a gradient.
"""
from __future__ import annotations

import torch

from ..base import canonical_dtype
from .registry import register
from .tensor import _shape, device_of


def _gen(device):
    from ..random import generator
    return generator(device)


def _f(dtype):
    return torch.float32 if dtype in (None, "None") else \
        canonical_dtype(dtype)


def _uniform(shape, dtype, device, g):
    return torch.rand(shape, generator=g, device=device, dtype=dtype)


def _normal(shape, dtype, device, g):
    return torch.randn(shape, generator=g, device=device, dtype=dtype)


def _exponential(shape, dtype, device, g):
    return torch.empty(shape, dtype=dtype, device=device).exponential_(
        1.0, generator=g)


def _std_gamma(alpha, shape, device, g):
    """Gamma(alpha, 1) draws of ``shape`` (``alpha`` a number or a tensor
    broadcast to it), in f32."""
    if isinstance(alpha, torch.Tensor):
        a = alpha.float().expand(shape).contiguous()
    else:
        a = torch.full(shape, float(alpha), device=device)
    return torch._standard_gamma(a, generator=g)


def _poisson(rate, g):
    return torch.poisson(rate.float().contiguous(), generator=g)


def _nb(k, p, shape, device, g):
    """NB(k, p) = Poisson(Gamma(k) (1 - p) / p)."""
    return _poisson(_std_gamma(k, shape, device, g) * ((1.0 - p) / p), g)


def _gnb(mu, alpha, shape, device, g):
    """GNB(mu, alpha) = Poisson(Gamma(1 / alpha) mu alpha)."""
    return _poisson(_std_gamma(1.0 / alpha, shape, device, g)
                    * (mu * alpha), g)


# ------------------------------------------------- fixed-parameter samplers
@register("_random_uniform", differentiable=False,
          aliases=("random_uniform", "uniform"))
def _random_uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None,
                    **_):
    dev = device_of(ctx)
    return _uniform(_shape(shape), _f(dtype), dev, _gen(dev)) \
        * (high - low) + low


@register("_random_normal", differentiable=False,
          aliases=("random_normal", "normal"))
def _random_normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None,
                   **_):
    dev = device_of(ctx)
    return loc + scale * _normal(_shape(shape), _f(dtype), dev, _gen(dev))


@register("_random_gamma", differentiable=False, aliases=("random_gamma",))
def _random_gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None,
                  **_):
    dev = device_of(ctx)
    return (beta * _std_gamma(alpha, _shape(shape), dev, _gen(dev))).to(
        _f(dtype))


@register("_random_exponential", differentiable=False,
          aliases=("random_exponential",))
def _random_exponential(lam=1.0, shape=None, dtype=None, ctx=None, **_):
    dev = device_of(ctx)
    return _exponential(_shape(shape), _f(dtype), dev, _gen(dev)) / lam


@register("_random_poisson", differentiable=False,
          aliases=("random_poisson",))
def _random_poisson(lam=1.0, shape=None, dtype=None, ctx=None, **_):
    dev = device_of(ctx)
    rate = torch.full(_shape(shape), float(lam), device=dev)
    return _poisson(rate, _gen(dev)).to(_f(dtype))


@register("_random_negative_binomial", differentiable=False,
          aliases=("random_negative_binomial",))
def _random_negative_binomial(k=1, p=1.0, shape=None, dtype=None, ctx=None,
                              **_):
    dev = device_of(ctx)
    return _nb(float(k), float(p), _shape(shape), dev, _gen(dev)).to(
        _f(dtype))


@register("_random_generalized_negative_binomial", differentiable=False,
          aliases=("random_generalized_negative_binomial",))
def _random_gen_neg_binomial(mu=1.0, alpha=1.0, shape=None, dtype=None,
                             ctx=None, **_):
    dev = device_of(ctx)
    return _gnb(mu, alpha, _shape(shape), dev, _gen(dev)).to(_f(dtype))


@register("_random_randint", differentiable=False,
          aliases=("random_randint", "randint"))
def _random_randint(low=0, high=1, shape=None, dtype=None, ctx=None, **_):
    dev = device_of(ctx)
    dt = torch.int32 if dtype in (None, "None") else canonical_dtype(dtype)
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=_gen(dev), device=dev, dtype=dt)


# ------------------------------------------------------------ like samplers
@register("_random_uniform_like", differentiable=False,
          aliases=("uniform_like",))
def _random_uniform_like(data, low=0.0, high=1.0, **_):
    return _uniform(data.shape, data.dtype, data.device,
                    _gen(data.device)) * (high - low) + low


@register("_random_normal_like", differentiable=False,
          aliases=("normal_like",))
def _random_normal_like(data, loc=0.0, scale=1.0, **_):
    return loc + scale * _normal(data.shape, data.dtype, data.device,
                                 _gen(data.device))


@register("_random_gamma_like", differentiable=False)
def _random_gamma_like(data, alpha=1.0, beta=1.0, **_):
    return (beta * _std_gamma(alpha, data.shape, data.device,
                              _gen(data.device))).to(data.dtype)


@register("_random_exponential_like", differentiable=False)
def _random_exponential_like(data, lam=1.0, **_):
    return _exponential(data.shape, data.dtype, data.device,
                        _gen(data.device)) / lam


@register("_random_poisson_like", differentiable=False)
def _random_poisson_like(data, lam=1.0, **_):
    rate = torch.full(data.shape, float(lam), device=data.device)
    return _poisson(rate, _gen(data.device)).to(data.dtype)


@register("_random_negative_binomial_like", differentiable=False)
def _random_negative_binomial_like(data, k=1, p=1.0, **_):
    return _nb(float(k), float(p), data.shape, data.device,
               _gen(data.device)).to(data.dtype)


@register("_random_generalized_negative_binomial_like",
          differentiable=False)
def _random_gen_neg_binomial_like(data, mu=1.0, alpha=1.0, **_):
    return _gnb(mu, alpha, data.shape, data.device,
                _gen(data.device)).to(data.dtype)


# ------------------------------------- per-element parameters (sample_*)
def _per_element(params, shape, draw):
    """The reference's multisample frame: each element of the parameter
    tensors yields ``shape`` draws appended to its own axes."""
    extra = _shape(shape)
    out_shape = tuple(params[0].shape) + extra
    ps = [p.reshape(tuple(p.shape) + (1,) * len(extra)) for p in params]
    dev = params[0].device
    return draw(out_shape, dev, _gen(dev), *ps)


@register("sample_uniform", differentiable=False,
          aliases=("_sample_uniform",))
def _sample_uniform(low, high, shape=None, dtype=None, **_):
    return _per_element((low, high), shape, lambda s, d, g, lo, hi:
                        lo + (hi - lo) * _uniform(s, _f(dtype), d, g))


@register("sample_normal", differentiable=False, aliases=("_sample_normal",))
def _sample_normal(mu, sigma, shape=None, dtype=None, **_):
    return _per_element((mu, sigma), shape, lambda s, d, g, m, sg:
                        m + sg * _normal(s, _f(dtype), d, g))


@register("sample_gamma", differentiable=False, aliases=("_sample_gamma",))
def _sample_gamma(alpha, beta, shape=None, dtype=None, **_):
    return _per_element((alpha, beta), shape, lambda s, d, g, a, b:
                        (b * _std_gamma(a, s, d, g)).to(_f(dtype)))


@register("sample_exponential", differentiable=False,
          aliases=("_sample_exponential",))
def _sample_exponential(lam, shape=None, dtype=None, **_):
    return _per_element((lam,), shape, lambda s, d, g, lm:
                        _exponential(s, _f(dtype), d, g) / lm)


@register("sample_poisson", differentiable=False,
          aliases=("_sample_poisson",))
def _sample_poisson(lam, shape=None, dtype=None, **_):
    return _per_element((lam,), shape, lambda s, d, g, lm:
                        _poisson(lm.expand(s), g).to(_f(dtype)))


@register("sample_negative_binomial", differentiable=False,
          aliases=("_sample_negative_binomial",))
def _sample_negative_binomial(k, p, shape=None, dtype=None, **_):
    return _per_element((k, p), shape, lambda s, d, g, kk, pp:
                        _nb(kk, pp, s, d, g).to(_f(dtype)))


@register("sample_generalized_negative_binomial", differentiable=False,
          aliases=("_sample_generalized_negative_binomial",))
def _sample_gen_negative_binomial(mu, alpha, shape=None, dtype=None, **_):
    return _per_element((mu, alpha), shape, lambda s, d, g, m, a:
                        _gnb(m, a, s, d, g).to(_f(dtype)))


@register("sample_multinomial", differentiable=False,
          aliases=("_sample_multinomial", "multinomial"), num_outputs=-1)
def _sample_multinomial(data, shape=None, get_prob=False, dtype="int32",
                        **_):
    """Class indices drawn from the probability rows (last axis) of
    ``data``: one per row, or ``shape`` of them; with ``get_prob`` also
    the log of each drawn class's probability (floored at 1e-37)."""
    extra = _shape(shape) if shape not in (None, ()) else ()
    n = 1
    for s in extra:
        n *= s
    rows = data.reshape(-1, data.shape[-1]).float()
    draws = torch.multinomial(rows, n, replacement=True,
                              generator=_gen(data.device))
    out_shape = tuple(data.shape[:-1]) + extra
    idx = draws.reshape(out_shape).to(canonical_dtype(dtype))
    if not get_prob:
        return idx
    logp = torch.log(torch.clamp_min(data, 1e-37))
    lp = torch.gather(logp.reshape(-1, data.shape[-1]), 1, draws)
    return idx, lp.reshape(out_shape)
