"""Random number management and the samplers (counterpart of
``mxnet_tpu.random``).

``mx.random.seed(s)`` seeds the process-wide state; every draw takes an
explicit ``torch.Generator`` derived from it (:func:`next_seed`), so a
draw is reproducible from the seed.

Two kinds of generator come from that stream.  The initializers take
:func:`next_key`, a CPU generator: a value is drawn on the host and then
placed, so the same seed gives the same numbers on every device.  The
samplers below, the ``_random_*`` / ``sample_*`` ops, ``shuffle`` and
``Dropout`` take :func:`generator` on their own device (a CUDA generator
for a CUDA draw, seeded from the same stream): the draw runs on the card
and nothing is copied from the host, and the same seed gives the same
bits twice on the same device.

``trace_key_scope`` keeps the reference's per-call key scope, which
``functionalize`` opens around a forward: inside it the stream derives
from the scope's generator instead of the global state.  The two
packages' streams differ for the same seed: tests make their inputs with
numpy and hold random ops by distribution.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "next_seed", "next_key", "generator", "trace_key_scope",
           "new_eager_seed_key", "uniform", "normal", "randn", "randint",
           "multinomial", "exponential", "gamma", "poisson",
           "negative_binomial", "generalized_negative_binomial"]


class _KeyState(threading.local):
    def __init__(self):
        self.seed_val = 0
        self.counter = 0
        self.trace_stack = []


_STATE = _KeyState()


def seed(seed_state, ctx="all"):
    """Set the global seed (``mx.random.seed``) and restart its stream."""
    _STATE.seed_val = int(seed_state)
    _STATE.counter = 0


def _generator(value):
    return torch.Generator().manual_seed(value & (2 ** 63 - 1))


def next_seed():
    """The next seed of the stream: drawn from the innermost
    ``trace_key_scope`` generator inside one, else the next of the global
    seed's stream."""
    if _STATE.trace_stack:
        top = _STATE.trace_stack[-1]
        return int(torch.randint(2 ** 62, (1,), generator=top))
    _STATE.counter += 1
    return _STATE.seed_val * 1_000_003 + _STATE.counter


def next_key():
    """A fresh CPU ``torch.Generator`` seeded from :func:`next_seed`."""
    return _generator(next_seed())


def generator(device):
    """A fresh ``torch.Generator`` on ``device`` seeded from
    :func:`next_seed`: the samplers' and ``Dropout``'s, so a draw runs
    where its output lives."""
    g = torch.Generator(device=device)
    g.manual_seed(next_seed() & (2 ** 63 - 1))
    return g


new_eager_seed_key = next_key


class trace_key_scope:
    """Push a generator for the duration of one functionalized call."""

    def __init__(self, key):
        self.key = key

    def __enter__(self):
        _STATE.trace_stack.append(self.key)
        return self

    def __exit__(self, *exc):
        _STATE.trace_stack.pop()


# ----------------------------------------------------------------- samplers
# ``mx.random.<sampler>`` (reference ``random.py:92-170``): each runs its
# registered op on ``ctx`` (the current context by default)
def _op(name, ctx, out, **attrs):
    from .ndarray import _apply_with_out
    from .ops.registry import get
    kwargs = dict(attrs, ctx=ctx)
    if out is not None:
        kwargs["out"] = out
    return _apply_with_out(get(name), (), kwargs)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **_):
    return _op("_random_uniform", ctx, out, low=low, high=high,
               shape=shape, dtype=dtype)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **_):
    return _op("_random_normal", ctx, out, loc=loc, scale=scale,
               shape=shape, dtype=dtype)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None, **_):
    return normal(loc, scale, shape, dtype, ctx)


def randint(low, high=None, shape=None, dtype="int32", ctx=None, out=None,
            **_):
    """Integers in ``[low, high)`` (``[0, low)`` with one bound); int32,
    as the reference's."""
    if high is None:
        low, high = 0, low
    return _op("_random_randint", ctx, out, low=low, high=high, shape=shape,
               dtype="int32")


def multinomial(data, shape=None, get_prob=False, dtype="int32", **_):
    """Class indices drawn from the probability rows of ``data``: one per
    row, or ``shape`` more axes of draws per row; int32."""
    from .ops.registry import invoke
    return invoke("sample_multinomial", data, shape=shape,
                  get_prob=get_prob, dtype="int32")


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None,
                **_):
    """Exponential draws of mean ``scale``."""
    return _op("_random_exponential", ctx, out, lam=1.0 / scale,
               shape=shape, dtype=dtype)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None, **_):
    return _op("_random_gamma", ctx, out, alpha=alpha, beta=beta,
               shape=shape, dtype=dtype)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None, **_):
    return _op("_random_poisson", ctx, out, lam=lam, shape=shape,
               dtype="float32")


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None, **_):
    return _op("_random_negative_binomial", ctx, out, k=k, p=p, shape=shape,
               dtype="float32")


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None, **_):
    """NB(k = 1/alpha, p = k / (k + mu)), as the reference's."""
    k = 1.0 / alpha
    return negative_binomial(k, k / (k + mu), shape, dtype, ctx, out)
