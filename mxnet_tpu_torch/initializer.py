"""Weight initializers (counterpart of ``mxnet_tpu.initializer``).

An ``Initializer`` is keyed by lowercase class name in a registry and
dispatches on the parameter's name as the reference does: ``*gamma`` ->
ones, ``*beta`` / ``*bias`` -> zeros, ``*running_mean`` /
``*moving_mean`` -> zeros, ``*running_var`` / ``*moving_var`` -> ones,
anything else -> ``_init_weight``.  ``generate(gen, shape, dtype, name)``
draws from an explicit CPU ``torch.Generator`` (``mx.random``) and
returns a CPU tensor, which the parameter then places on its device.
``init(desc, arr)`` (also ``init.init``) is the reference's calling
convention: it sets the NDArray ``arr`` from the next generator of
``mx.random``'s stream, and an ``InitDesc`` whose attrs carry
``__init__`` (an initializer's ``dumps()``, as ``sym.Variable(init=...)``
stores it) is set by that initializer instead.
"""
from __future__ import annotations

import json
import math

import torch

from . import random as _random
from .base import torch_dtype

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Uniform", "Normal", "Xavier"]

_INIT_REGISTRY = {}
_INIT_ALIASES = {"zero": ("zeros",), "one": ("ones",),
                 "normal": ("gaussian",)}


class InitDesc(str):
    """Parameter name plus attributes (reference ``InitDesc``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def register(klass):
    name = klass.__name__.lower()
    _INIT_REGISTRY[name] = klass
    for alias in _INIT_ALIASES.get(name, ()):
        _INIT_REGISTRY[alias] = klass
    return klass


def create(initializer, **kwargs):
    """An initializer from a name, an instance or ``None`` (Uniform)."""
    if initializer is None:
        return Uniform()
    if isinstance(initializer, Initializer):
        return initializer
    if isinstance(initializer, str):
        name = initializer.lower()
        if name not in _INIT_REGISTRY:
            raise ValueError("unknown initializer %r" % initializer)
        return _INIT_REGISTRY[name](**kwargs)
    raise TypeError("cannot create initializer from %r" % (initializer,))


class Initializer:
    """Base initializer; subclasses implement
    ``_init_weight(name, gen, shape, dtype) -> tensor``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__.lower(), self._kwargs)

    def dumps(self):
        """``[name, kwargs]`` as JSON: what :func:`create` takes back."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __eq__(self, other):
        return (self.__class__ is other.__class__
                and self._kwargs == getattr(other, "_kwargs", None))

    def __call__(self, desc, arr):
        """Set NDArray ``arr`` as the initial value of parameter ``desc``
        (a name or an :class:`InitDesc`; an ``InitDesc`` gets this
        initializer as its ``global_init`` when it has none)."""
        if not isinstance(desc, str):
            raise TypeError("desc must be str or InitDesc")
        if isinstance(desc, InitDesc) and desc.global_init is None:
            desc.global_init = self
        spec = desc.attrs.get("__init__", "") \
            if isinstance(desc, InitDesc) else ""
        if spec:
            name, kwargs = json.loads(spec)
            create(name, **kwargs)._init(desc, arr)
        else:
            self._init(str(desc), arr)

    init = __call__

    def _init(self, name, arr):
        val = self.generate(_random.next_key(), arr.shape, arr._data.dtype,
                            name=name)
        arr._set_data(val.to(arr._data.device))

    def generate(self, gen, shape, dtype="float32", name=""):
        """The initial value of parameter ``name`` (a CPU tensor)."""
        name = name or ""
        dtype = torch_dtype(dtype)
        shape = tuple(shape)
        if name.endswith("gamma"):
            return torch.ones(shape, dtype=dtype)
        if name.endswith("beta") or name.endswith("bias"):
            return torch.zeros(shape, dtype=dtype)
        if name.endswith("running_mean") or name.endswith("moving_mean"):
            return torch.zeros(shape, dtype=dtype)
        if name.endswith("running_var") or name.endswith("moving_var"):
            return torch.ones(shape, dtype=dtype)
        return self._init_weight(name, gen, shape, dtype)

    def _init_weight(self, name, gen, shape, dtype):
        raise NotImplementedError


def _uniform(gen, shape, dtype, low, high):
    """U[low, high) drawn in f32 from ``gen``, then cast."""
    t = torch.empty(shape, dtype=torch.float32)
    return t.uniform_(low, high, generator=gen).to(dtype)


@register
class Zero(Initializer):
    def _init_weight(self, name, gen, shape, dtype):
        return torch.zeros(shape, dtype=dtype)


@register
class One(Initializer):
    def _init_weight(self, name, gen, shape, dtype):
        return torch.ones(shape, dtype=dtype)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, gen, shape, dtype):
        return _uniform(gen, shape, dtype, -self.scale, self.scale)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, gen, shape, dtype):
        return (self.sigma * torch.randn(shape, generator=gen)).to(dtype)


@register
class Xavier(Initializer):
    """Scale from fan-in/fan-out (reference ``Xavier``): U[-s, s] or
    N(0, s) with ``s = sqrt(magnitude / factor)``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, gen, shape, dtype):
        if len(shape) < 2:
            raise ValueError("Xavier initializer needs >=2D shape for %r, "
                             "got %s" % (name, shape))
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            return _uniform(gen, shape, dtype, -scale, scale)
        if self.rnd_type == "gaussian":
            return (scale * torch.randn(shape, generator=gen)).to(dtype)
        raise ValueError("Unknown random type")
