"""Weight initializers (counterpart of ``mxnet_tpu.initializer``).

An ``Initializer`` is keyed by lowercase class name in a registry and
dispatches on the parameter's name as the reference does: ``*gamma`` ->
ones, ``*beta`` / ``*bias`` -> zeros, ``*running_mean`` /
``*moving_mean`` -> zeros, ``*running_var`` / ``*moving_var`` -> ones,
anything else -> ``_init_weight``.  ``generate(gen, shape, dtype, name)``
draws from an explicit CPU ``torch.Generator`` (``mx.random``) and
returns a CPU tensor, which the parameter then places on its device.
``FusedRNN`` fills a fused RNN's flat parameter blob region by region
(``rnn/_fused_layout.py``) or, by name, the gate-stacked parameters of
the Gluon RNN layers.
``init(desc, arr)`` (also ``init.init``) is the reference's calling
convention: it sets the NDArray ``arr`` from the next generator of
``mx.random``'s stream, and an ``InitDesc`` whose attrs carry
``__init__`` (an initializer's ``dumps()``, as ``sym.Variable(init=...)``
stores it) is set by that initializer instead.
"""
from __future__ import annotations

import json
import math
import re

import torch

from . import random as _random
from .base import torch_dtype

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "LSTMBias", "FusedRNN", "Mixed", "Load"]

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
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, gen, shape, dtype):
        return torch.full(shape, self.value, dtype=dtype)


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
class Orthogonal(Initializer):
    """An orthonormal basis from the SVD of a random ``[out, in]`` draw
    (reference ``Orthogonal``), times ``scale``."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, gen, shape, dtype):
        nout = shape[0]
        nin = math.prod(shape[1:]) if len(shape) > 1 else 1
        if self.rand_type == "uniform":
            tmp = _uniform(gen, (nout, nin), torch.float32, -1.0, 1.0)
        else:
            tmp = torch.randn((nout, nin), generator=gen)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        res = u if tuple(u.shape) == (nout, nin) else v
        return (self.scale * res).reshape(shape).to(dtype)


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


@register
class MSRAPrelu(Xavier):
    """Xavier with gaussian draws at ``magnitude = 2 / (1 + slope^2)``
    (reference ``MSRAPrelu``)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """A bilinear upsampling kernel (reference ``Bilinear``)."""

    def _init_weight(self, name, gen, shape, dtype):
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = torch.arange(math.prod(shape), dtype=torch.float64)
        x = torch.remainder(i, shape[3])
        y = torch.remainder(torch.div(i, shape[3], rounding_mode="floor"),
                            shape[2])
        w = (1 - (x / f - c).abs()) * (1 - (y / f - c).abs())
        return w.to(torch.float32).reshape(shape).to(dtype)


@register
class LSTMBias(Initializer):
    """Zeros with ``forget_bias`` in the forget gate's rows (reference
    ``LSTMBias``); it overrides ``generate``, since the name rule would
    zero every ``*bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def generate(self, gen, shape, dtype="float32", name=""):
        b = torch.zeros(tuple(shape), dtype=torch.float32)
        num_hidden = int(shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        return b.to(torch_dtype(dtype))


@register
class FusedRNN(Initializer):
    """Initialize fused-RNN parameters (reference ``initializer.py:715``).

    The flat blob of ``mx.rnn.FusedRNNCell`` (a 1-D parameter not named
    ``*bias``) is filled region by region: the weights from ``init`` (or,
    when it is None, the initializer the Module was given), the biases
    zeros with ``forget_bias`` in the LSTM's i2h forget-gate rows.  The
    Gluon layers' separate gate-stacked parameters get the same contract
    by name."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = create(klass, **kwargs)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._inner = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias
        self._global = None

    def _init(self, name, arr):
        # the job's own initializer, for the weights when ``init`` is None
        # (reference: "Fall back to global initializer if None")
        self._global = getattr(name, "global_init", None)
        super()._init(name, arr)

    def _weight_init(self):
        return self._inner or self._global or Uniform(0.07)

    def generate(self, gen, shape, dtype="float32", name=""):
        lname = str(name).lower()
        shape = tuple(shape)
        if len(shape) == 1 and "bias" not in lname:
            return self._generate_blob(gen, shape, dtype)
        if "bias" in lname:
            b = torch.zeros(shape, dtype=torch.float32)
            if self._mode == "lstm" and "i2h" in lname:
                h = self._num_hidden
                b[h:2 * h] = self._forget_bias
            return b.to(torch_dtype(dtype))
        return self._weight_init().generate(gen, shape, dtype, name=name)

    def _generate_blob(self, gen, shape, dtype):
        from .rnn._fused_layout import (fused_rnn_num_input,
                                        fused_rnn_regions)
        h = self._num_hidden
        ni = fused_rnn_num_input(int(shape[0]), h, self._num_layers,
                                 self._mode, self._bidirectional)
        regions, total = fused_rnn_regions(ni, h, self._num_layers,
                                           self._mode, self._bidirectional)
        if total != int(shape[0]):
            raise ValueError("FusedRNN blob size %d does not match the "
                             "cell geometry %d" % (shape[0], total))
        weight_init = self._weight_init()
        blob = torch.zeros((total,), dtype=torch.float32)
        for rname, off, rshape, kind in regions:
            size = math.prod(rshape)
            if kind.endswith("_weight"):
                blob[off:off + size] = weight_init.generate(
                    gen, rshape, torch.float32, name=rname).reshape(-1)
            elif self._mode == "lstm" and kind == "i2h_bias" \
                    and "_i2h_f_" in rname:
                blob[off:off + size] = self._forget_bias
        return blob.to(torch_dtype(dtype))


class Mixed:
    """The first initializer whose pattern matches the name (reference
    ``Mixed``)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers lengths differ")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def _pick(self, name):
        for prog, init in self.map:
            if prog.match(str(name)):
                return init
        raise ValueError("Parameter name %s did not match any pattern"
                         % name)

    def __call__(self, name, arr):
        self._pick(name)(name, arr)

    def generate(self, gen, shape, dtype="float32", name=""):
        return self._pick(name).generate(gen, shape, dtype, name=name)


def _host_tensor(src, dtype):
    t = getattr(src, "_data", src)
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t)
    return t.detach().cpu().to(torch_dtype(dtype))


@register
class Load:
    """Values from a dict of saved arrays (``arg:``/``aux:`` prefixes
    dropped), else ``default_init`` (reference ``Load``)."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        name = str(name)
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise ValueError("Parameter %s shape mismatch" % name)
            arr._set_data(_host_tensor(src, arr._data.dtype).to(
                arr._data.device))
        else:
            if self.default_init is None:
                raise ValueError("Cannot init parameter %s from loaded "
                                 "file" % name)
            self.default_init(name, arr)

    def generate(self, gen, shape, dtype="float32", name=""):
        name = str(name)
        if name in self.param:
            return _host_tensor(self.param[name], dtype)
        if self.default_init is None:
            raise ValueError("Cannot init parameter %s from loaded file"
                             % name)
        return self.default_init.generate(gen, shape, dtype, name=name)
