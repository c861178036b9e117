"""Parameter and ParameterDict (counterpart of
``mxnet_tpu.gluon.parameter``).

A Parameter owns one value, an NDArray over a tensor on one device, with
deferred shape inference: a shape holding 0s is completed by the owning
layer at the first forward, and the value is drawn then.  With
``grad_req`` ``'write'`` or ``'add'`` it also owns a gradient buffer, and
its value is marked as a leaf of the autograd tape with that buffer
(``autograd.mark_variables``), so ``loss.backward()`` under
``autograd.record()`` fills ``grad()`` for ``gluon.Trainer``.
``parallel.SPMDTrainer`` does not read the buffers: it differentiates its
own copies of the values.  A ParameterDict is the prefix-scoped registry
Blocks share; its ``save`` / ``load`` write and read the reference's
npz container (``nd.save``), so either package loads the other's files.
One device per parameter: a list of several contexts raises
``NotImplementedError``.  The row-sparse reads (``row_sparse_data``,
``list_row_sparse_data``) wait for the sparse arrays.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch

from ..base import MXNetError, torch_dtype
from ..context import cpu, gpu, resolve_device
from ..ndarray.ndarray import NDArray, _wrap
from ..ndarray import ndarray as ndarray_mod
from .. import autograd
from .. import initializer
from .. import random as _random

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "tensor_types"]

tensor_types = (NDArray,)


class DeferredInitializationError(MXNetError):
    """The parameter's value waits for its first forward to know its
    shape."""


def _device(ctx):
    """One ``torch.device`` from a context, device or a list of one."""
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise NotImplementedError(
                "parameters on several devices are not ported (got %r): "
                "one device per parameter" % (ctx,))
        ctx = ctx[0]
    return resolve_device(ctx)


class Parameter:
    """A container holding one parameter's value (reference
    ``gluon/parameter.py:46``)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._var = None
        self._data = None
        self._grad = None
        self._device = None
        self._deferred_init = ()
        self._differentiable = differentiable
        self._allow_deferred_init = allow_deferred_init
        self._grad_req = None
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.name = name
        self._dtype = torch_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req
        self.init = init
        for st in (stype, grad_stype):
            if st not in ("default", "row_sparse", "csr"):
                raise ValueError("invalid stype '%s'" % st)
        self._stype = stype
        self._grad_stype = grad_stype

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    # ----------------------------------------------------------- properties
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        assert req in ("write", "add", "null"), \
            "grad_req must be one of 'write', 'add', or 'null', but got " \
            "'%s'" % req
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = None
            if self._data is not None:
                self._data._grad = None
                self._data._grad_req = None
                self._data._on_tape = False
                self._data._data = self._data._data.detach()
        elif self._data is not None:
            self._init_grad()

    @property
    def dtype(self):
        return self._dtype

    @dtype.setter
    def dtype(self, dtype):
        self.cast(dtype)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        assert len(self._shape) == len(new_shape) and \
            all(j in (0, i) for i, j in zip(new_shape, self._shape)), \
            "Expected shape %s is incompatible with given shape %s." % (
                str(new_shape), str(self._shape))
        self._shape = tuple(new_shape)

    @property
    def stype(self):
        return self._stype

    @property
    def grad_stype(self):
        return self._grad_stype

    # ------------------------------------------------------------- internal
    def _check_and_get(self, arr):
        if arr is not None:
            return arr
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass. Please pass one batch of "
                "data through the network before accessing Parameters."
                % self.name)
        raise RuntimeError(
            "Parameter '%s' has not been initialized. Note that you should "
            "initialize parameters and create Trainer with "
            "Block.collect_params() instead of Block.params because the "
            "later does not include Parameters of nested child Blocks"
            % self.name)

    def _load_init(self, data, ctx, cast_dtype=False,
                   dtype_source="current"):
        """Initialize from a loaded array (reference
        ``parameter.py:274``): the shape must agree where it is known,
        and the dtype too unless ``cast_dtype`` (then the parameter's
        dtype wins, or the file's with ``dtype_source='saved'``)."""
        t = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(data)
        if cast_dtype:
            if dtype_source == "current":
                t = t.to(self.dtype)
            elif dtype_source == "saved":
                self._dtype = t.dtype
        if self.shape:
            unknown = any(s == 0 for s in self.shape)
            if not unknown and tuple(self.shape) != tuple(t.shape):
                raise AssertionError(
                    "Failed loading Parameter '%s' from saved params: "
                    "shape incompatible expected %s vs saved %s" % (
                        self.name, str(self.shape), str(tuple(t.shape))))
            self._shape = tuple(t.shape)
        if not cast_dtype and self.dtype != t.dtype:
            raise AssertionError(
                "Failed loading Parameter '%s' from saved params: dtype "
                "incompatible expected %s vs saved %s. Set cast_dtype=True "
                "to cast the dtype of saved params." % (
                    self.name, str(self.dtype), str(t.dtype)))
        self._init_impl(t, _device(ctx))
        self._deferred_init = ()

    def _reduce(self):
        """The value as an NDArray to save (reference
        ``parameter.py:354``)."""
        return _wrap(self.data()._data.detach())

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, device, default_init, data = self._deferred_init
        self._deferred_init = ()
        assert self.shape is not None and math.prod(self.shape) > 0, \
            "Cannot initialize Parameter '%s' because it has invalid " \
            "shape: %s. Please specify in_units, in_channels, etc for " \
            "`Block`s." % (self.name, str(self.shape))
        if data is None:
            gen = init if init is not None else (
                self.init if self.init is not None else default_init)
            if isinstance(gen, str):
                gen = initializer.create(gen)
            data = gen.generate(_random.next_key(), self.shape, self.dtype,
                                name=self.name)
        self._init_impl(data, device)

    def _init_impl(self, data, device):
        if isinstance(data, NDArray):
            data = data._data
        self._device = device
        self._data = _wrap(torch.as_tensor(data).detach().to(
            device=device, dtype=self.dtype).clone())
        self._init_grad()

    def _init_grad(self):
        """A zero gradient buffer, and the value marked as a tape leaf
        with it (none for ``grad_req='null'``)."""
        if self.grad_req == "null":
            self._grad = None
            return
        self._grad = _wrap(torch.zeros_like(self._data._data.detach()))
        autograd.mark_variables([self._data], [self._grad], self.grad_req)

    # ---------------------------------------------------------------- public
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize the value, or defer it to the first forward when the
        shape is not known yet.  ``ctx`` defaults to the current context
        (``cuda:0`` unless the caller asks for the CPU)."""
        if default_init is None:
            default_init = initializer.Uniform()
        if self._data is not None and not force_reinit:
            return
        device = _device(ctx)
        if self.shape is None or any(s == 0 for s in self.shape):
            if self._allow_deferred_init:
                self._deferred_init = (init, device, default_init, None)
                return
            raise ValueError("Cannot initialize Parameter '%s' because it "
                             "has invalid shape: %s." % (self.name,
                                                         str(self.shape)))
        self._deferred_init = (init, device, default_init, None)
        self._finish_deferred_init()

    def reset_ctx(self, ctx):
        """Move the value (and its gradient buffer) to ``ctx``; a
        deferred parameter will be drawn there (reference
        ``parameter.py:414``)."""
        device = _device(ctx)
        if self._data is not None:
            self._device = device
            with torch.no_grad():
                self._data._data = self._data._data.detach().to(device)
            self._init_grad()
        elif self._deferred_init:
            init, _, default_init, data = self._deferred_init
            self._deferred_init = (init, device, default_init, data)
        else:
            raise ValueError("Cannot reset context for Parameter '%s' "
                             "because it has not been initialized."
                             % self.name)

    def set_data(self, data):
        """Set this parameter's value (reference ``parameter.py:439``); a
        deferred parameter keeps it for its first forward."""
        self.shape = tuple(data.shape)
        if isinstance(data, NDArray):
            data = data._data
        if self._data is None:
            assert self._deferred_init, \
                "Parameter '%s' has not been initialized" % self.name
            init, device, default_init, _ = self._deferred_init
            self._deferred_init = (init, device, default_init, data)
            return
        old = self._data._data
        self._data._data = torch.as_tensor(data).detach().to(
            device=old.device, dtype=old.dtype).clone()

    def data(self, ctx=None):
        return self._check_and_get(self._data)

    def list_data(self):
        """The value, once per context: one here."""
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient buffer (reference ``parameter.py:302``)."""
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter '%s' because "
                "grad_req='null'" % (self.name,))
        self._check_and_get(self._data)
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        """The one context the value lives on."""
        if self._data is None:
            if self._deferred_init:
                return [_context(self._deferred_init[1])]
            raise RuntimeError("Parameter '%s' has not been initialized"
                               % self.name)
        return [_context(self._data._data.device)]

    def zero_grad(self):
        """Set the gradient buffer to 0 (reference ``parameter.py:321``)."""
        if self._grad is None:
            return
        self._grad._data = torch.zeros_like(self._grad._data)

    def var(self):
        """The Symbol of this parameter (reference ``parameter.py:584``)."""
        if self._var is None:
            from ..symbol import var
            self._var = var(self.name, shape=self.shape, dtype=self.dtype,
                            lr_mult=self.lr_mult, wd_mult=self.wd_mult,
                            init=self.init)
        return self._var

    def cast(self, dtype):
        self._dtype = torch_dtype(dtype)
        if self._data is None:
            return
        with torch.no_grad():
            self._data._data = self._data._data.detach().to(self._dtype)
            if self._grad is not None:
                self._grad._data = self._grad._data.to(self._dtype)
                autograd.mark_variables([self._data], [self._grad],
                                        self.grad_req)


class Constant(Parameter):
    """A parameter whose value never trains (``grad_req='null'``;
    reference ``parameter.py:636``)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = ndarray_mod.array(value, ctx=cpu())
        self.value = value
        const = value._data.detach().cpu()

        class Init(initializer.Initializer):
            def _init_weight(self, _name, _gen, shape, dtype):
                return const.to(dtype).reshape(shape).clone()

        init_name = "Constant_{}_{}".format(name, id(self)).lower()
        initializer._INIT_REGISTRY[init_name] = Init
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=const.dtype, init=init_name)

    def generate(self, gen, shape, dtype="float32", name=""):
        return self.value._data.detach().cpu().to(torch_dtype(dtype))


def _context(device):
    """The Context of a ``torch.device``."""
    return gpu(device.index or 0) if device.type == "cuda" else cpu()


class ParameterDict:
    """A prefix-scoped dictionary of Parameters (reference
    ``gluon/parameter.py:694``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __getitem__(self, key):
        return self._params[key]

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return "%s(\n%s\n)" % (name, "\n".join(repr(v)
                                               for v in self.values()))

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._shared._params[name]
        return None

    def get(self, name, **kwargs):
        """Retrieve or create the Parameter ``prefix + name`` (reference
        ``parameter.py:740``); a retrieved one must agree with the given
        attributes, a 0 in a given shape matching anything."""
        name = self.prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
                continue
            if k == "shape" and v is not None and len(v) == len(existing):
                if all(a == b or a <= 0 or b <= 0
                       for a, b in zip(v, existing)):
                    param._shape = tuple(b if a in (0, -1) else a
                                         for a, b in zip(v, existing))
                    continue
            if k == "dtype":
                v = torch_dtype(v)
            assert v is None or str(v) == str(existing), \
                "Cannot retrieve Parameter '%s' because desired attribute " \
                "does not match with stored for attribute '%s': desired " \
                "'%s' vs stored '%s'." % (name, k, str(v), str(existing))
        return param

    def get_constant(self, name, value=None):
        """Retrieve or create the Constant ``prefix + name`` (reference
        ``parameter.py:791``)."""
        name = self.prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError("No constant named '{}'. Please specify "
                               "value if you want to create a new "
                               "constant.".format(name))
            param = Constant(name, value)
            self._params[name] = param
        elif value is not None:
            assert isinstance(param, Constant), \
                "Parameter '{}' already exists but it is not a " \
                "constant.".format(name)
            if isinstance(value, NDArray):
                value = value.asnumpy()
            import numpy as _np
            assert param.shape == tuple(_np.shape(value)) and \
                _np.array_equal(param.value.asnumpy(), value), \
                "Constant '{}' already exists but its value doesn't " \
                "match new value".format(name)
        return param

    def update(self, other):
        """Copy every Parameter of ``other`` into self."""
        for k, v in other.items():
            if k in self._params:
                assert self._params[k] is v, \
                    "Cannot update self with other because they have " \
                    "different Parameters with the same name '%s'" % k
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = initializer.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()


    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def list_ctx(self):
        s = set()
        for v in self.values():
            s.update(v.list_ctx())
        return sorted(s, key=str)

    def setattr(self, name, value):
        """Set attribute ``name`` of every Parameter."""
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Save every value under its name less ``strip_prefix``
        (reference ``parameter.py:858``)."""
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix '%s' is to be striped before saving, but "
                    "Parameter's name '%s' does not start with '%s'" % (
                        strip_prefix, param.name, strip_prefix))
            arg_dict[param.name[len(strip_prefix):]] = param._reduce()
        ndarray_mod.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix="", cast_dtype=False,
             dtype_source="current"):
        """Load values from a file :meth:`save` (or a checkpoint's
        ``arg:``/``aux:`` params) wrote (reference ``parameter.py:880``)."""
        if restore_prefix:
            for name in self.keys():
                assert name.startswith(restore_prefix), \
                    "restore_prefix is '%s' but Parameter name '%s' does " \
                    "not start with '%s'" % (restore_prefix, name,
                                             restore_prefix)
        lprefix = len(restore_prefix)
        loaded = ndarray_mod.load(filename)
        if not isinstance(loaded, dict):
            raise ValueError("Expected a dict of arrays in %s" % filename)
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                assert name in arg_dict, \
                    "Parameter '%s' is missing in file '%s'" % (
                        name[lprefix:], filename)
        for name in arg_dict:
            if name not in self._params:
                assert ignore_extra, \
                    "Parameter '%s' loaded from file '%s' is not present " \
                    "in ParameterDict" % (name[lprefix:], filename)
                continue
            self[name]._load_init(arg_dict[name], ctx,
                                  cast_dtype=cast_dtype,
                                  dtype_source=dtype_source)
