"""Block / HybridBlock — the Gluon module system (counterpart of
``mxnet_tpu.gluon.block``).

The MXNet semantics are kept: name scopes and their prefix counters
(``_BlockScope``) name every parameter as the reference does,
``collect_params`` walks children in registration order, registered
Parameters reach ``hybrid_forward(F, x, **params)`` as NDArrays with ``F``
the ``mx.nd`` namespace, and a parameter whose shape holds 0s
(``in_channels=0``) is shaped by the layer's ``infer_shape`` at the first
forward and drawn then.  Blocks are not ``torch.nn.Module``s: a Block's
values are its Parameters, and ``parallel.functionalize`` is how a step
takes gradients through it.

``hybridize()`` is accepted and changes nothing: every call runs the
eager forward.  Capturing the forward as one program (a CUDA graph) is
not ported yet, nor are ``SymbolBlock``, ``export`` and the parameter
files (``save_parameters`` / ``load_parameters``).
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

from .. import ndarray as nd_module
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class _BlockScope:
    """Name scope manager (reference ``block.py:33``)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """The prefix and ParameterDict of a new Block."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                from ..name import NameManager
                prefix = NameManager.current.get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block:
    """Base class of all layers and models (reference
    ``gluon/block.py:228``)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}

    def __repr__(self):
        body = "\n".join("  (%s): %s" % (k, str(b).replace("\n", "\n  "))
                         for k, b in self._children.items())
        return "%s(\n%s\n)" % (self.__class__.__name__, body)

    def __setattr__(self, name, value):
        """Registers Parameters and child Blocks."""
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and not isinstance(
                    value, type(existing)):
                raise TypeError("Changing attribute type for %s from %s to "
                                "%s is not allowed." % (
                                    name, type(existing), type(value)))
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            assert name not in self._reg_params, \
                "Overriding Parameter attribute %s is not allowed. If you " \
                "want to share parameters between blocks, please set " \
                "'params' at Block construction instead."
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """The scope that names child Blocks and Parameters."""
        return self._scope

    @property
    def params(self):
        """This Block's own ParameterDict (not its children's)."""
        return self._params

    def collect_params(self, select=None):
        """A ParameterDict of this Block's and all its children's
        Parameters, in registration order; ``select`` is a regex on the
        names (reference ``block.py:396``)."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children.values():
            ret.update(cld.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every Parameter (reference ``block.py:577``).
        ``ctx`` defaults to the current context: ``cuda:0`` unless the
        caller asks for the CPU."""
        from .. import initializer
        if init is None:
            init = initializer.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        """Accepted for parity; changes nothing (see the module doc)."""
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, x, *args, **params)``
    (reference ``gluon/block.py:838``)."""

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s. If you are using Sequential, please try "
                "HybridSequential instead." % (str(block), str(type(block))))
        super().register_child(block, name)

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Accepted for parity; changes nothing: the forward stays eager
        (see the module doc)."""
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def infer_shape(self, *args):
        """Complete deferred Parameter shapes from the inputs' shapes; the
        built-in layers override it."""
        raise NotImplementedError(
            "infer_shape is not implemented for block %s with deferred-"
            "initialized parameters. Either give all parameters explicit "
            "shapes (in_units/in_channels/...) or override infer_shape()."
            % type(self).__name__)

    def _deferred_infer_shape(self, *args):
        try:
            self.infer_shape(*args)
        except Exception as e:
            raise ValueError("Deferred initialization failed because shape "
                             "cannot be inferred. {}".format(e)) from e

    def _get_params_nd(self, *args):
        """Registered Parameters as NDArrays, finishing deferred init."""
        try:
            return {name: p.data() for name, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._deferred_infer_shape(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            return {name: p.data() for name, p in self._reg_params.items()}

    def _eager_forward(self, *args):
        params = self._get_params_nd(*args)
        return self.hybrid_forward(nd_module, *args, **params)

    def forward(self, x, *args):
        return self._eager_forward(x, *args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
