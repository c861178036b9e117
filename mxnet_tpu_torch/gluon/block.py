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

``hybridize()`` keeps the eager forward: every call runs it.  A
hybridized call is registered with ``mx.perf`` (its cost counted at the
first call per shape signature), as the reference registers its cached
graph.  Capturing the forward as one program (a CUDA graph) is not ported
yet.

Parameter files: ``save_parameters`` writes structural names
(``features.0.weight``, from ``_collect_params_with_prefix``) in the
reference's npz container, and ``load_parameters`` reads those or, for a
file whose keys hold no ``.``, the legacy ``collect_params().save``
names.  ``export`` calls the block on ``mx.sym`` Variables: a Symbol
input sends ``HybridBlock.forward`` to ``hybrid_forward(mx.sym, ...)``
over one Variable a Parameter, named as the Parameter, and the graph and
its ``arg:``/``aux:`` params are written as ``model.save_checkpoint``
writes them.  ``SymbolBlock`` runs such a graph again, each op through
``mx.nd``, so the tape records it like any other forward.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

import warnings

import torch

from .. import autograd
from .. import ndarray as nd_module
from ..ndarray import ndarray as ndarray_mod
from ..ndarray.ndarray import NDArray
from ..symbol.symbol import Symbol
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, forward_context,
                        forward_context_scope)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


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


def _input_context(args):
    """The Context a forward over ``args`` runs in: the first NDArray
    input's when it records one, else the enclosing forward's, else that
    input's device's."""
    x = next((a for a in args if isinstance(a, NDArray)), None)
    if x is not None and getattr(x, "_ctx", None) is not None:
        return x.context
    outer = forward_context()
    if outer is not None or x is None:
        return outer
    return x.context


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
        self._forward_hooks = OrderedDict()
        self._forward_pre_hooks = OrderedDict()

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

    def _collect_params_with_prefix(self, prefix=""):
        """``{structural name: Parameter}``: attribute names joined by
        ``.`` from this Block down (reference ``block.py:210``)."""
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Save the values under structural names (reference
        ``block.py:218``); ``deduplicate`` keeps one name a shared
        Parameter."""
        params = self._collect_params_with_prefix()
        if deduplicate:
            reverse_params = {v: k for k, v in params.items()}
            params = {v: k for k, v in reverse_params.items()}
        ndarray_mod.save(filename, {key: val._reduce()
                                    for key, val in params.items()})

    def save_params(self, filename):
        """Deprecated: ``collect_params().save`` with this Block's prefix
        stripped."""
        warnings.warn("save_params is deprecated. Please use "
                      "save_parameters.")
        try:
            self.collect_params().save(filename, strip_prefix=self.prefix)
        except ValueError as e:
            raise ValueError("%s\nsave_params is deprecated. Using "
                             "save_parameters may resolve this error."
                             % e.args[0])

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load values :meth:`save_parameters` (or, in the legacy format,
        ``save_params``) wrote (reference ``block.py:237``)."""
        loaded = ndarray_mod.load(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any("." in i for i in loaded.keys()):
            # legacy: the file was written by collect_params().save
            del loaded
            self.collect_params().load(
                filename, ctx, allow_missing, ignore_extra, self.prefix,
                cast_dtype=cast_dtype, dtype_source=dtype_source)
            return
        if not allow_missing:
            for name in params.keys():
                assert name in loaded, \
                    "Parameter '%s' is missing in file '%s', which " \
                    "contains parameters: %s. Set allow_missing=True to " \
                    "ignore missing parameters." % (
                        name, filename, _brief_print_list(loaded.keys()))
        for name in loaded:
            if not ignore_extra and name not in params:
                raise ValueError(
                    "Parameter '%s' loaded from file '%s' is not present "
                    "in ParameterDict, which contains parameters %s. Set "
                    "ignore_extra=True to ignore. " % (
                        name, filename, _brief_print_list(params.keys())))
            if name in params:
                params[name]._load_init(loaded[name], ctx,
                                        cast_dtype=cast_dtype,
                                        dtype_source=dtype_source)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """Deprecated: :meth:`load_parameters`."""
        warnings.warn("load_params is deprecated. Please use "
                      "load_parameters.")
        self.load_parameters(filename, ctx, allow_missing, ignore_extra)

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_pre_hook(self, hook):
        """``hook(block, inputs)`` before each forward; returns a handle
        whose ``detach()`` removes it."""
        handle = _HookHandle(self._forward_pre_hooks)
        self._forward_pre_hooks[handle.id] = hook
        return handle

    def register_forward_hook(self, hook):
        """``hook(block, inputs, outputs)`` after each forward."""
        handle = _HookHandle(self._forward_hooks)
        self._forward_hooks[handle.id] = hook
        return handle

    def apply(self, fn):
        """Apply ``fn`` to every child Block, depth first, then to self."""
        for cld in self._children.values():
            cld.apply(fn)
        fn(self)
        return self

    def zero_grad(self):
        for p in self.collect_params().values():
            p.zero_grad()

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
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        with forward_context_scope(_input_context(args)):
            out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Print each Block's output shape and parameter count from one
        forward over ``inputs`` (reference ``block.py:340``)."""
        summary = OrderedDict()
        seen = set()
        hooks = []

        def _get_shape_str(args):
            def flatten(args):
                if not isinstance(args, (list, tuple)):
                    return [args], int(0)
                flat, fmts = [], []
                for i in args:
                    arg, fmt = flatten(i)
                    flat.extend(arg)
                    fmts.append(fmt)
                return flat, fmts

            def regroup(args, fmt):
                if isinstance(fmt, int):
                    if fmt == 0:
                        return args[0], args[1:]
                    return args[:fmt], args[fmt:]
                ret = []
                for i in fmt:
                    res, args = regroup(args, i)
                    ret.append(res)
                return ret, args

            flat_args, fmts = flatten(args)
            flat_arg_shapes = [x.shape if isinstance(x, NDArray) else x
                               for x in flat_args]
            shapes = regroup(flat_arg_shapes, fmts)[0]
            if isinstance(shapes, list):
                shape_str = str(shapes)[1:-1]
            else:
                shape_str = str(shapes)
            return shape_str.replace("L", "")

        def _register_summary_hook(block):
            assert not isinstance(block, HybridBlock) or not block._active, \
                "\"{}\" must not be hybridized to print summary.".format(
                    block.name)

            def _summary_hook(block, _, outputs):
                class_name = block.__class__.__name__
                block_idx = len(summary) - 1
                m_key = "%s-%i" % (class_name, block_idx + 1)
                summary[m_key] = OrderedDict()
                summary[m_key]["output_shape"] = _get_shape_str(outputs)
                params = 0
                summary[m_key]["trainable"] = 0
                summary[m_key]["shared"] = 0
                for p in block.params.values():
                    params += p.data().size
                    summary[m_key]["trainable"] += (
                        0 if p.grad_req == "null" else p.data().size)
                    if p in seen:
                        summary[m_key]["shared"] += p.data().size
                    else:
                        seen.add(p)
                summary[m_key]["n_params"] = params

            hooks.append(block.register_forward_hook(_summary_hook))

        summary["Input"] = OrderedDict()
        summary["Input"]["output_shape"] = _get_shape_str(inputs)
        summary["Input"]["n_params"] = 0
        summary["Input"]["trainable"] = 0
        summary["Input"]["shared"] = 0
        try:
            self.apply(_register_summary_hook)
            self(*inputs)
            line_format = "{:>20}  {:>42} {:>15}"
            print("-" * 80)
            print(line_format.format("Layer (type)", "Output Shape",
                                     "Param #"))
            print("=" * 80)
            total_params = trainable_params = shared_params = 0
            for layer in summary:
                print(line_format.format(
                    layer, str(summary[layer]["output_shape"]),
                    summary[layer]["n_params"]))
                total_params += summary[layer]["n_params"]
                trainable_params += summary[layer]["trainable"]
                shared_params += summary[layer]["shared"]
            print("=" * 80)
            print("Parameters in forward computation graph, duplicate "
                  "included")
            print("   Total params: " + str(total_params))
            print("   Trainable params: " + str(trainable_params))
            print("   Non-trainable params: "
                  + str(total_params - trainable_params))
            print("Shared params in forward computation graph: "
                  + str(shared_params))
            print("Unique parameters in model: "
                  + str(total_params - shared_params))
            print("-" * 80)
        finally:
            for h in hooks:
                h.detach()


class _HookHandle:
    """A registered hook's handle (reference ``block.py:444``)."""

    _id = 0

    def __init__(self, hooks_dict):
        self._hooks_dict = hooks_dict
        _HookHandle._id += 1
        self.id = _HookHandle._id

    def detach(self):
        self._hooks_dict.pop(self.id, None)


def _brief_print_list(lst, limit=7):
    lst = list(lst)
    if len(lst) > limit:
        return _brief_print_list(lst[:limit // 2], limit) + ", ..., " + \
            _brief_print_list(lst[-limit // 2:], limit)
    return ", ".join(["'%s'" % str(i) for i in lst])


# how many hybridized calls enclose the current one on this thread: only
# the outermost is an mx.perf program
_PROGRAM = threading.local()


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, x, *args, **params)``
    (reference ``gluon/block.py:838``).  A hybridized call (the outermost
    on its thread) is an ``mx.perf`` program of the ``gluon`` family,
    counted at its first call per shape signature, feeding the gluon
    source's MFU: the counterpart of the reference's ``_CachedGraph``
    registration."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}
        self._perf_program = None

    def __call__(self, *args):
        if not self._active or getattr(_PROGRAM, "depth", 0) or (
                args and isinstance(args[0], Symbol)):
            return super().__call__(*args)
        prog = self._perf_program
        if prog is None:
            from .. import perf as _perf
            prog = self._perf_program = _perf.wrap(
                self._program_call, "gluon", "%s/%x" % (self.name, id(self)),
                source="gluon")
        return prog(*args)

    def _program_call(self, *args):
        _PROGRAM.depth = getattr(_PROGRAM, "depth", 0) + 1
        try:
            return Block.__call__(self, *args)
        finally:
            _PROGRAM.depth -= 1

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s. If you are using Sequential, please try "
                "HybridSequential instead." % (str(block), str(type(block))))
        super().register_child(block, name)

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Records the flags; the forward stays eager (see the module
        doc)."""
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
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

    def infer_type(self, *args):
        for p in self._reg_params.values():
            if p.dtype is None:
                p._dtype = args[0].dtype

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
        """The eager forward; a Symbol input traces the graph instead
        (``export``): each registered Parameter enters as the Variable of
        its name."""
        if isinstance(x, Symbol):
            from .. import symbol as sym_module
            kwargs = {name: sym_module.var(p.name)
                      for name, p in self._reg_params.items()}
            return self.hybrid_forward(sym_module, x, *args, **kwargs)
        return self._eager_forward(x, *args)

    def export(self, path, epoch=0, remove_amp_cast=True,
               input_names=("data",), fmt="native"):
        """Write ``path-symbol.json`` and ``path-%04d.params`` (trainable
        values as ``arg:``, ``grad_req='null'`` ones as ``aux:``; reference
        ``block.py:715``); returns the two file names.  ``fmt='native'``
        writes the JAX package's formats; ``fmt='mxnet'`` Apache-MXNet's
        own (the NNVM graph JSON and the binary ``.params``,
        ``compat.save_mxnet_symbol`` / ``save_mxnet_params``), which
        ``model.load_checkpoint`` of either package reads."""
        from .. import symbol as sym_module
        from .. import model as _model
        if fmt not in ("native", "mxnet"):
            raise ValueError("export: unknown fmt %r (use 'native' or "
                             "'mxnet')" % (fmt,))
        out = self(*[sym_module.Variable(n) for n in input_names])
        if isinstance(out, (list, tuple)):
            out = sym_module.Group(list(out))
        arg, aux = {}, {}
        for name, p in self.collect_params().items():
            (aux if p.grad_req == "null" else arg)[name] = p.data()
        if fmt == "native":
            _model.save_checkpoint(path, epoch, out, arg, aux)
        else:
            from .. import compat as _compat
            from ..resilience import atomic_write
            # serialized first: an op Apache MXNet lacks raises before
            # either file is touched
            js = _compat.save_mxnet_symbol(out)
            with atomic_write("%s-symbol.json" % path, "w") as f:
                f.write(js)
            _compat.save_mxnet_params("%s-%04d.params" % (path, epoch),
                                      _model.pack_params(arg, aux))
        return ["%s-symbol.json" % path, "%s-%04d.params" % (path, epoch)]

    def optimize_for(self, x, *args, backend=None, **kwargs):
        """Hybridize and run once (reference ``block.py:726``): no
        backend partitions the graph here."""
        self.hybridize(True)
        self(x, *args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """A Block that runs a Symbol graph (reference ``block.py:737``):
    every free Variable that is not an input becomes a Parameter of the
    same name (the moving statistics ``grad_req='null'``).  Each op runs
    through ``mx.nd``, so under ``autograd.record()`` the gradients reach
    the Parameters and the inputs, and a training-mode forward writes the
    BatchNorm statistics back into their Parameters."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock from an ``export``-ed pair."""
        from ..symbol import load as sym_load, var
        sym = sym_load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(sym, [var(i) for i in input_names])
        if param_file is not None:
            ret.collect_params().load(param_file, ctx=ctx, cast_dtype=True,
                                      dtype_source="saved",
                                      allow_missing=True, ignore_extra=True)
        return ret

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=None)
        from ..symbol import Group
        from ..symbol.symbol import _is_aux_name
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = Group(outputs)
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._output_sym = outputs
        self._input_names = [i.name for i in inputs]
        existing = dict(params.items()) if params is not None else {}
        for name in outputs.list_inputs():
            if name in self._input_names:
                continue
            self.params._params[name] = existing.get(name) or Parameter(
                name, shape=None, allow_deferred_init=True,
                grad_req="null" if _is_aux_name(name) else "write")

    def forward(self, x, *args):
        from ..ops import registry
        from ..symbol.symbol import _eval_symbol
        params = self.params._params
        env = {n: p.data() for n, p in params.items()}
        env.update(zip(self._input_names, (x,) + args))
        training = autograd.is_training()
        aux_updates = {}
        outs = _eval_symbol(
            self._output_sym, env, training, aux_updates,
            apply=lambda op, vals, attrs: registry.apply_op(op, *vals,
                                                            **attrs))
        with torch.no_grad():
            for name, v in aux_updates.items():
                if name in params:
                    data = params[name].data()
                    data._data = v.to(data._data.dtype)
        return outs[0] if len(outs) == 1 else outs

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
