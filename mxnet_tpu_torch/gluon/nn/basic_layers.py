"""Basic layers (counterpart of ``mxnet_tpu.gluon.nn.basic_layers``):
the containers, ``Dense``, ``Dropout``, ``Embedding``, the four norms,
``Flatten`` and the two lambdas, each over the registered op of its
name.  ``Embedding(sparse_grad=True)`` declares a row-sparse gradient
(``grad_stype="row_sparse"``): ``SPMDTrainer`` trains such a table on its
deduplicated row-sparse route (``parallel/embedding.py``); on every other
path its gradient is dense (the sparse arrays are not ported)."""
from __future__ import annotations

import math

import torch

from ... import autograd
from ...base import torch_dtype
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "Embedding", "BatchNorm", "InstanceNorm", "LayerNorm",
           "GroupNorm", "Flatten", "Lambda", "HybridLambda"]


def _children_repr(block):
    body = "\n".join("  (%s): %s" % (k, str(b).replace("\n", "\n  "))
                     for k, b in block._children.items())
    return "%s(\n%s\n)" % (block.__class__.__name__, body)


def _norm_repr(block, in_channels):
    return "%s(%s, in_channels=%s)" % (
        block.__class__.__name__,
        ", ".join("=".join([k, v.__repr__()])
                  for k, v in block._kwargs.items()), in_channels)


class Sequential(Block):
    """Stacks Blocks sequentially (reference ``basic_layers.py:36``)."""

    def add(self, *blocks):
        """Append blocks to the stack."""
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __repr__(self):
        return _children_repr(self)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children.values()):
            import warnings
            warnings.warn(
                "All children of this Sequential layer '%s' are "
                "HybridBlocks. Consider using HybridSequential for the best "
                "performance." % self.prefix, stacklevel=2)
        super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock):
    """Stacks HybridBlocks sequentially (reference
    ``basic_layers.py:117``)."""

    def add(self, *blocks):
        """Append blocks to the stack."""
        for block in blocks:
            self.register_child(block)

    def __repr__(self):
        return _children_repr(self)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """``out = act(dot(x, w.T) + b)`` (reference ``basic_layers.py:172``);
    with ``flatten`` the input is flattened to 2-D first."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                from .activations import Activation
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        act = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        shape = self.weight.shape
        return "%s(%s -> %s, %s)" % (
            self.__class__.__name__, shape[1] if shape[1] else None,
            shape[0], self.act if self.act else "linear")


class Dropout(HybridBlock):
    """Dropout in training, the identity otherwise (reference
    ``basic_layers.py:262``); the mask is drawn on the input's device."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes,
                             training=autograd.is_training())
        return F.identity(x)

    def __repr__(self):
        return "%s(p = %s, axes=%s)" % (self.__class__.__name__,
                                        self._rate, self._axes)


class BatchNorm(HybridBlock):
    """Batch normalization with moving statistics (reference
    ``basic_layers.py:311``).

    The op returns ``(out, batch_mean, batch_var)``; in training the
    layer folds the moving average itself, ``m * running + (1 - m) *
    batch`` with the biased batch variance, and writes the result into
    the running-stat NDArrays it was handed (inside
    ``parallel.functionalize`` those are the step's wrappers, not the
    live Parameters).  The update carries no autograd history."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        self._momentum = momentum
        if in_channels != 0:
            self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (channels,)

    def cast(self, dtype):
        if torch_dtype(dtype) == torch.float16:
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        training = autograd.is_training()
        out = F.BatchNorm(x, gamma, beta, running_mean, running_var,
                          training=training, **self._kwargs)
        if not isinstance(out, (tuple, list)):
            # a Symbol (export): the moving statistics are aux states the
            # executor updates
            return out
        out, batch_mean, batch_var = out
        if training and not self._kwargs["use_global_stats"]:
            m = self._momentum
            with torch.no_grad():
                rm, rv = running_mean._data, running_var._data
                running_mean._data = (m * rm + (1 - m) * batch_mean._data
                                      ).to(rm.dtype)
                running_var._data = (m * rv + (1 - m) * batch_var._data
                                     ).to(rv.dtype)
        return out

    def __repr__(self):
        in_channels = self.gamma.shape[0]
        return _norm_repr(self, in_channels if in_channels else None)


class Embedding(HybridBlock):
    """Rows of a ``(input_dim, output_dim)`` weight at integer ids
    (reference ``basic_layers.py:415``); ``sparse_grad=True`` declares the
    weight's gradient row-sparse (module docstring)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": sparse_grad}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)

    def __repr__(self):
        return "{block_name}({input_dim} -> {output_dim}, {dtype})".format(
            block_name=self.__class__.__name__, **self._kwargs)


class Flatten(HybridBlock):
    """Flattens the input to 2-D (reference ``basic_layers.py:477``)."""

    def hybrid_forward(self, F, x):
        return F.flatten(x)

    def __repr__(self):
        return self.__class__.__name__


class _Norm(HybridBlock):
    """A norm over ``gamma`` and ``beta`` of the channel count (deferred
    until the first input gives it)."""

    def __init__(self, kwargs, center, scale, beta_initializer,
                 gamma_initializer, in_channels, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = kwargs
        self._epsilon = kwargs["eps"]
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        self.gamma.shape = (channels,)
        self.beta.shape = (channels,)

    def __repr__(self):
        return _norm_repr(self, self.gamma.shape[0])


class InstanceNorm(_Norm):
    """Instance normalization (reference ``basic_layers.py:505``)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        self._axis = axis
        super().__init__({"eps": epsilon, "axis": axis, "center": center,
                          "scale": scale}, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta,
                              eps=self._epsilon).swapaxes(1, self._axis)


class LayerNorm(_Norm):
    """Layer normalization (reference ``basic_layers.py:600``)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        self._axis = axis
        super().__init__({"eps": epsilon, "axis": axis, "center": center,
                          "scale": scale}, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix=prefix,
                         params=params)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma=gamma, beta=beta, axis=self._axis,
                           eps=self._epsilon)


class GroupNorm(_Norm):
    """Group normalization over axis 1 (reference
    ``basic_layers.py:690``)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        self._axis = 1
        self._num_groups = num_groups
        super().__init__({"eps": epsilon, "num_groups": num_groups,
                          "center": center, "scale": scale}, center, scale,
                         beta_initializer, gamma_initializer, in_channels,
                         prefix=prefix, params=params)

    def hybrid_forward(self, F, data, gamma, beta):
        return F.GroupNorm(data, gamma=gamma, beta=beta,
                           num_groups=self._num_groups, eps=self._epsilon)

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, ", ".join(
            "=".join([k, v.__repr__()]) for k, v in self._kwargs.items()))


def _lambda_function(function):
    """``(callable, name)`` of a Lambda's function: an ``mx.nd`` op name
    or a callable."""
    if isinstance(function, str):
        from ... import ndarray as nd
        assert hasattr(nd, function), \
            "Function name %s is not found in ndarray." % function
        return getattr(nd, function), function
    if callable(function):
        return function, function.__name__
    raise ValueError("Unrecognized function in lambda: {} of type {}"
                     .format(function, type(function)))


class Lambda(Block):
    """An op or expression as a Block (reference
    ``basic_layers.py:774``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_impl, self._func_name = _lambda_function(function)

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._func_name)


class HybridLambda(HybridBlock):
    """An op name or ``f(F, x, *args)`` as a HybridBlock (reference
    ``basic_layers.py:817``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            _lambda_function(function)
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        else:
            _, self._func_name = _lambda_function(function)
            self._func = function

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._func_name)
