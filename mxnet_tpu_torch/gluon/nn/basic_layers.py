"""Basic layers (counterpart of ``mxnet_tpu.gluon.nn.basic_layers``):
``HybridSequential``, ``Dense``, ``BatchNorm``, ``Flatten``.
``Sequential``, Dropout, Embedding and the other norms are not ported
yet."""
from __future__ import annotations

import math

import torch

from ... import autograd
from ...base import torch_dtype
from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Flatten"]


class HybridSequential(HybridBlock):
    """Stacks HybridBlocks sequentially (reference
    ``basic_layers.py:117``)."""

    def add(self, *blocks):
        """Append blocks to the stack."""
        for block in blocks:
            self.register_child(block)

    def __repr__(self):
        body = "\n".join("  (%s): %s" % (k, str(b).replace("\n", "\n  "))
                         for k, b in self._children.items())
        return "%s(\n%s\n)" % (self.__class__.__name__, body)

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
        out, batch_mean, batch_var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, training=training,
            **self._kwargs)
        if training and not self._kwargs["use_global_stats"]:
            m = self._momentum
            with torch.no_grad():
                rm, rv = running_mean._data, running_var._data
                running_mean._data = (m * rm + (1 - m) * batch_mean._data
                                      ).to(rm.dtype)
                running_var._data = (m * rv + (1 - m) * batch_var._data
                                     ).to(rv.dtype)
        return out


class Flatten(HybridBlock):
    """Flattens the input to 2-D (reference ``basic_layers.py:477``)."""

    def hybrid_forward(self, F, x):
        return F.flatten(x)

    def __repr__(self):
        return self.__class__.__name__
