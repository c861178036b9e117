"""Convolution and pooling layers (counterpart of
``mxnet_tpu.gluon.nn.conv_layers``): ``Conv2D``, ``MaxPool2D`` and
``GlobalAvgPool2D``.  The 1-D and 3-D layers, the other pooling layers,
transposed convolutions and ``ReflectionPad2D`` are not ported yet (the
``Convolution`` and ``Pooling`` ops take 1-D and 3-D inputs)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


class _Conv(HybridBlock):
    """Base convolution layer (reference ``conv_layers.py:36``): OIHW
    weight ``(channels, in_channels // groups, *kernel)``, a deferred
    ``in_channels`` of 0 taken from the first input."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            n = len(kernel_size)
            if isinstance(strides, int):
                strides = (strides,) * n
            if isinstance(padding, int):
                padding = (padding,) * n
            if isinstance(dilation, int):
                dilation = (dilation,) * n
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            self._groups = groups
            wshape = (channels, in_channels // groups if in_channels else 0) \
                + tuple(kernel_size)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                from .activations import Activation
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x, *args):
        ws = list(self.weight.shape)
        ws[0] = self._channels
        ws[1] = x.shape[1] // self._groups
        self.weight.shape = tuple(ws)

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            act = F.Convolution(x, weight, **self._kwargs)
        else:
            act = F.Convolution(x, weight, bias, **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def _alias(self):
        return "conv"

    def __repr__(self):
        shape = self.weight.shape
        return "%s(%s -> %s, kernel_size=%s, stride=%s)" % (
            self.__class__.__name__, shape[1] if shape[1] else None,
            shape[0], self._kwargs["kernel"], self._kwargs["stride"])


class Conv2D(_Conv):
    """2-D convolution (reference ``conv_layers.py:259``)."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        assert len(kernel_size) == 2, \
            "kernel_size must be a number or a list of 2 ints"
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    """Pooling base (reference ``conv_layers.py:693``)."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout=None,
                 count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        if isinstance(strides, int):
            strides = (strides,) * len(pool_size)
        if isinstance(padding, int):
            padding = (padding,) * len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "%s(size=%s, stride=%s, padding=%s, global_pool=%s, " \
            "pool_type=%s)" % (self.__class__.__name__, self._kwargs["kernel"],
                               self._kwargs["stride"], self._kwargs["pad"],
                               self._kwargs["global_pool"],
                               self._kwargs["pool_type"])


class MaxPool2D(_Pooling):
    """2-D max pooling (reference ``conv_layers.py:800``)."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        assert layout in ("NCHW", "NHWC"), \
            "Only NCHW and NHWC layouts are valid for 2D Pooling"
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 2
        assert len(pool_size) == 2, \
            "pool_size must be a number or a list of 2 ints"
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    """2-D global average pooling, keeping ``[N, C, 1, 1]`` (reference
    ``conv_layers.py:1204``)."""

    def __init__(self, layout="NCHW", **kwargs):
        assert layout in ("NCHW", "NHWC"), \
            "Only NCHW and NHWC layouts are valid for 2D Pooling"
        super().__init__((1, 1), None, 0, True, True, "avg", layout,
                         **kwargs)
