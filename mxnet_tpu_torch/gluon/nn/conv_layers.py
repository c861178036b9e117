"""Convolution and pooling layers (counterpart of
``mxnet_tpu.gluon.nn.conv_layers``): 1-, 2- and 3-D convolutions and
transposed convolutions, max and average pooling, the global pools and
``ReflectionPad2D``.  Each calls the registered ``Convolution``,
``Deconvolution``, ``Pooling`` or ``pad`` op, which carry MXNet's
``pooling_convention`` and ``count_include_pad``."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _channels_first(layout):
    """The ``Convolution`` and ``Pooling`` ops take channel-first data
    (``conv.internal_layout`` changes only the memory order); a
    channel-last layout raises instead of running as channel-first."""
    if layout not in ("NCW", "NCHW", "NCDHW"):
        raise NotImplementedError(
            "layout %r: the port's convolution and pooling layers take "
            "channel-first data (NCW, NCHW, NCDHW)" % (layout,))


class _Conv(HybridBlock):
    """Base convolution layer (reference ``conv_layers.py:36``): the
    weight is ``(channels, in_channels // groups, *kernel)`` for a
    convolution and ``(in_channels, channels // groups, *kernel)`` for a
    transposed one (``op_name='Deconvolution'``, ``adj`` its output
    padding); a deferred ``in_channels`` of 0 is taken from the first
    input."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        _channels_first(layout)
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
            if adj is not None:
                self._kwargs["adj"] = adj
            self._op_name = op_name
            self._groups = groups
            if op_name == "Convolution":
                wshape = (channels,
                          in_channels // groups if in_channels else 0)
            else:
                wshape = (in_channels, channels // groups)
            wshape += tuple(kernel_size)
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
        if self._op_name == "Convolution":
            ws[0] = self._channels
            ws[1] = x.shape[1] // self._groups
        else:
            ws[0] = x.shape[1]
            ws[1] = self._channels // self._groups
        self.weight.shape = tuple(ws)

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            act = op(x, weight, **self._kwargs)
        else:
            act = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def _alias(self):
        return "conv"

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride}"
        n = len(self._kwargs["kernel"])
        if self._kwargs["pad"] != (0,) * n:
            s += ", padding={pad}"
        if self._kwargs["dilate"] != (1,) * n:
            s += ", dilation={dilate}"
        if self._kwargs["num_group"] != 1:
            s += ", groups={num_group}"
        if self.bias is None:
            s += ", bias=False"
        if self.act:
            s += ", {}".format(self.act)
        s += ")"
        shape = self.weight.shape
        return s.format(name=self.__class__.__name__,
                        mapping="{0} -> {1}".format(
                            shape[1] if shape[1] else None, shape[0]),
                        **self._kwargs)


class Conv1D(_Conv):
    """1-D convolution (reference ``conv_layers.py:180``)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,)
        assert len(kernel_size) == 1, \
            "kernel_size must be a number or a list of 1 ints"
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


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


class Conv3D(_Conv):
    """3-D convolution (reference ``conv_layers.py:341``)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 3
        assert len(kernel_size) == 3, \
            "kernel_size must be a number or a list of 3 ints"
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _ConvTranspose(_Conv):
    """A transposed convolution of ``n`` spatial axes: the
    ``Deconvolution`` op, ``output_padding`` as its ``adj``."""

    _dims = 0

    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, activation,
                 use_bias, weight_initializer, bias_initializer,
                 in_channels, **kwargs):
        n = self._dims
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * n
        if isinstance(output_padding, int):
            output_padding = (output_padding,) * n
        assert len(kernel_size) == n, \
            "kernel_size must be a number or a list of %d ints" % n
        assert len(output_padding) == n, \
            "output_padding must be a number or a list of %d ints" % n
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         **kwargs)
        self.outpad = output_padding


class Conv1DTranspose(_ConvTranspose):
    """1-D transposed convolution (reference ``conv_layers.py:425``)."""

    _dims = 1

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    """2-D transposed convolution (reference ``conv_layers.py:511``)."""

    _dims = 2

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    """3-D transposed convolution (reference ``conv_layers.py:601``)."""

    _dims = 3

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, **kwargs)


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
        s = "{name}(size={kernel}, stride={stride}, padding={pad}, " \
            "ceil_mode={ceil_mode}, global_pool={global_pool}, " \
            "pool_type={pool_type}, layout=NCHW)"
        return s.format(
            name=self.__class__.__name__,
            ceil_mode=self._kwargs["pooling_convention"] == "full",
            **self._kwargs)


def _pool_size(pool_size, n):
    if isinstance(pool_size, int):
        pool_size = (pool_size,) * n
    assert len(pool_size) == n, \
        "pool_size must be a number or a list of %d ints" % n
    return pool_size


_LAYOUTS = {1: ("NCW", "NWC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _check_layout(layout, n):
    assert layout in _LAYOUTS[n], \
        "Only %s and %s layouts are valid for %dD Pooling" % (
            _LAYOUTS[n] + (n,))
    _channels_first(layout)


class MaxPool1D(_Pooling):
    """1-D max pooling (reference ``conv_layers.py:746``)."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        _check_layout(layout, 1)
        super().__init__(_pool_size(pool_size, 1), strides, padding,
                         ceil_mode, False, "max", layout, **kwargs)


class MaxPool2D(_Pooling):
    """2-D max pooling (reference ``conv_layers.py:800``)."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        _check_layout(layout, 2)
        super().__init__(_pool_size(pool_size, 2), strides, padding,
                         ceil_mode, False, "max", layout, **kwargs)


class MaxPool3D(_Pooling):
    """3-D max pooling (reference ``conv_layers.py:857``)."""

    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", **kwargs):
        _check_layout(layout, 3)
        super().__init__(_pool_size(pool_size, 3), strides, padding,
                         ceil_mode, False, "max", layout, **kwargs)


class AvgPool1D(_Pooling):
    """1-D average pooling (reference ``conv_layers.py:917``)."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        _check_layout(layout, 1)
        super().__init__(_pool_size(pool_size, 1), strides, padding,
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class AvgPool2D(_Pooling):
    """2-D average pooling (reference ``conv_layers.py:975``)."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCHW", count_include_pad=True,
                 **kwargs):
        _check_layout(layout, 2)
        super().__init__(_pool_size(pool_size, 2), strides, padding,
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class AvgPool3D(_Pooling):
    """3-D average pooling (reference ``conv_layers.py:1036``)."""

    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", count_include_pad=True,
                 **kwargs):
        _check_layout(layout, 3)
        super().__init__(_pool_size(pool_size, 3), strides, padding,
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class _GlobalPool(_Pooling):
    """Global pooling of ``n`` spatial axes, keeping them as 1s."""

    _dims, _type = 0, None

    def __init__(self, layout, **kwargs):
        _check_layout(layout, self._dims)
        super().__init__((1,) * self._dims, None, 0, True, True, self._type,
                         layout, **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    """1-D global max pooling (reference ``conv_layers.py:1097``)."""

    _dims, _type = 1, "max"

    def __init__(self, layout="NCW", **kwargs):
        super().__init__(layout, **kwargs)


class GlobalMaxPool2D(_GlobalPool):
    """2-D global max pooling (reference ``conv_layers.py:1125``)."""

    _dims, _type = 2, "max"

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(layout, **kwargs)


class GlobalMaxPool3D(_GlobalPool):
    """3-D global max pooling (reference ``conv_layers.py:1153``)."""

    _dims, _type = 3, "max"

    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(layout, **kwargs)


class GlobalAvgPool1D(_GlobalPool):
    """1-D global average pooling (reference ``conv_layers.py:1181``)."""

    _dims, _type = 1, "avg"

    def __init__(self, layout="NCW", **kwargs):
        super().__init__(layout, **kwargs)


class GlobalAvgPool2D(_GlobalPool):
    """2-D global average pooling, keeping ``[N, C, 1, 1]`` (reference
    ``conv_layers.py:1204``)."""

    _dims, _type = 2, "avg"

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(layout, **kwargs)


class GlobalAvgPool3D(_GlobalPool):
    """3-D global average pooling (reference ``conv_layers.py:1227``)."""

    _dims, _type = 3, "avg"

    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of H and W (reference ``conv_layers.py:1250``);
    ``padding`` is one int or the 8-tuple of the four axes' pairs."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        assert len(padding) == 8
        self._padding = tuple((padding[2 * i], padding[2 * i + 1])
                              for i in range(4))

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
