"""The deformable convolution layer (counterpart of
``mxnet_tpu.gluon.contrib.cnn.conv_layers``; reference
``python/mxnet/gluon/contrib/cnn/conv_layers.py``).

Two convolutions a call: a plain ``Convolution`` predicts each kernel
tap's sampling offset, and the ``_contrib_DeformableConvolution`` op
(``ops/spatial.py``: a bilinear gather of the taps, then one contraction
with the weights) consumes them.  The offset weights start at zero, so
the layer starts as a plain convolution.
"""
from __future__ import annotations

from ...block import HybridBlock


def _pair(v):
    return (v,) * 2 if isinstance(v, int) else tuple(v)


class DeformableConvolution(HybridBlock):
    """2-D deformable convolution v1 with its offset convolution; the
    reference's parameter names (``weight``, ``bias``,
    ``deformable_conv_offset_weight``, ``deformable_conv_offset_bias``)."""

    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, use_bias=True, in_channels=0,
                 activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True,
                 **kwargs):
        super().__init__(**kwargs)
        k = _pair(kernel_size)
        self._kwargs = dict(
            kernel=k, stride=_pair(strides), pad=_pair(padding),
            dilate=_pair(dilation), num_filter=channels, num_group=groups,
            num_deformable_group=num_deformable_group,
            no_bias=not use_bias)
        offset_channels = 2 * k[0] * k[1] * num_deformable_group
        self._offset_channels = offset_channels
        with self.name_scope():
            self.weight = self.params.get(
                "weight",
                shape=(channels, in_channels // groups if in_channels
                       else 0) + k,
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.offset_weight = self.params.get(
                "deformable_conv_offset_weight",
                shape=(offset_channels, in_channels) + k,
                init=offset_weight_initializer, allow_deferred_init=True)
            self.offset_bias = self.params.get(
                "deformable_conv_offset_bias", shape=(offset_channels,),
                init=offset_bias_initializer,
                allow_deferred_init=True) if offset_use_bias else None
        from ...nn.activations import Activation
        self.act = Activation(activation) if activation else None

    def infer_shape(self, x, *args):
        c = x.shape[1]
        k = self._kwargs["kernel"]
        self.weight.shape = (self._kwargs["num_filter"],
                             c // self._kwargs["num_group"]) + k
        self.offset_weight.shape = (self._offset_channels, c) + k

    def hybrid_forward(self, F, x, weight, offset_weight, bias=None,
                       offset_bias=None):
        offset = F.Convolution(
            x, offset_weight, offset_bias,
            kernel=self._kwargs["kernel"], stride=self._kwargs["stride"],
            pad=self._kwargs["pad"], dilate=self._kwargs["dilate"],
            num_filter=self._offset_channels,
            no_bias=offset_bias is None)
        out = F.DeformableConvolution(x, offset, weight, bias,
                                      **self._kwargs)
        return self.act(out) if self.act else out
