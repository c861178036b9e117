"""The registered kernel ops (counterpart of the registered ops of
``mxnet_tpu.ops.pallas_kernels``): ``mx.nd.pallas_softmax``,
``mx.nd.pallas_scale_bias_relu`` and ``mx.nd.pallas_flash_attention``.

Each reaches a hand-written CUDA kernel through its wrapper in
``cuda_kernels`` (CUDA tensors launch it or raise; CPU tensors run its
plain version), so these ops are how the kernels are reached from
``mx.nd`` and the autograd tape:

* ``pallas_softmax`` — softmax over the last axis through
  :class:`_RowSoftmax`: its forward is the K5 forward kernel and saves
  ``(x, m, l)``, its backward the K5 backward kernel;
* ``pallas_scale_bias_relu`` — ``relu(x * scale + bias)`` through K6;
  not differentiable, so the tape never records it;
* ``pallas_flash_attention`` — flash attention through
  ``kernels._FlashVJP`` (K2f forward, K2dq and K2dkv backward).
"""
from __future__ import annotations

import torch

from . import cuda_kernels as _ck
from .registry import register

__all__ = ["pallas_row_softmax", "pallas_scale_bias_relu",
           "pallas_flash_attention"]


class _RowSoftmax(torch.autograd.Function):
    """Row softmax over ``[n, d]`` with its backward (the reference's
    ``_row_softmax`` custom VJP): the forward saves the row max and sum
    in ``x``'s dtype and the backward rebuilds ``y`` from them."""

    @staticmethod
    def forward(ctx, flat):
        y, m, l = _ck.row_softmax(flat)
        ctx.save_for_backward(flat, m, l)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, m, l = ctx.saved_tensors
        return _ck.row_softmax_bwd(x, m, l, dy.contiguous())


@register("pallas_softmax")
def pallas_row_softmax(data, **_):
    """Softmax over the last axis (``mx.nd.pallas_softmax``), any leading
    shape; differentiable."""
    flat = data.reshape(-1, data.shape[-1]).contiguous()
    return _RowSoftmax.apply(flat).reshape(data.shape)


def _as_like(v, x, d):
    """``v`` (a tensor or array-like of ``d`` values) in ``x``'s dtype on
    ``x``'s device, flat and contiguous."""
    t = torch.as_tensor(v, device=x.device)
    return t.reshape(d).to(x.dtype).contiguous()


@register("pallas_scale_bias_relu", differentiable=False)
def pallas_scale_bias_relu(data, scale, bias, **_):
    """``relu(x * scale + bias)`` with ``scale``/``bias`` over the last
    axis (``mx.nd.pallas_scale_bias_relu``), cast to ``x``'s dtype."""
    d = data.shape[-1]
    flat = data.reshape(-1, d).contiguous()
    out = _ck.scale_bias_relu(flat, _as_like(scale, data, d),
                              _as_like(bias, data, d))
    return out.reshape(data.shape)


@register("pallas_flash_attention")
def pallas_flash_attention(q, k, v, causal=False, scale=None, block_q=128,
                           **_):
    """Flash attention over ``[B, H, S, D]`` (``mx.nd.pallas_flash_
    attention``); differentiable.  ``block_q`` is accepted for parity:
    the kernels tile by 64 query rows."""
    from ..kernels import _FlashVJP
    B, H, S, D = q.shape
    if causal and k.shape[2] != S:
        raise ValueError("causal flash attention needs matching q/kv "
                         "lengths, got Sq=%d Skv=%d" % (S, k.shape[2]))
    if v.shape != k.shape:
        raise ValueError("k and v shapes differ: %s vs %s"
                         % (tuple(k.shape), tuple(v.shape)))
    return _FlashVJP.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                           bool(causal), scale)
